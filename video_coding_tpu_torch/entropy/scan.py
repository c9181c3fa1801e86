"""Host-side scan preparation: destuffing and frame pipelining.

``destuff_flat`` is the vectorized numpy form of the reference's C++
destuff pass: one flat destuffed buffer plus the byte length of every
restart segment, with the same semantics (0xFF00 → 0xFF, RSTn ends a
segment, 0xFFFF is a fill byte, any other marker ends the scan).
"""

from __future__ import annotations

import numpy as np

from ..model.header import DecodeError


def destuff_flat(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Raw entropy-coded bytes → (flat destuffed uint8 buffer, per-segment
    byte lengths int64).

    Every 0xFF is classified by the byte after it (0xD9 past the end):
    0x00 keeps the 0xFF and drops the stuffed 0x00; RST0-7 drops both and
    ends the segment; another 0xFF drops this one (fill); anything else
    terminates the scan at this 0xFF. The classes never overlap — the
    byte a stuffing or RSTn pair consumes is never 0xFF — so each 0xFF is
    classified on its own, without a sequential walk."""
    a = np.frombuffer(data, dtype=np.uint8)
    n = a.size
    ff = np.flatnonzero(a == 0xFF)
    nxt = np.full(ff.size, 0xD9, dtype=np.uint8)
    has_next = ff + 1 < n
    nxt[has_next] = a[ff[has_next] + 1]
    is_stuff = nxt == 0x00
    is_rst = (nxt >= 0xD0) & (nxt <= 0xD7)
    is_fill = nxt == 0xFF
    stop = ~(is_stuff | is_rst | is_fill)
    end = int(ff[stop][0]) if stop.any() else n
    live = ff < end
    ff, is_stuff, is_rst, is_fill = (ff[live], is_stuff[live], is_rst[live],
                                     is_fill[live])
    keep = np.ones(end, dtype=bool)
    keep[ff[is_stuff] + 1] = False
    rst = ff[is_rst]
    keep[rst] = False
    keep[rst + 1] = False
    keep[ff[is_fill]] = False
    flat = a[:end][keep]
    # segment boundaries: bytes kept before each RSTn's 0xFF
    kept_before = np.concatenate([[0], np.cumsum(keep, dtype=np.int64)])
    ends = np.concatenate([kept_before[rst], [flat.size]]).astype(np.int64)
    lens = np.diff(np.concatenate([[0], ends]))
    return flat, lens


def _chunked(it, batch: int):
    """Yield lists of up to ``batch`` items (ragged tail kept)."""
    buf = []
    for e in it:
        buf.append(e)
        if len(buf) == batch:
            yield buf
            buf = []
    if buf:
        yield buf


def _destuff_parts(entropy_list: list, n_seg: int):
    """Destuff many frames' entropy bytes on worker threads (numpy
    releases the GIL in its bulk passes) and validate each frame's restart
    segment count. Returns (parts, lens_parts) — per-frame flat buffers
    and per-segment byte lengths."""
    if len(entropy_list) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(
                max_workers=min(8, len(entropy_list))) as ex:
            destuffed = list(ex.map(destuff_flat, entropy_list))
    else:
        destuffed = [destuff_flat(entropy_list[0])]
    parts, lens_parts = [], []
    for flat, lens64 in destuffed:
        if len(lens64) != n_seg:
            raise DecodeError("restart segment count mismatch")
        parts.append(flat)
        lens_parts.append(lens64)
    return parts, lens_parts


def _pipelined_map(fn, items, depth: int):
    """Ordered generator over ``fn(item)`` with up to ``depth`` items in
    flight on worker threads, so the host prep of item i+1 overlaps the
    device work and downloads of item i."""
    import concurrent.futures
    from collections import deque

    it = iter(items)
    sentinel = object()
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, depth)) as pool:
        q = deque()
        for _ in range(max(1, depth)):
            x = next(it, sentinel)
            if x is sentinel:
                break
            q.append(pool.submit(fn, x))
        while q:
            fut = q.popleft()
            x = next(it, sentinel)
            if x is not sentinel:
                q.append(pool.submit(fn, x))
            yield fut.result()
