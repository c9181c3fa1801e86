"""Host-side scan work: destuffing, lane packing, the index scan of
restart-free streams, the host entropy decoder (strict and resync), the
host entropy coder and frame pipelining.

``destuff_flat`` is the vectorized numpy form of the reference's C++
destuff pass: one flat destuffed buffer plus the byte length of every
restart segment, with the same semantics (0xFF00 → 0xFF, RSTn ends a
segment, 0xFFFF is a fill byte, any other marker ends the scan).
``destuff_segments`` gives the same bytes as one ``bytes`` object a
segment, through the golden model's walk. ``index_scan`` is the
reference's symbol walk in pure Python (its C++ form is not used here).
``decode_scan`` / ``decode_scan_resync`` are the host decoder, the golden
model's ``decode_scan_blocks`` on the session's tables (its
``SegmentDecodeError`` is re-exported here), and ``encode_scan`` the host
coder, both in pure Python: the port has no C++ engine.
"""

from __future__ import annotations

import numpy as np

from ..common.bitstream import BitReader, BitWriter
from ..model.decoder import (SegmentDecodeError, decode_scan_blocks,
                             extract_entropy_segments_with_markers)
from ..model.encoder import magnitude_bits, size_category
from ..model.header import DecodeError
from .tables import DecoderTables, EncoderTables


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


def destuff_segments(data: bytes) -> list[bytes]:
    """0xFF00→0xFF, split at RSTn, stop at any other marker."""
    return destuff_segments_with_markers(data)[0]


def destuff_segments_with_markers(data: bytes
                                  ) -> tuple[list[bytes], list[int]]:
    """Destuffed segments plus the RSTn modulo-8 index terminating each
    (len = len(segments) - 1), from one pass over the bytes — the indices
    feed restart resynchronization (decode_scan_resync)."""
    return extract_entropy_segments_with_markers(BitReader(data))


def rst_marker_indices(data: bytes) -> list[int]:
    """The RSTn modulo-8 indices of a raw (stuffed) entropy-coded
    stream, in order."""
    return destuff_segments_with_markers(data)[1]


def pack_lanes_sorted(flat: np.ndarray, lens64: np.ndarray,
                      order: np.ndarray, L: int) -> np.ndarray:
    """(S, L) zero-padded uint8 lane matrix from the flat destuffed
    buffer, rows permuted by ``order`` (the load-balancing length sort).
    ``L`` must be >= lens64.max() + 4: the guard bytes are what a decoder
    reads past a segment's end."""
    S = len(lens64)
    starts = np.zeros(S, np.int64)
    np.cumsum(lens64[:-1], out=starts[1:])
    cols = np.arange(L, dtype=np.int64)[None, :]
    st = starts[order][:, None]
    ln = lens64[order].astype(np.int64)[:, None]
    if len(flat) == 0:
        return np.zeros((S, L), np.uint8)
    idx = np.clip(st + cols, 0, len(flat) - 1)
    return np.where(cols < ln, flat[idx], 0).astype(np.uint8)


def index_scan(flat: np.ndarray, comp_idx: np.ndarray, stride: int,
               tables: DecoderTables) -> tuple[np.ndarray, np.ndarray]:
    """Index ONE destuffed restart-free entropy segment for parallel
    decode: walk the symbol stream (no coefficient writes) and record, at
    every ``stride``-block boundary, the absolute bit position and the
    running DC predictors. The records turn the stream into
    ceil(n_blocks/stride) independent virtual segments, each decodable
    bit-exactly on its own lane from that start state.

    Returns (bit_offsets (R,) int64, dc_preds (R, 8) int32); raises
    ValueError on a malformed symbol (no matching code, a DC category
    above 15, an AC run past position 63). Pure Python over a rolling
    64-bit window — roughly a microsecond a symbol, seconds for a 1080p
    frame; the sessions run the frames of a batch on a thread pool."""
    data = flat.tobytes()
    dlen = len(data)
    n_blocks = len(comp_idx)
    comps = np.asarray(comp_idx).tolist()
    R = (n_blocks + stride - 1) // stride
    bit_offsets = np.zeros(R, dtype=np.int64)
    dc_preds = np.zeros((R, 8), dtype=np.int32)
    C = len(tables.dc_luts)
    # per component: (max_bits, code lengths, data) as Python lists
    dc_luts = [(int(t.max_bits), t.lengths.tolist(), t.data.tolist())
               for t in tables.dc_luts]
    ac_luts = [(int(t.max_bits), t.lengths.tolist(), t.data.tolist())
               for t in tables.ac_luts]

    window = 0      # the low ``wbits`` bits are the unread stream bits
    wbits = 0
    bytepos = 0

    dc_pred = [0] * 8
    rec = 0
    for blk in range(n_blocks):
        if blk % stride == 0:
            bit_offsets[rec] = bytepos * 8 - wbits
            dc_preds[rec, :] = dc_pred
            rec += 1
        c = comps[blk]
        if c < 0 or c >= C:
            raise ValueError(f"index scan failed at block {blk}")
        mb, lengths, lut_data = dc_luts[c]
        amb, alengths, adata = ac_luts[c]
        # symbol 0 is the DC code, the rest AC codes, until EOB or
        # position 63
        cof = 0
        while cof < 64:
            if wbits < 32:   # one refill covers a 16-bit code + 16 bits
                window = ((window << 32) | int.from_bytes(
                    data[bytepos:bytepos + 4].ljust(4, b"\0"), "big")) \
                    & 0xFFFFFFFFFFFFFFFF
                bytepos += 4
                wbits += 32
            if cof == 0:
                idx = (window >> (wbits - mb)) & ((1 << mb) - 1) if mb else 0
                ln = lengths[idx]
                if ln == 0:
                    raise ValueError(f"index scan failed at block {blk}")
                wbits -= ln
                cat = lut_data[idx]
                if cat > 15:
                    raise ValueError(f"index scan failed at block {blk}")
                if cat:
                    bits = (window >> (wbits - cat)) & ((1 << cat) - 1)
                    wbits -= cat
                    dc_pred[c] += bits if bits >= (1 << (cat - 1)) \
                        else bits - (1 << cat) + 1
                cof = 1
                continue
            idx = (window >> (wbits - amb)) & ((1 << amb) - 1)
            ln = alengths[idx]
            if ln == 0:
                raise ValueError(f"index scan failed at block {blk}")
            e = adata[idx]
            size = e & 0xF
            wbits -= ln + size
            if size == 0 and e >> 4 == 0:
                break  # EOB
            cof += (e >> 4) + 1
            if cof > 64:
                raise ValueError(f"index scan failed at block {blk}")
    return bit_offsets, dc_preds


def _blocks_args(comp_idx: np.ndarray, tables: DecoderTables):
    """The golden decoder's per-block keys and (DC, AC) table pairs."""
    return (np.asarray(comp_idx).tolist(),
            list(zip(tables.dc_luts, tables.ac_luts)))


def decode_scan(segments: list[bytes], comp_idx: np.ndarray,
                blocks_per_segment: int,
                tables: DecoderTables) -> np.ndarray:
    """Huffman-decode a whole scan on the host, segment after segment, in
    pure Python (``model.decoder.decode_scan_blocks``). Returns
    (n_blocks, 64) int32 zigzag coefficients with DC predictors resolved
    per segment. A wrong segment count raises ValueError; malformed data
    raises SegmentDecodeError naming the failing block."""
    n_blocks = len(comp_idx)
    expected = (n_blocks + blocks_per_segment - 1) // blocks_per_segment
    if len(segments) != expected:
        raise ValueError(
            f"expected {expected} restart segments for {n_blocks} blocks "
            f"(interval {blocks_per_segment}), got {len(segments)}")
    coefs, _ = decode_scan_blocks(segments, [],
                                  *_blocks_args(comp_idx, tables),
                                  blocks_per_segment)
    return coefs


def decode_scan_resync(segments: list[bytes], comp_idx: np.ndarray,
                       blocks_per_segment: int, tables: DecoderTables,
                       marker_indices: list[int] | None = None
                       ) -> tuple[np.ndarray, list[int]]:
    """Error-concealing scan decode using restart-marker
    resynchronization, on the host in pure Python
    (``model.decoder.decode_scan_blocks``).

    A decode error inside a segment conceals it from the failing block
    onward (all-zero coefficients → mid-gray after reconstruction); the
    valid prefix is kept and decode resumes cleanly at the next RSTn
    because segments are independent. With ``marker_indices`` (the RSTn
    modulo-8 terminator indices, from ``rst_marker_indices``), segments
    are re-aligned by index first, so marker damage is survivable too: a
    destroyed RSTn merges two received segments, which are detected by the
    index jump and decoded back-to-back. Without them (or with a count
    that does not match the segments) segment j is slot j. Truncated
    streams conceal the missing segments; extras are ignored.

    Returns ``(coefs, damaged)`` — the (n_blocks, 64) int32 coefficients
    and the sorted list of damaged segment indices."""
    if marker_indices is None or len(marker_indices) != len(segments) - 1:
        marker_indices = []
    return decode_scan_blocks(segments, marker_indices,
                              *_blocks_args(comp_idx, tables),
                              blocks_per_segment, resync=True)


def encode_scan(qcoefs: np.ndarray, comp_idx: np.ndarray,
                blocks_per_segment: int,
                tables: EncoderTables) -> list[bytes]:
    """Entropy-encode a whole scan on the host. Returns one stuffed,
    1-bit-padded byte buffer per restart segment (the caller joins them
    with RSTn markers). Pure Python over a BitWriter: about a second for
    a 1080p frame."""
    n_blocks = len(comp_idx)
    qcoefs = np.ascontiguousarray(qcoefs, dtype=np.int32)
    if np.abs(qcoefs).max(initial=0) > 2047:
        # the Huffman magnitude range is 11 bits (DC diff <= cat 11, AC <=
        # cat 10); larger values would index past the code tables
        raise ValueError("quantized coefficients exceed the 12-bit "
                         "baseline-JPEG range")
    comps = np.ascontiguousarray(comp_idx, dtype=np.int32).tolist()
    n_segments = (n_blocks + blocks_per_segment - 1) // blocks_per_segment
    ncomp = len(tables.dc_bits) // 12
    dc_bits, dc_len = tables.dc_bits.tolist(), tables.dc_len.tolist()
    ac_bits, ac_len = tables.ac_bits.tolist(), tables.ac_len.tolist()
    result = []
    for s in range(n_segments):
        first = s * blocks_per_segment
        count = min(blocks_per_segment, n_blocks - first)
        w = BitWriter()
        put = w.put_bits
        dc_pred = [0] * ncomp
        for b in range(first, first + count):
            c = comps[b]
            q = qcoefs[b]
            dc = int(q[0])
            diff = dc - dc_pred[c]
            dc_pred[c] = dc
            size = size_category(diff)
            put(dc_bits[c * 12 + size], dc_len[c * 12 + size], stuffing=True)
            put(magnitude_bits(size, diff), size, stuffing=True)
            eob = c * 176
            nz = np.flatnonzero(q[1:])
            if len(nz) == 0:
                put(ac_bits[eob], ac_len[eob], stuffing=True)
                continue
            run = 0
            prev = 0
            for pos in (nz + 1).tolist():
                run = pos - prev - 1
                prev = pos
                while run >= 16:
                    put(ac_bits[eob + 15 * 11], ac_len[eob + 15 * 11],
                        stuffing=True)
                    run -= 16
                v = int(q[pos])
                sz = size_category(v)
                idx = eob + run * 11 + sz
                put(ac_bits[idx], ac_len[idx], stuffing=True)
                put(magnitude_bits(sz, v), sz, stuffing=True)
            if prev < 63:
                put(ac_bits[eob], ac_len[eob], stuffing=True)
        w.flush_with_1s(stuffing=True)
        result.append(w.get_buffer())
    return result


def join_segments(segments: list[bytes]) -> bytes:
    """Stuffed segments joined with RSTn markers: the entropy body as it
    goes on the wire."""
    out = bytearray()
    for i, seg in enumerate(segments):
        if i > 0:
            out += bytes((0xFF, 0xD0 + ((i - 1) & 7)))
        out += seg
    return bytes(out)


def encode_scan_stream(qcoefs: np.ndarray, comp_idx: np.ndarray,
                       blocks_per_segment: int,
                       tables: EncoderTables) -> bytes:
    """Entropy-encode a whole scan straight to its on-the-wire entropy
    body: ``encode_scan`` and the RSTn join."""
    return join_segments(encode_scan(qcoefs, comp_idx, blocks_per_segment,
                                     tables))


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
