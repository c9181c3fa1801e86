"""Host-side scan work: destuffing, lane packing, the index scan of
restart-free streams, the host entropy decoder (strict and resync), the
host entropy coder and frame pipelining.

Every entry point has two tiers with the same semantics, chosen by the
caller's ``use_native``:

- ``None`` or ``True`` (the default): the host entropy engine, the C++
  library of ``entropy/native.py`` (``csrc/host_entropy.cpp``), with its
  per-segment decode and encode on ``n_threads`` threads. A failed build
  raises; nothing falls back.
- ``False``: pure Python / numpy. ``destuff_flat`` is a vectorized numpy
  pass (0xFF00 → 0xFF, RSTn ends a segment, 0xFFFF is a fill byte, any
  other marker ends the scan), ``destuff_segments`` the golden model's
  walk, ``index_scan`` a rolling-window symbol walk, ``decode_scan`` /
  ``decode_scan_resync`` the golden model's ``decode_scan_blocks`` (its
  ``SegmentDecodeError`` is re-exported here) and ``encode_scan`` a
  BitWriter coder. The tests hold the engine against this tier.
"""

from __future__ import annotations

import itertools
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np

from ..common.bitstream import BitReader, BitWriter
from ..model.decoder import (SegmentDecodeError, decode_scan_blocks,
                             decode_slot_run,
                             extract_entropy_segments_with_markers,
                             plan_segment_alignment)
from ..model.encoder import magnitude_bits, size_category
from ..model.header import DecodeError
from ..runtime import trace
from . import native
from .tables import DecoderTables, EncoderTables


def native_available() -> bool:
    """Whether the host entropy engine builds and loads here."""
    return native.available()


def _engine(use_native: bool | None):
    """The engine's library for ``use_native`` None or True (raising when
    it does not build), None for False."""
    return None if use_native is False else native.load()


def _default_threads() -> int:
    return min(os.cpu_count() or 1, 16)


def _destuff_native(lib, data: bytes, slack: int):
    """One engine destuff pass → (out buffer, segment end offsets,
    terminating RSTn indices)."""
    arr = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(len(data) + slack, dtype=np.uint8)
    max_segs = len(data) // 2 + 2
    seg_ends = np.zeros(max_segs, dtype=np.int64)
    seg_marks = np.zeros(max_segs, dtype=np.int64)
    n = lib.vct_destuff_segments_m(arr, len(arr), out, seg_ends, seg_marks,
                                   max_segs)
    if n <= 0:
        raise ValueError("destuff failed on entropy stream")
    return out, seg_ends[:n], seg_marks[:n - 1]


def destuff_flat(data: bytes, use_native: bool | None = None,
                 out: tuple[np.ndarray, np.ndarray] | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Raw entropy-coded bytes → (flat destuffed uint8 buffer, per-segment
    byte lengths int64): the zero-copy input of the device decode routes.

    In the numpy tier every 0xFF is classified by the byte after it (0xD9
    past the end): 0x00 keeps the 0xFF and drops the stuffed 0x00; RST0-7
    drops both and ends the segment; another 0xFF drops this one (fill);
    anything else terminates the scan at this 0xFF. The classes never
    overlap — the byte a stuffing or RSTn pair consumes is never 0xFF — so
    each 0xFF is classified on its own, without a sequential walk. While
    the span recorder is on, the call is a ``decode.destuff`` span
    (``bytes_in``, ``segments``).

    With ``out=(flat, ends)`` the engine allocates nothing: the destuffed
    bytes go to the start of ``flat`` (at least ``len(data)`` bytes, since
    destuffing never lengthens a stream), the rest of ``flat`` is zeroed,
    and each segment's end offset in ``flat`` goes to ``ends``. It returns
    views of the two: (the destuffed bytes, the segment ends). A stream
    with more segments than ``ends`` holds raises ValueError."""
    with trace.span("decode.destuff", bytes_in=len(data)):
        if out is None:
            flat, lens = _destuff_flat(data, use_native)
        else:
            flat, lens = _destuff_into(data, *out, use_native)
        trace.attrs(segments=len(lens))
        return flat, lens


def _destuff_into(data: bytes, flat: np.ndarray, ends: np.ndarray,
                  use_native: bool | None):
    """``destuff_flat`` into the caller's ``flat`` and ``ends``."""
    if len(flat) < len(data):
        raise ValueError(f"an out buffer of {len(flat)} bytes for "
                         f"{len(data)} bytes of entropy data")
    lib = _engine(use_native)
    if lib is not None:
        n = lib.vct_destuff_segments(np.frombuffer(data, dtype=np.uint8),
                                     len(data), flat, ends, len(ends))
    else:
        got, lens = _destuff_flat(data, use_native)
        n = len(lens) if len(lens) <= len(ends) else -1
        if n > 0:
            flat[:len(got)] = got
            np.cumsum(lens, out=ends[:n])
    if n <= 0:
        raise ValueError(f"more than {len(ends)} restart segments")
    end = int(ends[n - 1])
    flat[end:] = 0
    return flat[:end], ends[:n]


def _destuff_flat(data: bytes, use_native: bool | None):
    """``destuff_flat``'s two tiers."""
    lib = _engine(use_native)
    if lib is not None:
        out, ends, _marks = _destuff_native(lib, data, 8)
        starts = np.concatenate([[0], ends[:-1]])
        return out[:int(ends[-1])], (ends - starts).astype(np.int64)
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


def destuff_segments(data: bytes,
                     use_native: bool | None = None) -> list[bytes]:
    """0xFF00→0xFF, split at RSTn, stop at any other marker."""
    return destuff_segments_with_markers(data, use_native)[0]


def destuff_segments_with_markers(data: bytes,
                                  use_native: bool | None = None
                                  ) -> tuple[list[bytes], list[int]]:
    """Destuffed segments plus the RSTn modulo-8 index terminating each
    (len = len(segments) - 1), from one pass over the bytes — the indices
    feed restart resynchronization (decode_scan_resync)."""
    lib = _engine(use_native)
    if lib is None:
        return extract_entropy_segments_with_markers(BitReader(data))
    out, ends, marks = _destuff_native(lib, data, 1)
    starts = np.concatenate([[0], ends[:-1]])
    return ([out[a:b].tobytes() for a, b in zip(starts, ends)],
            marks.tolist())


def rst_marker_indices(data: bytes) -> list[int]:
    """The RSTn modulo-8 indices of a raw (stuffed) entropy-coded
    stream, in order."""
    return destuff_segments_with_markers(data)[1]


def pack_lanes_sorted(flat: np.ndarray, lens64: np.ndarray,
                      order: np.ndarray, L: int,
                      use_native: bool | None = None,
                      starts: np.ndarray | None = None) -> np.ndarray:
    """(S, L) zero-padded uint8 lane matrix from the flat destuffed
    buffer, rows permuted by ``order`` (the load-balancing length sort):
    the engine's strided copy or a numpy gather. Segment s lies at
    ``starts[s]`` in ``flat`` (None: the segments end to end from 0).
    ``L`` must be >= lens64.max() + 4: the guard bytes are what a decoder
    reads past a segment's end (a shorter ``L`` than a segment raises)."""
    S = len(lens64)
    if S and L < int(lens64.max()):
        raise ValueError(f"lane length {L} is shorter than a segment "
                         f"({int(lens64.max())} bytes)")
    if starts is None:
        starts = np.zeros(S, np.int64)
        np.cumsum(lens64[:-1], out=starts[1:])
    else:
        starts = np.ascontiguousarray(starts, dtype=np.int64)
    lib = _engine(use_native)
    if lib is not None:
        out = np.zeros((S, L), np.uint8)
        lib.vct_pack_lanes(
            np.ascontiguousarray(flat, dtype=np.uint8).reshape(-1)
            if len(flat) else np.zeros(1, np.uint8), starts,
            np.ascontiguousarray(lens64, dtype=np.int64),
            np.ascontiguousarray(order, dtype=np.int32), S, L, out)
        return out
    cols = np.arange(L, dtype=np.int64)[None, :]
    st = starts[order][:, None]
    ln = lens64[order].astype(np.int64)[:, None]
    if len(flat) == 0:
        return np.zeros((S, L), np.uint8)
    idx = np.clip(st + cols, 0, len(flat) - 1)
    return np.where(cols < ln, flat[idx], 0).astype(np.uint8)


def index_scan(flat: np.ndarray, comp_idx: np.ndarray, stride: int,
               tables: DecoderTables, use_native: bool | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """Index ONE destuffed restart-free entropy segment for parallel
    decode: walk the symbol stream (no coefficient writes) and record, at
    every ``stride``-block boundary, the absolute bit position and the
    running DC predictors. The records turn the stream into
    ceil(n_blocks/stride) independent virtual segments, each decodable
    bit-exactly on its own lane from that start state.

    Returns (bit_offsets (R,) int64, dc_preds (R, 8) int32); raises
    ValueError on a malformed symbol (no matching code, a DC category
    above 15, an AC run past position 63). The engine's walk, or with
    ``use_native=False`` ``_index_scan_py``."""
    if stride < 1:
        raise ValueError(f"index scan stride must be >= 1, got {stride}")
    lib = _engine(use_native)
    if lib is None:
        return _index_scan_py(flat, comp_idx, stride, tables)
    n_blocks = len(comp_idx)
    R = (n_blocks + stride - 1) // stride
    bit_offsets = np.zeros(R, dtype=np.int64)
    dc_preds = np.zeros((R, 8), dtype=np.int32)
    flat = np.ascontiguousarray(flat, dtype=np.uint8)
    rc = lib.vct_index_scan(
        flat if len(flat) else np.zeros(1, np.uint8), len(flat),
        np.ascontiguousarray(comp_idx, dtype=np.int32), n_blocks,
        len(tables.dc_maxbits), *_lut_args(tables), stride, bit_offsets,
        dc_preds.reshape(-1))
    if rc != 0:
        raise ValueError(f"index scan failed at block {-rc - 1}")
    return bit_offsets, dc_preds


def _lut_args(tables: DecoderTables) -> tuple:
    return (tables.dc_maxbits, tables.dc_lut, tables.dc_off,
            tables.ac_maxbits, tables.ac_lut, tables.ac_off)


def _index_scan_py(flat: np.ndarray, comp_idx: np.ndarray, stride: int,
                   tables: DecoderTables) -> tuple[np.ndarray, np.ndarray]:
    """``index_scan`` in pure Python over a rolling 64-bit window:
    roughly a microsecond a symbol, seconds for a 1080p frame."""
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


def _joined(segments: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Segments as one buffer (never empty) and their byte offsets."""
    data = np.frombuffer(b"".join(segments) or b"\0", dtype=np.uint8)
    offsets = np.zeros(len(segments) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([len(s) for s in segments])
    return data, offsets


def _native_decode(lib, data, offsets, comp_idx, n_blocks,
                   blocks_per_segment, tables, coefs, n_threads,
                   seg_status=None) -> int:
    """One engine call over the segments data[offsets[s]:offsets[s+1]]:
    the strict decode (0 or the failing block's -(block + 1)), or with
    ``seg_status`` the resync decode (the damaged count). Raises at the
    engine's component cap."""
    nt = n_threads if n_threads is not None else _default_threads()
    args = (data, offsets, len(offsets) - 1,
            np.ascontiguousarray(comp_idx, dtype=np.int32), n_blocks,
            blocks_per_segment, len(tables.dc_maxbits), *_lut_args(tables),
            coefs.reshape(-1))
    rc = (lib.vct_decode_blocks(*args, nt) if seg_status is None
          else lib.vct_decode_blocks_resync(*args, seg_status, nt))
    if rc == -1000000000:
        raise ValueError("the host entropy engine supports at most 8 scan "
                         "components")
    return rc


def _check_segment_count(n: int, n_blocks: int, B: int) -> None:
    expected = (n_blocks + B - 1) // B
    if n != expected:
        raise ValueError(
            f"expected {expected} restart segments for {n_blocks} blocks "
            f"(interval {B}), got {n}")


def decode_scan(segments: list[bytes], comp_idx: np.ndarray,
                blocks_per_segment: int, tables: DecoderTables,
                use_native: bool | None = None,
                n_threads: int | None = None) -> np.ndarray:
    """Huffman-decode a whole scan on the host: the engine's segments on
    ``n_threads`` threads, or with ``use_native=False`` the golden model's
    ``decode_scan_blocks``, segment after segment. Returns (n_blocks, 64)
    int32 zigzag coefficients with DC predictors resolved per segment. A
    wrong segment count raises ValueError; malformed data raises
    SegmentDecodeError naming the failing block."""
    n_blocks = len(comp_idx)
    _check_segment_count(len(segments), n_blocks, blocks_per_segment)
    lib = _engine(use_native)
    if lib is None:
        coefs, _ = decode_scan_blocks(segments, [],
                                      *_blocks_args(comp_idx, tables),
                                      blocks_per_segment)
        return coefs
    coefs = np.zeros((n_blocks, 64), dtype=np.int32)
    rc = _native_decode(lib, *_joined(segments), comp_idx, n_blocks,
                        blocks_per_segment, tables, coefs, n_threads)
    if rc != 0:
        raise SegmentDecodeError(-rc - 1)
    return coefs


def destuff_and_decode_scan(data: bytes, comp_idx: np.ndarray,
                            blocks_per_segment: int, tables: DecoderTables,
                            n_threads: int | None = None) -> np.ndarray:
    """The engine's destuff and Huffman decode of a raw (stuffed) entropy
    stream in one pass: the destuffed bytes stay in one buffer and feed
    the decode directly, with no per-segment bytes objects. The same
    result and errors as ``decode_scan(destuff_segments(data), ...)``."""
    lib = native.load()
    n_blocks = len(comp_idx)
    out, ends, _marks = _destuff_native(lib, data, 1)
    _check_segment_count(len(ends), n_blocks, blocks_per_segment)
    coefs = np.zeros((n_blocks, 64), dtype=np.int32)
    rc = _native_decode(lib, out, np.concatenate([[0], ends]), comp_idx,
                        n_blocks, blocks_per_segment, tables, coefs,
                        n_threads)
    if rc != 0:
        raise SegmentDecodeError(-rc - 1)
    return coefs


def decode_scan_resync(segments: list[bytes], comp_idx: np.ndarray,
                       blocks_per_segment: int, tables: DecoderTables,
                       use_native: bool | None = None,
                       n_threads: int | None = None,
                       marker_indices: list[int] | None = None
                       ) -> tuple[np.ndarray, list[int]]:
    """Error-concealing scan decode using restart-marker
    resynchronization.

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

    The engine decodes each stretch of single-slot segments in one call;
    a merged run (marker loss, rare) takes the golden model's
    ``decode_slot_run``. With ``use_native=False`` the whole scan is the
    golden model's ``decode_scan_blocks``.

    Returns ``(coefs, damaged)`` — the (n_blocks, 64) int32 coefficients
    and the sorted list of damaged segment indices."""
    if marker_indices is None or len(marker_indices) != len(segments) - 1:
        marker_indices = []
    lib = _engine(use_native)
    keys, luts = _blocks_args(comp_idx, tables)
    if lib is None:
        return decode_scan_blocks(segments, marker_indices, keys, luts,
                                  blocks_per_segment, resync=True)
    B = blocks_per_segment
    n_blocks = len(comp_idx)
    items, uncovered = plan_segment_alignment(
        marker_indices, len(segments), (n_blocks + B - 1) // B)
    damaged = set(uncovered)
    coefs = np.zeros((n_blocks, 64), dtype=np.int32)
    groups: list[tuple[int, list[int]]] = []   # (first slot, segments)
    for slot0, n_slots, j in items:
        if n_slots > 1:
            damaged.update(decode_slot_run(segments[j], slot0, n_slots,
                                           coefs, keys, luts, B))
        elif groups and groups[-1][0] + len(groups[-1][1]) == slot0:
            groups[-1][1].append(j)
        else:
            groups.append((slot0, [j]))
    for slot0, js in groups:
        first = slot0 * B
        count = min(len(js) * B, n_blocks - first)
        if count <= 0:
            continue
        seg_status = np.zeros(len(js), dtype=np.int64)
        _native_decode(lib, *_joined([segments[j] for j in js]),
                       comp_idx[first:], count, B, tables, coefs[first:],
                       n_threads, seg_status=seg_status)
        damaged.update(slot0 + int(t) for t in np.flatnonzero(seg_status))
    return coefs, sorted(damaged)


_RANGE_ERROR = "quantized coefficients exceed the 12-bit baseline-JPEG range"


def _native_encode(lib, qcoefs: np.ndarray, comp_idx: np.ndarray,
                   blocks_per_segment: int, tables: EncoderTables,
                   n_threads: int | None):
    """The engine's per-segment encode → (out, seg_stride, seg_lens):
    segment s's stuffed bytes are out[s·seg_stride:][:seg_lens[s]].
    int16 coefficients (the dense device download) are read as they
    are; anything else is widened to int32."""
    if qcoefs.dtype == np.int16 and qcoefs.flags.c_contiguous:
        q, fn = qcoefs, lib.vct_encode_blocks_i16
    else:
        q = np.ascontiguousarray(qcoefs, dtype=np.int32)
        fn = lib.vct_encode_blocks
    n_blocks = len(comp_idx)
    if q.size < 64 * n_blocks:
        raise ValueError(f"{q.size // 64} coefficient blocks for "
                         f"{n_blocks} scheduled blocks")
    B = blocks_per_segment
    n_segments = (n_blocks + B - 1) // B
    comp_idx = np.ascontiguousarray(comp_idx, dtype=np.int32)
    nt = n_threads if n_threads is not None else _default_threads()
    # typical streams fit the lean buffer; escalate to the absolute worst
    # case (<= 209 raw bytes a block, <= 2x after stuffing) on demand
    for per_block in (260, 64 * 8):
        seg_stride = B * per_block + 256
        out = np.empty(n_segments * seg_stride, dtype=np.uint8)
        seg_lens = np.zeros(n_segments, dtype=np.int64)
        rc = fn(q.reshape(-1), comp_idx, n_blocks, B, n_segments,
                len(tables.dc_bits) // 12, tables.dc_bits, tables.dc_len,
                tables.ac_bits, tables.ac_len, out, seg_stride, seg_lens, nt)
        if rc == 0:
            return out, seg_stride, seg_lens
    # worst-case buffers cannot overflow: what is left is one of the
    # engine's distinct causes (VCT_ECOMP, VCT_ERANGE, the component cap)
    if rc == -2:
        raise ValueError("comp_idx entry outside the packed table range "
                         "[0, n_components)")
    if rc == -1000000000:
        raise ValueError("the host entropy engine supports at most 8 scan "
                         "components")
    if rc == -3:
        raise ValueError(_RANGE_ERROR)
    raise ValueError(f"entropy encode failed (engine error {rc})")


def encode_scan(qcoefs: np.ndarray, comp_idx: np.ndarray,
                blocks_per_segment: int, tables: EncoderTables,
                use_native: bool | None = None,
                n_threads: int | None = None) -> list[bytes]:
    """Entropy-encode a whole scan on the host: the engine's segments on
    ``n_threads`` threads, or with ``use_native=False`` a BitWriter coder
    in pure Python (about a second for a 1080p frame). Returns one
    stuffed, 1-bit-padded byte buffer per restart segment (the caller
    joins them with RSTn markers)."""
    n_blocks = len(comp_idx)
    qcoefs = np.ascontiguousarray(qcoefs, dtype=np.int32)
    if np.abs(qcoefs).max(initial=0) > 2047:
        # the Huffman magnitude range is 11 bits (DC diff <= cat 11, AC <=
        # cat 10); larger values would index past the code tables
        raise ValueError(_RANGE_ERROR)
    lib = _engine(use_native)
    if lib is not None:
        out, stride, lens = _native_encode(lib, qcoefs, comp_idx,
                                           blocks_per_segment, tables,
                                           n_threads)
        return [out[s * stride:s * stride + n].tobytes()
                for s, n in enumerate(lens.tolist())]
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
                       blocks_per_segment: int, tables: EncoderTables,
                       use_native: bool | None = None,
                       n_threads: int | None = None) -> bytes:
    """Entropy-encode a whole scan straight to its on-the-wire entropy
    body, stuffed segments joined with RSTn markers. The engine stays in
    its own buffers end to end (encode, then ``vct_assemble_stream``) and
    reads int16 coefficients without widening them, enforcing the 12-bit
    range inside its encode loop; ``use_native=False`` is
    ``encode_scan`` and ``join_segments``."""
    lib = _engine(use_native)
    if lib is None:
        return join_segments(encode_scan(qcoefs, comp_idx,
                                         blocks_per_segment, tables,
                                         use_native=False))
    out, stride, lens = _native_encode(lib, np.asarray(qcoefs), comp_idx,
                                       blocks_per_segment, tables, n_threads)
    n_segments = len(lens)
    dst = np.empty(max(int(lens.sum()) + 2 * (n_segments - 1), 1),
                   dtype=np.uint8)
    n = lib.vct_assemble_stream(out, stride, lens, n_segments, dst)
    return dst[:n].tobytes()


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


def flat_size(n: int) -> int:
    """Bytes of a dispatch's flat buffer that holds ``n`` bytes of lanes:
    >= 8 zero guard bytes after them, to a multiple of 16 (K7 copies whole
    16-byte rows)."""
    return -(-(n + 8) // 16) * 16


_pool: ThreadPoolExecutor | None = None
_pool_pid = 0
_pool_lock = threading.Lock()


def pool_map(fn, items: list) -> list:
    """``fn`` over ``items`` on the host engine's standing pool (in the
    calling thread for one item), the caller's open span carried to the
    pool's threads. The pool, min(8, cores) threads made at first use
    (anew in a forked child), is shared by every dispatch in flight, so
    two never run more engine threads than that. The engine's ctypes
    calls drop the interpreter lock, so the items run in parallel. An
    item must not call ``pool_map`` itself: it would wait for threads of
    the pool that it holds."""
    global _pool, _pool_pid
    if len(items) == 1:
        return [fn(items[0])]
    with _pool_lock:
        if _pool is None or _pool_pid != os.getpid():
            _pool = ThreadPoolExecutor(max_workers=min(8, os.cpu_count()
                                                       or 1))
            _pool_pid = os.getpid()
        pool = _pool
    return list(pool.map(trace.carry(fn), items))


class Destuffed(NamedTuple):
    """A dispatch's destuffed frames in one flat uint8 buffer
    (``destuff_dispatch``): frame i from ``bases[i]``, its segment s at
    ``starts[i, s]`` for ``lens[i, s]`` bytes ((F, n_seg) int64). The
    bytes between frames and the >= 8 after the last are zero; ``flat``
    is a multiple of 16 bytes long."""
    flat: np.ndarray
    bases: np.ndarray
    starts: np.ndarray
    lens: np.ndarray


class _Room(threading.local):
    """A thread's dispatch buffers: the flat bytes and the int64 segment
    arrays. They grow when a dispatch needs more room and are otherwise
    reused."""
    flat = np.empty(0, np.uint8)
    segs = np.empty(0, np.int64)


_room = _Room()


def _grow(name: str, need: int) -> bool:
    """Give the thread's ``name`` buffer room for ``need`` items (a
    quarter more than it had, at least); whether it had to grow."""
    have = len(getattr(_room, name))
    if have >= need:
        return False
    setattr(_room, name, np.empty(max(need, have + have // 4),
                                  getattr(_room, name).dtype))
    return True


def _destuff_slot(job) -> int:
    """One frame of ``destuff_dispatch`` into its slot: its segment count,
    or -1 past the slot's room. ``destuff_flat`` is looked up at call
    time, so a wrapper around it sees every frame."""
    data, flat, ends = job
    try:
        return len(destuff_flat(data, out=(flat, ends))[1])
    except ValueError:
        return -1


def destuff_dispatch(entropy_list: list, n_seg: int) -> Destuffed:
    """Destuff a dispatch's frames into one flat buffer that the calling
    thread reuses, and check each frame's restart segment count against
    ``n_seg`` (DecodeError). Frame i's slot starts at the sum of the
    input lengths before it; destuffing never lengthens a stream, so the
    frames destuff in parallel on the standing pool (``pool_map``), each
    by ``destuff_flat(out=...)`` straight into its slot, with nothing
    allocated a frame and, once the buffers are large enough, nothing a
    dispatch.

    The result is views of the thread's buffers, overwritten by its next
    dispatch: upload or consume it before then, and keep nothing that
    aliases it. The call is a ``decode.destuff_pool`` span (``frames``;
    ``buffer_bytes``, the buffer's capacity; ``grown``, 1 when this
    dispatch had to grow a buffer), the parent of each frame's
    ``decode.destuff`` on its thread."""
    F = len(entropy_list)
    offs = [0, *itertools.accumulate(map(len, entropy_list))]
    with trace.span("decode.destuff_pool", frames=F):
        grown = _grow("flat", flat_size(offs[-1]))
        grown |= _grow("segs", F * (3 * n_seg + 1))
        flat, segs = _room.flat, _room.segs
        trace.attrs(buffer_bytes=len(flat), grown=int(grown))
        a, b = F * (n_seg + 1), F * (2 * n_seg + 1)
        ends = segs[:a].reshape(F, n_seg + 1)
        lens = segs[a:b].reshape(F, n_seg)
        starts = segs[b:b + F * n_seg].reshape(F, n_seg)
        ends[:, 0] = 0
        counts = pool_map(_destuff_slot, [
            (data, flat[o:o + len(data)], ends[i, 1:])
            for i, (data, o) in enumerate(zip(entropy_list, offs))])
    if any(n != n_seg for n in counts):
        raise DecodeError("restart segment count mismatch")
    end = offs[-2] + int(ends[-1, -1])
    flat[end:flat_size(end)] = 0
    np.subtract(ends[:, 1:], ends[:, :-1], out=lens)
    np.add(ends[:, :-1], np.asarray(offs[:-1])[:, None], out=starts)
    return Destuffed(flat[:flat_size(end)], starts[:, 0], starts, lens)


def _pipelined_map(fn, items, depth: int):
    """Ordered generator over ``fn(item)`` with up to ``depth`` items in
    flight on worker threads, so the host prep of item i+1 overlaps the
    device work and downloads of item i. Each item's wait for a worker,
    from its submission to its start, is a ``pipeline.queue`` span
    (``dispatch``: its place in ``items``) that opens a dispatch: the
    spans ``fn`` opens on the worker are its children. The workers are a
    pool of this iterator's own, not the standing one: each runs a whole
    dispatch that calls ``pool_map`` itself, and items of the standing
    pool must not (see ``pool_map``)."""
    from collections import deque

    it = enumerate(items)
    sentinel = object()
    with ThreadPoolExecutor(max_workers=max(1, depth)) as pool:

        def submit(x):
            i, item = x
            return pool.submit(
                trace.queued("pipeline.queue", fn, dispatch=i), item)

        q = deque()
        for _ in range(max(1, depth)):
            x = next(it, sentinel)
            if x is sentinel:
                break
            q.append(submit(x))
        while q:
            fut = q.popleft()
            x = next(it, sentinel)
            if x is not sentinel:
                q.append(submit(x))
            yield fut.result()
