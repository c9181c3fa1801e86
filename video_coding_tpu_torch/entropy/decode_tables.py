"""Huffman decode tables for the decode kernels, and the rules that route
a stream to one of them.

Canonical Huffman codes of one length occupy one contiguous range of the
16-bit peek window, and the ranges of different lengths are disjoint, so
a window matches exactly one length (or none): the range tables. Row t is
component c's DC table (t = c) or its AC table (t = C + c). The expanded
tables of ``expand_luts`` answer the same question with one load per
16-bit window (the ``"lut"`` strategy's plain loop).
"""

from __future__ import annotations

import numpy as np

from .tables import _STATE_BUDGET, DecoderTables


PEEK_BITS = 16


def expand_luts(tables: DecoderTables) -> tuple[np.ndarray, np.ndarray]:
    """Per-component flat LUTs widened to 2^16 entries: index = the next
    16 bits of the stream; entry = (code_length << 16) | data. Returns
    (dc (C, 65536), ac (C, 65536)) int32."""
    def expand(maxbits, lut, off):
        comps = []
        for c in range(len(maxbits)):
            part = lut[off[c]:off[c + 1]]
            reps = 1 << (PEEK_BITS - int(maxbits[c]))
            comps.append(np.repeat(part, reps))
        return np.stack(comps)

    dc = expand(tables.dc_maxbits, tables.dc_lut, tables.dc_off)
    ac = expand(tables.ac_maxbits, tables.ac_lut, tables.ac_off)
    return dc.astype(np.int32), ac.astype(np.int32)


def pack_segments(segments: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Pad segments into an (S, L) uint8 matrix (+4 guard bytes, rows in
    stream order, L not rounded) and return it with per-segment byte
    lengths."""
    lens = np.array([len(s) for s in segments], dtype=np.int32)
    L = int(lens.max()) + 4
    out = np.zeros((len(segments), L), dtype=np.uint8)
    for i, s in enumerate(segments):
        out[i, :len(s)] = np.frombuffer(s, dtype=np.uint8)
    return out, lens


def range_tables(tables: DecoderTables
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns
      lo, hi:  (T, 16) int32 — window range [lo, hi) of code length l+1
               (empty ranges have lo = hi = 0);
      offset:  (T, 16) int32 — position of length l+1's first code's data
               in the flat values array;
      values:  (V,) int32 — every table's decoded data in canonical order
               (DC: size category; AC: (run<<4)|size), zero-padded to a
               multiple of 128."""
    luts = list(tables.dc_luts) + list(tables.ac_luts)
    T = len(luts)
    lo = np.zeros((T, 16), np.int32)
    hi = np.zeros((T, 16), np.int32)
    offset = np.zeros((T, 16), np.int32)
    flat: list[np.ndarray] = []
    n_flat = 0
    for t, lut in enumerate(luts):
        mb = lut.max_bits
        for length in range(1, 17):
            idxs = np.flatnonzero(lut.lengths == length)
            if idxs.size == 0:
                continue
            codes = np.unique(idxs >> (mb - length))
            lo[t, length - 1] = codes[0] << (16 - length)
            hi[t, length - 1] = int(codes[-1] + 1) << (16 - length)
            offset[t, length - 1] = n_flat
            flat.append(lut.data[codes << (mb - length)])
            n_flat += codes.size
    V = max(128, -(-n_flat // 128) * 128)
    values = np.zeros(V, np.int32)
    if flat:
        values[:n_flat] = np.concatenate(flat)
    return lo, hi, offset, values


# --- strategy routing -------------------------------------------------------
# The reference sizes its kernels' per-step state against an on-chip memory
# budget and routes a stream by what fits. The port keeps the same integer
# rules so the same stream takes the same strategy in both packages; on the
# card they are routing thresholds only, not memory limits.

BS_LANES = 128
BS_WIN = 16     # blocks per output window of the streamed decode


def max_lane_chunk(L: int, blocks_per_segment: int) -> int:
    """Lane chunk of the padded-matrix decode (K5) under the budget, or 0."""
    LW = max(L - 3, 1)
    LWp = -(-LW // 128) * 128
    per_lane = 4 * (2 * LWp + 3 * blocks_per_segment * 64)
    ch = _STATE_BUDGET // per_lane
    if ch < 8:
        return 0
    return min(512, 1 << (int(ch).bit_length() - 1))


def max_lanes_t(L: int, blocks_per_segment: int) -> int:
    """Lane count (multiple of 128) of the segment-per-lane decode (K1)
    under the budget, or 0 when a segment's whole coefficient block does
    not fit: the long-segment regime of the streamed decode (K6)."""
    NW = max((L - 2) // 2, 1)
    NWp = -(-NW // 8) * 8
    per_lane = 4 * (NWp + 2 * blocks_per_segment * 64)
    lanes = _STATE_BUDGET // per_lane
    if lanes < 128:
        return 0
    return min(1024, (lanes // 128) * 128)


def max_win_bs(L: int) -> int:
    """Output window (blocks) of the streamed decode (K6), or 0 when the
    byte windows of BS_LANES lanes alone exceed the budget."""
    NW = max((L - 2) // 2, 1)
    NWp = -(-NW // 8) * 8
    words_bytes = 4 * NWp * BS_LANES
    win_bytes = 4 * BS_WIN * 64 * BS_LANES * 2
    if words_bytes + win_bytes > _STATE_BUDGET:
        return 0
    return BS_WIN


def _eligible(lanes: int, S: int) -> bool:
    return lanes >= 128 and S >= 64


def auto_strategy(S: int, L: int, blocks_per_segment: int) -> str:
    """The ``auto`` route of S segments in an (S, L) lane matrix:
    ``"pallas_t"`` (K1), ``"streamed"`` (K6) or ``"pallas"`` (K5), chosen
    as the reference chooses among its kernels. Where the reference would
    leave its kernels for a compiler-generated loop (too few or too long
    lanes), the port stays on K5, which takes any shape."""
    lanes = max_lanes_t(L, blocks_per_segment)
    if _eligible(lanes, S):
        return "pallas_t"
    if lanes == 0 and max_win_bs(L) and _eligible(BS_LANES, S):
        return "streamed"
    return "pallas"


def flat_words_route(S: int, L: int, blocks_per_segment: int,
                     device_huffman: str) -> bool:
    """Does a flat-buffer dispatch feed K1 (or K7) straight from the flat
    buffer? Otherwise the (S, L) lane matrix is gathered on the device
    and the padded-matrix strategy applies."""
    if device_huffman not in ("auto", "pallas_t"):
        return False
    lanes = max_lanes_t(L + 48, blocks_per_segment)
    if lanes == 0:
        return False
    return device_huffman == "pallas_t" or _eligible(lanes, S)
