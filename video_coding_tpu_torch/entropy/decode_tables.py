"""Canonical-range Huffman decode tables for K1.

Canonical Huffman codes of one length occupy one contiguous range of the
16-bit peek window, and the ranges of different lengths are disjoint, so
a window matches exactly one length (or none). Row t is component c's DC
table (t = c) or its AC table (t = C + c).
"""

from __future__ import annotations

import numpy as np

from .tables import DecoderTables


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
