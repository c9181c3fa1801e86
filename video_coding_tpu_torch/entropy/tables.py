"""Packed Huffman table formats, as the reference packs them for its
entropy engines; the port derives its K1/K4 tables from these.

Decoder side: per component, a flat 2^max_bits LUT of int32 entries
``(code_length << 16) | data`` (DC data = size category; AC data =
(run<<4)|size) — the same structure as the model Lut (huffman.py) and the
reference's Tables.Lut (tables.ml:490-502).

Encoder side: per component, DC arrays [12] and AC arrays [16*11]
(run-major) of code bits (uint16) and lengths (uint8) — the structure of
the reference's Tables.Encoder (tables.ml:505-545) flattened for the
native kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..model.huffman import Lut, Spec, encoder_ac_table, encoder_dc_table

# The reference sizes its decode and pack kernels' per-step state against
# one on-chip memory budget; the port's routing rules (decode_tables,
# pack_stuff) keep the same integer arithmetic against it.
_STATE_BUDGET = 8 << 20


@dataclasses.dataclass
class DecoderTables:
    """Per-scan-component packed decoder LUTs."""

    dc_maxbits: np.ndarray  # (C,) int32
    dc_lut: np.ndarray      # concat int32
    dc_off: np.ndarray      # (C+1,) int64
    ac_maxbits: np.ndarray
    ac_lut: np.ndarray
    ac_off: np.ndarray
    dc_luts: list           # model Lut objects (python fallback)
    ac_luts: list


def pack_decoder_tables(dc_luts: list[Lut], ac_luts: list[Lut]) -> DecoderTables:
    def pack(luts):
        maxbits = np.array([l.max_bits for l in luts], dtype=np.int32)
        parts = [(l.lengths.astype(np.int64) << 16 | l.data).astype(np.int32)
                 for l in luts]
        off = np.zeros(len(luts) + 1, dtype=np.int64)
        off[1:] = np.cumsum([p.size for p in parts])
        return maxbits, np.concatenate(parts) if parts else np.zeros(0, np.int32), off

    dc_maxbits, dc_lut, dc_off = pack(dc_luts)
    ac_maxbits, ac_lut, ac_off = pack(ac_luts)
    return DecoderTables(dc_maxbits, dc_lut, dc_off,
                         ac_maxbits, ac_lut, ac_off, dc_luts, ac_luts)


@dataclasses.dataclass
class EncoderTables:
    """Per-scan-component packed encoder code tables."""

    dc_bits: np.ndarray  # (C*12,) uint16
    dc_len: np.ndarray   # (C*12,) uint8
    ac_bits: np.ndarray  # (C*176,) uint16  [run*11+size]
    ac_len: np.ndarray


def pack_encoder_tables(dc_specs: list[Spec], ac_specs: list[Spec]) -> EncoderTables:
    c = len(dc_specs)
    dc_bits = np.zeros(c * 12, dtype=np.uint16)
    dc_len = np.zeros(c * 12, dtype=np.uint8)
    ac_bits = np.zeros(c * 176, dtype=np.uint16)
    ac_len = np.zeros(c * 176, dtype=np.uint8)
    for ci, (dspec, aspec) in enumerate(zip(dc_specs, ac_specs)):
        for code in encoder_dc_table(dspec):
            dc_bits[ci * 12 + code.data] = code.bits
            dc_len[ci * 12 + code.data] = code.length
        for run, group in enumerate(encoder_ac_table(aspec)):
            for code in group:
                r, s = code.data
                if s <= 10:
                    ac_bits[ci * 176 + r * 11 + s] = code.bits
                    ac_len[ci * 176 + r * 11 + s] = code.length
    return EncoderTables(dc_bits, dc_len, ac_bits, ac_len)
