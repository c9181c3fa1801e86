"""Huffman table machinery: canonical code construction, decoder LUTs,
encoder lookup tables, and the JPEG Annex-K default specifications.

Capability parity with reference jpeg/model/src/tables.ml:
- ``Spec`` (16 length counts + values) → canonical code list
  (tables.ml:27-48 create_code_table);
- decoder-side flat LUT of 2^max_bits entries, each (length, data) —
  lookup = peek max_bits, index, advance by length (tables.ml:490-502);
- encoder-side DC table indexed by size and AC table indexed by
  [run][size] with placeholder size-0 entries (tables.ml:505-545);
- Annex-K default luma/chroma DC/AC specs (tables.ml:54-477; values are
  ITU-T T.81 Tables K.3-K.6 spec constants).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Code:
    """One canonical Huffman code: bit-length, code bits, decoded data."""

    length: int
    bits: int
    data: int | tuple  # DC: size category; AC: (run, size)


@dataclasses.dataclass(frozen=True)
class Spec:
    """DHT-style specification: lengths[16] counts + value bytes."""

    lengths: tuple  # 16 ints: number of codes of length i+1
    values: tuple   # sum(lengths) value bytes

    def code_table(self, to_data) -> list[Code]:
        """Assign canonical codes by increasing length (tables.ml:27-48)."""
        codes: list[Code] = []
        code = 0
        vpos = 0
        for li, count in enumerate(self.lengths):
            for i in range(count):
                codes.append(Code(length=li + 1, bits=code + i,
                                  data=to_data(self.values[vpos + i])))
            code = (code + count) << 1
            vpos += count
        return codes

    def dc_code_table(self) -> list[Code]:
        return self.code_table(lambda v: v)

    def ac_code_table(self) -> list[Code]:
        return self.code_table(lambda v: ((v >> 4) & 0xF, v & 0xF))


class Lut:
    """Flat decoder LUT: peek ``max_bits`` bits, one indexed load yields
    (code length, decoded data). Mirrors Tables.Lut (tables.ml:490-502); the
    same flat structure ships to the C++ and TPU entropy decoders.

    ``lengths[idx] == 0`` marks an invalid prefix (no code)."""

    __slots__ = ("max_bits", "lengths", "data")

    def __init__(self, codes: list[Code], ac: bool):
        max_bits = max((c.length for c in codes), default=0)
        size = 1 << max_bits
        lengths = np.zeros(size, dtype=np.int32)
        data = np.zeros(size, dtype=np.int32)
        for c in codes:
            null_bits = max_bits - c.length
            first = c.bits << null_bits
            count = 1 << null_bits
            if ac:
                run, sz = c.data
                packed = (run << 4) | sz
            else:
                packed = c.data
            lengths[first:first + count] = c.length
            data[first:first + count] = packed
        self.max_bits = max_bits
        self.lengths = lengths
        self.data = data

    def lookup(self, peeked: int) -> tuple[int, int]:
        """(code_length, packed_data); code_length==0 → invalid prefix."""
        return int(self.lengths[peeked]), int(self.data[peeked])


def encoder_dc_table(spec: Spec) -> list[Code]:
    """DC encoder table indexed by size category (tables.ml:505-514)."""
    codes = sorted(spec.dc_code_table(), key=lambda c: c.data)
    return codes


def encoder_ac_table(spec: Spec) -> list[list[Code]]:
    """AC encoder table indexed [run][size] (tables.ml:516-545).

    Runs without a size-0 code get a zero-length placeholder at index 0 so
    that real codes land at their size index (run=0 EOB and run=15 ZRL have
    real size-0 codes)."""
    codes = sorted(spec.ac_code_table(), key=lambda c: c.data)
    by_run: dict[int, list[Code]] = {}
    for c in codes:
        by_run.setdefault(c.data[0], []).append(c)
    table: list[list[Code]] = []
    for run in sorted(by_run):
        group = by_run[run]
        if group[0].data[1] != 0:
            group = [Code(length=0, bits=0, data=(run, 0))] + group
        table.append(group)
    return table


# --- Annex-K default specifications (ITU-T T.81 Tables K.3-K.6) -----------

DC_LUMA = Spec(
    lengths=(0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
    values=tuple(range(12)),
)

DC_CHROMA = Spec(
    lengths=(0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
    values=tuple(range(12)),
)

AC_LUMA = Spec(
    lengths=(0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D),
    values=(
        0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
        0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
        0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
        0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
        0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
        0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
        0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
        0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
        0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
        0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
        0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
        0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
        0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
        0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
        0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
        0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
        0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
        0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
        0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
        0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
        0xF9, 0xFA,
    ),
)

AC_CHROMA = Spec(
    lengths=(0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
    values=(
        0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
        0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
        0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
        0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
        0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
        0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
        0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
        0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
        0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
        0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
        0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
        0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
        0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96,
        0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
        0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
        0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
        0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2,
        0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
        0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
        0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
        0xF9, 0xFA,
    ),
)
