"""8x8 DCT family: integer Chen transforms, floating-point matrix transforms,
and a parameterized fixed-point transform modelling the accelerator MAC
pipeline.

Capability parity with reference jpeg/model/src/dct.ml:
- ``chen_inverse_8x8`` / ``chen_forward_8x8``: the classic integer Chen
  butterflies with fixed constants w1..w7; forward output scaled x4
  (dct.ml:3-196, dct.mli:3-7). Vectorized over a leading batch axis — the
  whole-frame batch form is what the datapath kernels (K2, K3) reproduce
  bit-for-bit.
- ``FloatDct``: 8-point cos matrix transform (dct.ml:239-355). The matrix is
  computed in float64; a snapshot test guards cross-platform drift (the
  reference froze an x86-generated matrix for the same reason, dct.ml:331-343).
- ``fixed_point_transform``: rom_prec/transpose_prec parameterized integer
  matrix transform with round-tie-away-from-zero (dct.ml:443-482), the exact
  arithmetic contract for fixed-point accelerator datapaths.
"""

from __future__ import annotations

import numpy as np

# Chen IDCT constants: round(2048 * sqrt(2) * cos(k*pi/16)), the classic
# integer IDCT parameterization (dct.ml:4-9).
W1 = 2841
W2 = 2676
W3 = 2408
W5 = 1609
W6 = 1108
W7 = 565


def _as_batch(block: np.ndarray) -> tuple[np.ndarray, bool]:
    """Accept (8,8) or (N,8,8); return (N,8,8) int64 copy + squeeze flag."""
    b = np.asarray(block, dtype=np.int64)
    if b.ndim == 2:
        return b[None], True
    return b.copy(), False


def _idct_rows(b: np.ndarray) -> np.ndarray:
    """One horizontal pass of the Chen IDCT (dct.ml idct_row:11-54).

    b: (..., 8) int64 vectors; returns transformed (..., 8)."""
    x0 = (b[..., 0] << 11) + 128
    x1 = b[..., 4] << 11
    x2 = b[..., 6]
    x3 = b[..., 2]
    x4 = b[..., 1]
    x5 = b[..., 7]
    x6 = b[..., 5]
    x7 = b[..., 3]
    # first stage
    x8 = W7 * (x4 + x5)
    x4 = x8 + (W1 - W7) * x4
    x5 = x8 - (W1 + W7) * x5
    x8 = W3 * (x6 + x7)
    x6 = x8 - (W3 - W5) * x6
    x7 = x8 - (W3 + W5) * x7
    # second stage
    x8 = x0 + x1
    x0 = x0 - x1
    x1 = W6 * (x3 + x2)
    x2 = x1 - (W2 + W6) * x2
    x3 = x1 + (W2 - W6) * x3
    x1 = x4 + x6
    x4 = x4 - x6
    x6 = x5 + x7
    x5 = x5 - x7
    # third stage
    x7 = x8 + x3
    x8 = x8 - x3
    x3 = x0 + x2
    x0 = x0 - x2
    x2 = (181 * (x4 + x5) + 128) >> 8
    x4 = (181 * (x4 - x5) + 128) >> 8
    # fourth stage
    return np.stack([
        (x7 + x1) >> 8,
        (x3 + x2) >> 8,
        (x0 + x4) >> 8,
        (x8 + x6) >> 8,
        (x8 - x6) >> 8,
        (x0 - x4) >> 8,
        (x3 - x2) >> 8,
        (x7 - x1) >> 8,
    ], axis=-1)


def _idct_cols(b: np.ndarray) -> np.ndarray:
    """One vertical pass of the Chen IDCT (dct.ml idct_col:56-98).

    b: (..., 8) int64 vectors taken along columns; returns (..., 8)."""
    x0 = (b[..., 0] << 8) + 8192
    x1 = b[..., 4] << 8
    x2 = b[..., 6]
    x3 = b[..., 2]
    x4 = b[..., 1]
    x5 = b[..., 7]
    x6 = b[..., 5]
    x7 = b[..., 3]
    x8 = (W7 * (x4 + x5)) + 4
    x4 = (x8 + (W1 - W7) * x4) >> 3
    x5 = (x8 - (W1 + W7) * x5) >> 3
    x8 = (W3 * (x6 + x7)) + 4
    x6 = (x8 - (W3 - W5) * x6) >> 3
    x7 = (x8 - (W3 + W5) * x7) >> 3
    x8 = x0 + x1
    x0 = x0 - x1
    x1 = (W6 * (x3 + x2)) + 4
    x2 = (x1 - (W2 + W6) * x2) >> 3
    x3 = (x1 + (W2 - W6) * x3) >> 3
    x1 = x4 + x6
    x4 = x4 - x6
    x6 = x5 + x7
    x5 = x5 - x7
    x7 = x8 + x3
    x8 = x8 - x3
    x3 = x0 + x2
    x0 = x0 - x2
    x2 = (181 * (x4 + x5) + 128) >> 8
    x4 = (181 * (x4 - x5) + 128) >> 8
    return np.stack([
        (x7 + x1) >> 14,
        (x3 + x2) >> 14,
        (x0 + x4) >> 14,
        (x8 + x6) >> 14,
        (x8 - x6) >> 14,
        (x0 - x4) >> 14,
        (x3 - x2) >> 14,
        (x7 - x1) >> 14,
    ], axis=-1)


def chen_inverse_8x8(block: np.ndarray) -> np.ndarray:
    """Integer Chen IDCT (dct.ml:100-107): rows pass then columns pass."""
    b, squeeze = _as_batch(block)
    b = _idct_rows(b)                                  # per-row transform
    b = _idct_cols(b.swapaxes(-1, -2)).swapaxes(-1, -2)  # per-column
    return b[0] if squeeze else b


# Forward Chen constants: round(512 * cos-based factors) (dct.ml:109-112).
def _c4(f, g):
    return (362 * (f + g)) >> 9


def _c62(f, g):
    return (196 * f + 473 * g) >> 9


def _c71(f, g):
    return (100 * f + 502 * g) >> 9


def _c35(f, g):
    return (426 * f + 284 * g) >> 9


def _fdct_1d(b: np.ndarray) -> np.ndarray:
    """One forward Chen pass along the last axis (dct.ml dct_col:114-149)."""
    a0 = b[..., 0] + b[..., 7]
    c3 = b[..., 0] - b[..., 7]
    a1 = b[..., 1] + b[..., 6]
    c2 = b[..., 1] - b[..., 6]
    a2 = b[..., 2] + b[..., 5]
    c1 = b[..., 2] - b[..., 5]
    a3 = b[..., 3] + b[..., 4]
    c0 = b[..., 3] - b[..., 4]
    b0 = a0 + a3
    b1 = a1 + a2
    b2 = a1 - a2
    b3 = a0 - a3
    o0 = _c4(b0, b1)
    o4 = _c4(b0, -b1)
    o2 = _c62(b2, b3)
    o6 = _c62(b3, -b2)
    b0 = _c4(c2, -c1)
    b1 = _c4(c2, c1)
    a0 = c0 + b0
    a1 = c0 - b0
    a2 = c3 - b1
    a3 = c3 + b1
    o1 = _c71(a0, a3)
    o5 = _c35(a1, a2)
    o3 = _c35(a2, -a1)
    o7 = _c71(a3, -a0)
    return np.stack([o0, o1, o2, o3, o4, o5, o6, o7], axis=-1)


def chen_forward_8x8(block: np.ndarray) -> np.ndarray:
    """Integer Chen fDCT, output scaled x4 (dct.ml:189-196, dct.mli:3-7).

    Columns pass first, then rows — order matters bit-exactly."""
    b, squeeze = _as_batch(block)
    b = _fdct_1d(b.swapaxes(-1, -2)).swapaxes(-1, -2)  # per-column transform
    b = _fdct_1d(b)                                    # per-row transform
    return b[0] if squeeze else b


# --- floating point matrix transforms (dct.ml:239-355) --------------------

def forward_transform_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix (dct.ml:244-253)."""
    n = 8
    m = np.zeros((8, 8), dtype=np.float64)
    for row in range(8):
        for col in range(8):
            if row == 0:
                m[row, col] = 1.0 / np.sqrt(n)
            else:
                m[row, col] = np.sqrt(2.0 / n) * np.cos(
                    np.pi / n * (col + 0.5) * row)
    return m


class FloatDct:
    """Matrix-form float DCT (dct.ml Floating_point.Eight_point)."""

    MATRIX = forward_transform_matrix()

    @classmethod
    def forward(cls, a: np.ndarray) -> np.ndarray:
        m = cls.MATRIX
        return m @ np.asarray(a, dtype=np.float64) @ m.T

    @classmethod
    def inverse(cls, a: np.ndarray) -> np.ndarray:
        m = cls.MATRIX
        return m.T @ np.asarray(a, dtype=np.float64) @ m


class FourPointDct:
    """8-point DCT built from two 4-point transforms + butterfly — the
    even/odd decomposition used for fast hardware (dct.ml
    Using_four_point:357-440)."""

    @staticmethod
    def _even_fdct_coefs() -> np.ndarray:
        m = np.zeros((4, 4))
        for i in range(4):
            for j in range(4):
                if i == 0:
                    m[i, j] = 0.5 / np.sqrt(2.0)
                else:
                    m[i, j] = 0.5 * np.cos((2 * j + 1) * i * 2 * np.pi / 16)
        return m

    @staticmethod
    def _odd_fdct_coefs() -> np.ndarray:
        m = np.zeros((4, 4))
        for i in range(4):
            for j in range(4):
                m[i, j] = 0.5 * np.cos((2 * j + 1) * (2 * i + 1)
                                       * np.pi / 16)
        return m

    @classmethod
    def _fdct_8pt(cls, b: np.ndarray) -> np.ndarray:
        u = b[:4] + b[7:3:-1]   # b[i] + b[7-i]
        v = b[:4] - b[7:3:-1]
        out = np.empty(8)
        out[0::2] = cls._even_fdct_coefs() @ u
        out[1::2] = cls._odd_fdct_coefs() @ v
        return out

    @classmethod
    def forward(cls, a: np.ndarray) -> np.ndarray:
        a = np.asarray(a, dtype=np.float64)
        rows = np.stack([cls._fdct_8pt(r) for r in a])
        return np.stack([cls._fdct_8pt(c) for c in rows.T]).T

    @classmethod
    def _idct_8pt(cls, b: np.ndarray) -> np.ndarray:
        even_coefs = np.zeros((4, 4))
        for i in range(4):
            for j in range(4):
                even_coefs[i, j] = (0.5 / np.sqrt(2.0) if j == 0 else
                                    0.5 * np.cos((2 * i + 1) * (2 * j)
                                                 * np.pi / 16))
        odd_coefs = cls._odd_fdct_coefs().T
        even = even_coefs @ b[0::2]
        odd = odd_coefs @ b[1::2]
        out = np.empty(8)
        out[:4] = even + odd
        out[4:] = (even - odd)[::-1]
        return out

    @classmethod
    def inverse(cls, a: np.ndarray) -> np.ndarray:
        a = np.asarray(a, dtype=np.float64)
        rows = np.stack([cls._idct_8pt(r) for r in a])
        return np.stack([cls._idct_8pt(c) for c in rows.T]).T


# --- fixed point transform (dct.ml:443-482) -------------------------------

def _round_tie_away(x: np.ndarray, fixed_prec: int) -> np.ndarray:
    """Scale down by 2^prec rounding ties away from zero (dct.ml:451-456)."""
    half = 1 << (fixed_prec - 1)
    floor = lambda v: v >> fixed_prec
    ceil = lambda v: (v + ((1 << fixed_prec) - 1)) >> fixed_prec
    return np.where(x < 0, ceil(x - half), floor(x + half))


def _round_matrix(m: np.ndarray, prec: int) -> np.ndarray:
    if prec == 0:
        return m
    if prec < 0:
        return m << (-prec)
    return _round_tie_away(m, prec)


def fixed_coefs(matrix: np.ndarray, fixed_prec: int) -> np.ndarray:
    """Quantize a float matrix to fixed point, ties away from zero
    (dct.ml:444-448)."""
    scaled = matrix * float(1 << fixed_prec)
    return np.where(scaled >= 0, np.floor(scaled + 0.5),
                    np.ceil(scaled - 0.5)).astype(np.int64)


def fixed_point_transform(transform_matrix: np.ndarray, rom_prec: int,
                          transpose_prec: int, inputs: np.ndarray) -> np.ndarray:
    """Two-pass integer matrix transform with intermediate rounding
    (dct.ml:469-477). Models the accelerator's MAC pipeline exactly."""
    assert rom_prec >= 0 and transpose_prec >= 0
    coefs = fixed_coefs(transform_matrix, rom_prec)
    inputs = np.asarray(inputs, dtype=np.int64)
    transpose = coefs @ inputs
    transpose = _round_matrix(transpose, rom_prec - transpose_prec)
    result = transpose @ coefs.T
    return _round_matrix(result, rom_prec + transpose_prec)


def fixed_forward_transform(inputs, rom_prec: int, transpose_prec: int):
    return fixed_point_transform(FloatDct.MATRIX, rom_prec, transpose_prec,
                                 inputs)


def fixed_inverse_transform(inputs, rom_prec: int, transpose_prec: int):
    return fixed_point_transform(FloatDct.MATRIX.T, rom_prec, transpose_prec,
                                 inputs)
