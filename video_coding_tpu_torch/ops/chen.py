"""Integer Chen IDCT and fDCT as plain int32 torch ops.

Bit-exact re-expression of the golden model's integer transforms on
(..., 8, 8) int32 tensors — axis -2 is the block row, axis -1 the block
column — vectorized over every leading axis. Torch int32 arithmetic wraps
and ``>>`` is an arithmetic shift, as in the reference's int32 forms.

int32 range contract: IDCT inputs fit the 12-bit accelerator coefficient
width (the decode datapath clamps to [-2048, 2047]); then every
intermediate fits int32 except ``181 * a``, which ``_mul181_shift8``
keeps exact with the reference's 16-bit split.
"""

from __future__ import annotations

import torch

W1 = 2841
W2 = 2676
W3 = 2408
W5 = 1609
W6 = 1108
W7 = 565


def _mul181_shift8(a: torch.Tensor) -> torch.Tensor:
    """Exact (181*a + 128) >> 8 without int32 overflow: with
    a = ah*2^16 + al (al the non-negative low 16 bits), 181*ah*2^16 is
    256-aligned, so the shift distributes exactly."""
    ah = a >> 16
    al = a & 0xFFFF
    return 181 * ah * 256 + ((181 * al + 128) >> 8)


def _idct_pass(x: list[torch.Tensor], row: bool) -> list[torch.Tensor]:
    """One 8-point Chen IDCT pass over the eight input vectors ``x``; the
    row variant scales by 2^11 and shifts by 8, the column variant by 2^8
    with +4 rounding and a final shift of 14."""
    if row:
        x0 = (x[0] << 11) + 128
        x1 = x[4] << 11
    else:
        x0 = (x[0] << 8) + 8192
        x1 = x[4] << 8
    x2, x3, x4, x5, x6, x7 = x[6], x[2], x[1], x[7], x[5], x[3]
    r = 0 if row else 4
    s = 0 if row else 3
    x8 = W7 * (x4 + x5) + r
    x4 = (x8 + (W1 - W7) * x4) >> s
    x5 = (x8 - (W1 + W7) * x5) >> s
    x8 = W3 * (x6 + x7) + r
    x6 = (x8 - (W3 - W5) * x6) >> s
    x7 = (x8 - (W3 + W5) * x7) >> s
    x8 = x0 + x1
    x0 = x0 - x1
    x1 = W6 * (x3 + x2) + r
    x2 = (x1 - (W2 + W6) * x2) >> s
    x3 = (x1 + (W2 - W6) * x3) >> s
    x1 = x4 + x6
    x4 = x4 - x6
    x6 = x5 + x7
    x5 = x5 - x7
    x7 = x8 + x3
    x8 = x8 - x3
    x3 = x0 + x2
    x0 = x0 - x2
    x2 = _mul181_shift8(x4 + x5)
    x4 = _mul181_shift8(x4 - x5)
    sh = 8 if row else 14
    return [(x7 + x1) >> sh, (x3 + x2) >> sh, (x0 + x4) >> sh,
            (x8 + x6) >> sh, (x8 - x6) >> sh, (x0 - x4) >> sh,
            (x3 - x2) >> sh, (x7 - x1) >> sh]


def chen_inverse(b: torch.Tensor) -> torch.Tensor:
    """Integer Chen IDCT of (..., 8, 8) int32 blocks: rows pass, then
    columns pass (the reference's order, bit-exact)."""
    rows = torch.stack(_idct_pass([b[..., c] for c in range(8)], True),
                       dim=-1)
    return torch.stack(_idct_pass([rows[..., r, :] for r in range(8)],
                                  False), dim=-2)


def _fdct_pass(b: list[torch.Tensor]) -> list[torch.Tensor]:
    """One 8-point forward Chen pass (the reference's dct_col/dct_row)."""
    a0 = b[0] + b[7]
    c3 = b[0] - b[7]
    a1 = b[1] + b[6]
    c2 = b[1] - b[6]
    a2 = b[2] + b[5]
    c1 = b[2] - b[5]
    a3 = b[3] + b[4]
    c0 = b[3] - b[4]
    b0 = a0 + a3
    b1 = a1 + a2
    b2 = a1 - a2
    b3 = a0 - a3
    o0 = (362 * (b0 + b1)) >> 9
    o4 = (362 * (b0 - b1)) >> 9
    o2 = (196 * b2 + 473 * b3) >> 9
    o6 = (196 * b3 - 473 * b2) >> 9
    b0 = (362 * (c2 - c1)) >> 9
    b1 = (362 * (c2 + c1)) >> 9
    a0 = c0 + b0
    a1 = c0 - b0
    a2 = c3 - b1
    a3 = c3 + b1
    o1 = (100 * a0 + 502 * a3) >> 9
    o5 = (426 * a1 + 284 * a2) >> 9
    o3 = (426 * a2 - 284 * a1) >> 9
    o7 = (100 * a3 - 502 * a0) >> 9
    return [o0, o1, o2, o3, o4, o5, o6, o7]


def chen_forward(b: torch.Tensor) -> torch.Tensor:
    """Integer Chen fDCT (x4 scaled) of (..., 8, 8) int32 blocks: columns
    pass, then rows pass (the reference's order, bit-exact)."""
    cols = torch.stack(_fdct_pass([b[..., r, :] for r in range(8)]), dim=-2)
    return torch.stack(_fdct_pass([cols[..., c] for c in range(8)]), dim=-1)
