"""Chroma upsampling and YUV → RGB on the device: the tail of the
decode-for-training path (decoded planes → 4:4:4 → RGB tensors, no host
round trip).

Plain torch ops on the device of their input; every function takes
(h, w) planes or (..., h, w) stacks (a leading batch axis). The
resamplers are the CPU tools' co-located avg2/avg4 kernels with edge
replication (``tools/planar_444.py``) and return int32.

``yuv444_to_rgb`` reproduces, bit for bit, the float32 formula as XLA
compiles it: each ``a * k + b`` is one fused multiply-add, rounded to
float32 once. Here the product and sum are formed exactly in float64 (an
8-bit integer times a float32 constant plus a float32 addend fits its
53 bits) and rounded to float32 at exactly the points where XLA rounds.
Unfused float32 arithmetic (two roundings) differs at 4,387 of the
16,777,216 (y, u, v) triples.
"""

from __future__ import annotations

import numpy as np
import torch

# BT.601 full-range coefficients as the float32 constants XLA multiplies by
_KR = float(np.float32(1.402))
_KGU = float(np.float32(0.344136))
_KGV = float(np.float32(0.714136))
_KB = float(np.float32(1.772))


def _avg2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.to(torch.int32) + b.to(torch.int32) + 1) >> 1


def _avg4(a, b, c, d) -> torch.Tensor:
    return (a.to(torch.int32) + b.to(torch.int32) + c.to(torch.int32)
            + d.to(torch.int32) + 2) >> 2


def _right(p: torch.Tensor) -> torch.Tensor:
    """Each sample's right neighbour, the last column replicated."""
    return torch.cat([p[..., 1:], p[..., -1:]], dim=-1)


def _below(p: torch.Tensor) -> torch.Tensor:
    """Each sample's lower neighbour, the last row replicated."""
    return torch.cat([p[..., 1:, :], p[..., -1:, :]], dim=-2)


def upsample_h2(plane: torch.Tensor) -> torch.Tensor:
    """(..., h, w) → (..., h, 2w): even columns copy, odd columns average
    with the right neighbour."""
    *lead, h, w = plane.shape
    out = torch.stack([plane.to(torch.int32), _avg2(plane, _right(plane))],
                      dim=-1)
    return out.reshape(*lead, h, 2 * w)


def upsample_hv2(plane: torch.Tensor) -> torch.Tensor:
    """(..., h, w) → (..., 2h, 2w): bilinear-style interpolation with the
    right, lower and lower-right neighbours, edges replicated."""
    *lead, h, w = plane.shape
    b = _right(plane)
    c = _below(plane)
    d = _below(b)
    top = torch.stack([plane.to(torch.int32), _avg2(plane, b)],
                      dim=-1).reshape(*lead, h, 2 * w)
    bot = torch.stack([_avg2(plane, c), _avg4(plane, b, c, d)],
                      dim=-1).reshape(*lead, h, 2 * w)
    return torch.stack([top, bot], dim=-2).reshape(*lead, 2 * h, 2 * w)


def upsample_v2(plane: torch.Tensor) -> torch.Tensor:
    """(..., h, w) → (..., 2h, w): even rows copy, odd rows average with
    the row below (the 4:4:0 counterpart of ``upsample_h2``)."""
    *lead, h, w = plane.shape
    out = torch.stack([plane.to(torch.int32), _avg2(plane, _below(plane))],
                      dim=-2)
    return out.reshape(*lead, 2 * h, w)


def downsample_h2(plane: torch.Tensor) -> torch.Tensor:
    """(..., h, 2w) → (..., h, w): horizontal pair average."""
    return _avg2(plane[..., 0::2], plane[..., 1::2])


def downsample_hv2(plane: torch.Tensor) -> torch.Tensor:
    """(..., 2h, 2w) → (..., h, w): 2x2 average."""
    return _avg4(plane[..., 0::2, 0::2], plane[..., 0::2, 1::2],
                 plane[..., 1::2, 0::2], plane[..., 1::2, 1::2])


def yuv444_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """BT.601 full-range YUV → RGB, (..., h, w) planes → (..., h, w, 3):
    r = fma(v', 1.402, y), g = fma(-v', 0.714136, fma(-u', 0.344136, y)),
    b = fma(u', 1.772, y) in float32 with one rounding each, then
    round-half-even, clamp to [0, 255] and cast."""
    f64, f32 = torch.float64, torch.float32
    yf = y.to(f64)
    uf = u.to(f64) - 128.0
    vf = v.to(f64) - 128.0
    r = (vf * _KR + yf).to(f32)
    g_u = (uf * -_KGU + yf).to(f32)
    g = (vf * -_KGV + g_u.to(f64)).to(f32)
    b = (uf * _KB + yf).to(f32)
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.round(rgb).clamp_(0, 255).to(dtype)


def yuv420_to_rgb(y: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Decoded 4:2:0 planes → (..., h, w, 3) uint8 RGB."""
    return yuv444_to_rgb(y, upsample_hv2(u), upsample_hv2(v))


def yuv422_to_rgb(y: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Decoded 4:2:2 planes → (..., h, w, 3) uint8 RGB."""
    return yuv444_to_rgb(y, upsample_h2(u), upsample_h2(v))
