"""Block datapaths: K2 (decode) and K3 (encode), each with its plain
PyTorch version beside it.

Decode: coefs (N, 64) zigzag int32 × quant (P, 64) zigzag int32
  → dequant (int32, wrapping) → clamp to the 12-bit accelerator width
  → dezigzag → integer Chen IDCT → clip ±128 → +128 → (N, 8, 8) uint8.
Encode: pixels (N, 8, 8) uint8 × quant (P, 64) zigzag int32
  → −128 → integer Chen fDCT (x4) → zigzag → round-half-away quant
  → (N, 64) int32 zigzag qcoefs.

Block i uses quant row ``i % P`` — P = N gives one row per block; the
sessions pass one restart segment's rows (decode) or one frame's rows
(encode). Quant tables are indexed by zigzag position.

Each wrapper runs the plain version for CPU tensors and launches the
CUDA kernel for CUDA tensors (or raises); it never falls back.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..model.zigzag import FORWARD, INVERSE
from . import chen

# Accelerator coefficient width: 12-bit signed.
COEF_MIN = -2048
COEF_MAX = 2047

_FORWARD = torch.from_numpy(np.asarray(FORWARD, dtype=np.int64))
_INVERSE = torch.from_numpy(np.asarray(INVERSE, dtype=np.int64))


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_aligned(kernel: str, *named) -> None:
    """The kernels copy their inputs in 16-byte pieces."""
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {kernel} reads 16-byte vectors; the "
                             "data must start on a 16-byte boundary")


def _quant_rows(quant: torch.Tensor, n: int) -> torch.Tensor:
    """(P, 64) period table → (n, 64) with row i = quant[i % P]."""
    p = quant.shape[0]
    return quant.repeat(-(-n // p), 1)[:n]


def decode_datapath_plain(coefs: torch.Tensor,
                          quant: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2: (N, 64) int32 coefs × (P, 64) quant → (N, 8, 8)
    uint8 pixels."""
    n = coefs.shape[0]
    deq = coefs * _quant_rows(quant, n)
    deq = deq.clamp(COEF_MIN, COEF_MAX)
    nat = deq[:, _FORWARD.to(coefs.device)].reshape(n, 8, 8)
    out = chen.chen_inverse(nat)
    return (out.clamp(-128, 127) + 128).to(torch.uint8)


def decode_datapath(coefs: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
    """K2: (N, 64) int32 zigzag coefs × (P, 64) int32 zigzag quant →
    (N, 8, 8) uint8 pixels. On the card both inputs must start on a
    16-byte boundary (a fresh tensor does; a view may not)."""
    n = coefs.shape[0]
    if quant.dim() != 2 or quant.shape[1] != 64 or quant.shape[0] < 1:
        raise ValueError(f"quant: expected (P, 64), got {tuple(quant.shape)}")
    _check("coefs", coefs, torch.int32, (n, 64), coefs.device)
    _check("quant", quant, torch.int32, tuple(quant.shape), coefs.device)
    if coefs.device.type == "cpu":
        return decode_datapath_plain(coefs, quant)
    if coefs.device.type != "cuda":
        raise ValueError(f"unsupported device {coefs.device}")
    _check_aligned("K2", ("coefs", coefs), ("quant", quant))
    out = torch.empty((n, 8, 8), dtype=torch.uint8, device=coefs.device)
    kernels.launch("vct_k2_decode_datapath", coefs.data_ptr(),
                   quant.data_ptr(), n, quant.shape[0], out.data_ptr())
    decode_datapath.launches += 1
    return out


decode_datapath.launches = 0


def encode_datapath_plain(pixels: torch.Tensor,
                          quant: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K3: (N, 8, 8) uint8 pixels × (P, 64) quant → (N, 64)
    int32 zigzag quantized coefficients."""
    n = pixels.shape[0]
    f = chen.chen_forward(pixels.to(torch.int32) - 128).reshape(n, 64)
    fzz = f[:, _INVERSE.to(pixels.device)]
    q = _quant_rows(quant, n)
    # round half away from zero with truncating division; the numerator
    # is non-negative, so truncation is the exact integer quotient
    t = torch.div(fzz.abs() + 2 * q, 4 * q, rounding_mode="trunc")
    return torch.where(fzz < 0, -t, t)


def encode_datapath(pixels: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
    """K3: (N, 8, 8) uint8 pixels × (P, 64) int32 zigzag quant → (N, 64)
    int32 zigzag quantized coefficients. On the card both inputs must start
    on a 16-byte boundary (a fresh tensor does; a view may not)."""
    n = pixels.shape[0]
    if quant.dim() != 2 or quant.shape[1] != 64 or quant.shape[0] < 1:
        raise ValueError(f"quant: expected (P, 64), got {tuple(quant.shape)}")
    _check("pixels", pixels, torch.uint8, (n, 8, 8), pixels.device)
    _check("quant", quant, torch.int32, tuple(quant.shape), pixels.device)
    if pixels.device.type == "cpu":
        return encode_datapath_plain(pixels, quant)
    if pixels.device.type != "cuda":
        raise ValueError(f"unsupported device {pixels.device}")
    _check_aligned("K3", ("pixels", pixels), ("quant", quant))
    out = torch.empty((n, 64), dtype=torch.int32, device=pixels.device)
    kernels.launch("vct_k3_encode_datapath", pixels.data_ptr(),
                   quant.data_ptr(), n, quant.shape[0], out.data_ptr())
    encode_datapath.launches += 1
    return out


encode_datapath.launches = 0
