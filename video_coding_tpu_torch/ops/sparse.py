"""Sparse coefficient transfer: bitmask + packed nonzero values.

Quantized JPEG coefficients are mostly zero, but the host link moves them
densely when the entropy coder runs on the host: the encoder downloads the
quantized coefficients for it. Packing them as a per-block 64-bit
occupancy bitmask plus the nonzero values in order shrinks that transfer
several times over.

Wire format (block-major zigzag order):
- ``mask``:   (n_blocks, 8) uint8 — packbits of the (n_blocks, 64) nonzero
              flags, MSB-first (numpy's ``packbits`` default).
- ``values``: (cap,) int16 — the nonzero coefficients in flat scan order,
              zero-padded past ``nnz``, saturated to the 12-bit coefficient
              width [-2048, 2047] (valid streams always fit).
- ``nnz``:    int32 scalar; ``nnz > cap`` signals overflow (values were
              dropped — the caller must fall back to a dense transfer).

The device side is plain torch (a prefix sum and a scatter or gather); the
host side is vectorized numpy. Round trips are exact within the 12-bit
coefficient width.
"""

from __future__ import annotations

import numpy as np
import torch

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def _weights(device) -> torch.Tensor:
    return torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=device)


def pack_device(qc: torch.Tensor, cap: int):
    """(N, 64) int coefficients → (mask (N, 8) uint8, values (cap,) int16,
    nnz 0-dim int32). On overflow (nnz > cap) the excess values are
    dropped — check nnz before trusting values."""
    flat = qc.reshape(-1)
    nz = flat != 0
    nnz = nz.sum(dtype=torch.int32)
    pos = torch.cumsum(nz, dim=0, dtype=torch.int32) - 1
    # out-of-range positions land in one sink slot past the buffer
    pos = torch.where(nz & (pos < cap), pos, cap).to(torch.int64)
    values = torch.zeros(cap + 1, dtype=torch.int16, device=qc.device)
    values[pos] = flat.clamp(-2048, 2047).to(torch.int16)
    mask = (nz.view(-1, 8, 8).to(torch.int32)
            * _weights(qc.device)).sum(dim=2).to(torch.uint8)
    return mask, values[:cap], nnz


def unpack_device(mask: torch.Tensor, values: torch.Tensor,
                  n_blocks: int) -> torch.Tensor:
    """Inverse of pack_device: → (n_blocks, 64) int32 coefficients."""
    nz = ((mask.to(torch.int32)[:, :, None] & _weights(mask.device)) != 0) \
        .reshape(-1)
    pos = torch.cumsum(nz, dim=0, dtype=torch.int32) - 1
    vals = values.to(torch.int32)[
        pos.clamp(0, values.shape[0] - 1).to(torch.int64)]
    return torch.where(nz, vals, 0).reshape(n_blocks, 64)


def pack_host(qc: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """(N, 64) int coefficients → (mask, values, nnz) with cap = nnz."""
    flat = qc.reshape(-1)
    nz = flat != 0
    values = np.clip(flat[nz], -2048, 2047).astype(np.int16)
    mask = np.packbits(nz.reshape(qc.shape[0], 64), axis=1)
    return mask, values, int(values.size)


def unpack_host(mask: np.ndarray, values: np.ndarray, nnz: int,
                n_blocks: int) -> np.ndarray:
    """Inverse of pack_*: → (n_blocks, 64) int32 coefficients."""
    nz = np.unpackbits(mask, axis=1, count=64).reshape(-1).astype(bool)
    out = np.zeros(n_blocks * 64, dtype=np.int32)
    out[nz] = values[:nnz]
    return out.reshape(n_blocks, 64)
