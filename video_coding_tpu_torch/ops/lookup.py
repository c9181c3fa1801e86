"""K9: small-table lookup, ``table[idx]`` for an int32 table of at most
1024 entries and int32 indices of any shape, with its plain PyTorch
version beside it.

Contract (the reference's ``table_lookup`` / ``_lookup_pallas``): the
result has the shape of ``idx``; an index outside [0, T) gives 0 and never
reads out of bounds. This is the entropy encoder's code ROM: the (N, 63)
lookup of every AC position's packed (code << 5 | length) entry.
"""

from __future__ import annotations

import torch

from .. import kernels

MAX_TABLE = 1024


def table_lookup_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K9: ``table[idx]``, 0 where idx is outside [0, T)."""
    T = table.shape[0]
    inside = (idx >= 0) & (idx < T)
    got = table[idx.clamp(0, T - 1).to(torch.int64)]
    return torch.where(inside, got, torch.zeros_like(got))


def table_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K9: table (T,) int32 with 1 <= T <= 1024, idx int32 of any shape →
    int32 of idx's shape. CPU tensors take the plain version; CUDA tensors
    always launch the kernel."""
    T = table.shape[0] if table.dim() == 1 else -1
    if not 1 <= T <= MAX_TABLE:
        raise ValueError(f"table must be 1-D with 1..{MAX_TABLE} entries, "
                         f"got shape {tuple(table.shape)}")
    dev = idx.device
    for name, t in (("table", table), ("idx", idx)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: expected int32, got {t.dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous on {dev}")
    if dev.type == "cpu":
        return table_lookup_plain(table, idx)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty_like(idx)
    kernels.launch("vct_k9_table_lookup", table.data_ptr(), T,
                   idx.data_ptr(), idx.numel(), out.data_ptr())
    table_lookup.launches += 1
    return out


table_lookup.launches = 0
