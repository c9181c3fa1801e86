"""Tracing and observability.

- ``pipeline_trace``: the decode datapath with every intermediate stage
  kept (dequant, row pass, column pass, clip, recon) — a per-stage tensor
  dump of what K2 computes, for tests and logs;
- ``profile``: a context manager around ``torch.profiler`` that writes a
  Chrome trace (``chrome://tracing``, Perfetto, TensorBoard's profiler
  plugin) into a directory.

The JAX package's ``xla_dump_flags`` has no counterpart: there is no XLA
here to dump.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch

from ..model.zigzag import FORWARD
from ..ops.chen import _idct_pass
from ..ops.datapath import COEF_MAX, COEF_MIN
from .engine import resolve_device


@dataclasses.dataclass
class DecodeTrace:
    """Every intermediate array of the decode datapath for a batch of
    blocks."""

    coefs_zigzag: np.ndarray   # (N, 64) input
    dequant_zigzag: np.ndarray
    dequant_natural: np.ndarray
    after_row_pass: np.ndarray  # (N, 8, 8)
    after_col_pass: np.ndarray
    clipped: np.ndarray
    recon: np.ndarray          # (N, 8, 8) final pixels


def pipeline_trace(coefs, quant, device=None) -> DecodeTrace:
    """Stage-by-stage decode datapath of (N, 64) zigzag coefficients and
    (N, 64) or (64,) zigzag quant values (bit-exact with K2 and its plain
    version; the row and column passes are ``ops/chen.py``'s), run on
    ``device`` (None: the card) and returned as host arrays."""
    dev = resolve_device(device)
    coefs = np.asarray(coefs, dtype=np.int32)
    quant = torch.as_tensor(np.asarray(quant, dtype=np.int32), device=dev)
    deq_zz = (torch.as_tensor(coefs, device=dev).to(torch.int64) * quant) \
        .clamp(COEF_MIN, COEF_MAX).to(torch.int32)
    nat = deq_zz[:, torch.as_tensor(np.asarray(FORWARD), device=dev)] \
        .reshape(-1, 8, 8)
    rows = torch.stack(_idct_pass([nat[..., c] for c in range(8)], True),
                       dim=-1)
    cols = torch.stack(_idct_pass([rows[..., r, :] for r in range(8)],
                                  False), dim=-2)
    clipped = cols.clamp(-128, 127)
    return DecodeTrace(
        coefs_zigzag=coefs,
        dequant_zigzag=deq_zz.cpu().numpy(),
        dequant_natural=nat.cpu().numpy(),
        after_row_pass=rows.cpu().numpy(),
        after_col_pass=cols.cpu().numpy(),
        clipped=clipped.cpu().numpy(),
        recon=(clipped + 128).cpu().numpy(),
    )


@contextlib.contextmanager
def profile(log_dir: str):
    """Profile a region with ``torch.profiler`` (the host, and the card
    when there is one) and write its Chrome trace into ``log_dir``.
    Yields the profiler."""
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
