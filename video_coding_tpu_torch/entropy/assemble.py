"""Wire assembly: per-segment stuffed bytes + RSTn markers → one buffer per
frame (the reference's ``assemble_stream_device_packed`` and, on a mesh,
its ``stream_scatter``, which are XLA there; plain torch index ops here on
either device).

Segment g of a frame starts at byte ``offsets[g] = sum(lens[:g]) + 2·g``;
every segment but the first is preceded by the marker 0xFF, 0xD0 +
((g - 1) & 7). The frame's body is ``total = offsets[-1] + lens[-1]``
bytes long.
"""

from __future__ import annotations

import torch

_I64 = torch.int64


def assemble_frames(out: torch.Tensor, lens: torch.Tensor, *, frames: int,
                    n_seg: int, cap: int, lens_all: torch.Tensor | None = None,
                    first: int = 0):
    """out (S, m_out) uint8 segment slots and lens (S,) int32 of the
    segments ``first`` .. ``first + S`` of F·Sp, where the first ``n_seg``
    of each frame's Sp are real; ``lens_all`` (F·Sp,) holds every
    segment's length (by default ``lens``: S = F·Sp, all of them here) →
    (bufs (F, cap) uint8 holding these segments' bytes and the markers
    before them, zero elsewhere; totals (F,) int64). A mesh rank assembles
    its own segments so, and the ranks' disjoint buffers sum to the
    stream. Lengths are clamped to m_out, so an overflowed launch
    assembles garbage but stays in bounds (the caller discards it)."""
    F = frames
    dev = out.device
    S, m_out = out.shape
    if lens_all is None:
        lens_all = lens
    sp = lens_all.shape[0] // F
    lens_c = lens_all.view(F, sp).to(_I64).clamp(max=m_out)
    offsets = (torch.cumsum(lens_c, dim=1) - lens_c
               + 2 * torch.arange(sp, device=dev, dtype=_I64)).reshape(-1)
    totals = offsets.view(F, sp)[:, n_seg - 1] + lens_c[:, n_seg - 1]
    bufs = torch.zeros((F, cap), dtype=torch.uint8, device=dev)
    flat = bufs.view(-1)

    gid = first + torch.arange(S, device=dev, dtype=_I64)
    frame, gin = gid // sp, gid % sp
    real = gin < n_seg
    start = frame * cap + offsets[gid]
    # segment bytes: one gather/scatter over every stuffed byte
    seg_lens = torch.where(real, lens_c.view(-1)[gid], 0)
    n_bytes = int(seg_lens.sum())
    seg = torch.repeat_interleave(
        torch.arange(S, device=dev, dtype=_I64), seg_lens,
        output_size=n_bytes)
    within = torch.arange(n_bytes, device=dev, dtype=_I64) \
        - (torch.cumsum(seg_lens, 0) - seg_lens)[seg]
    flat[start[seg] + within] = out.reshape(-1)[seg * m_out + within]

    # RSTn markers before every real segment but a frame's first
    marked = real & (gin > 0)
    mpos = start[marked]
    flat[mpos - 2] = 0xFF
    flat[mpos - 1] = (0xD0 + ((gin[marked] - 1) & 7)).to(torch.uint8)
    return bufs, totals
