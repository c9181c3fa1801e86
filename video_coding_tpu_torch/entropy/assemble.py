"""Wire assembly: per-segment stuffed bytes + RSTn markers → one buffer per
frame (the reference's ``assemble_stream_device_packed``, which is XLA
there; plain torch index ops here on either device).

Segment g of a frame starts at byte ``offsets[g] = sum(lens[:g]) + 2·g``;
every segment but the first is preceded by the marker 0xFF, 0xD0 +
((g - 1) & 7). The frame's body is ``total = offsets[-1] + lens[-1]``
bytes long.
"""

from __future__ import annotations

import torch


def assemble_frames(out: torch.Tensor, lens: torch.Tensor, *, frames: int,
                    n_seg: int, cap: int):
    """out (F·Sp, m_out) uint8 segment slots and lens (F·Sp,) int32, with
    the first ``n_seg`` of each frame's Sp segments real → (bufs (F, cap)
    uint8, totals (F,) int64). Lengths are clamped to m_out, so an
    overflowed launch assembles garbage but stays in bounds (the caller
    discards it)."""
    F = frames
    dev = out.device
    m_out = out.shape[1]
    sp = out.shape[0] // F
    lens_f = lens.view(F, sp)[:, :n_seg].to(torch.int64).clamp(max=m_out)
    g = torch.arange(n_seg, device=dev, dtype=torch.int64)
    offsets = torch.cumsum(lens_f, dim=1) - lens_f + 2 * g
    totals = offsets[:, -1] + lens_f[:, -1]
    bufs = torch.zeros((F, cap), dtype=torch.uint8, device=dev)
    flat = bufs.view(-1)

    # segment bytes: one gather/scatter over every stuffed byte
    seg_lens = lens_f.reshape(-1)
    n_bytes = int(seg_lens.sum())
    seg = torch.repeat_interleave(
        torch.arange(F * n_seg, device=dev, dtype=torch.int64), seg_lens,
        output_size=n_bytes)
    seg_start = torch.cumsum(seg_lens, 0) - seg_lens
    within = torch.arange(n_bytes, device=dev, dtype=torch.int64) \
        - seg_start[seg]
    frame = seg // n_seg
    src = (frame * sp + seg % n_seg) * m_out + within
    dst = frame * cap + offsets.reshape(-1)[seg] + within
    flat[dst] = out.reshape(-1)[src]

    # RSTn markers before every segment but the first
    if n_seg > 1:
        mpos = (torch.arange(F, device=dev, dtype=torch.int64)[:, None] * cap
                + offsets[:, 1:]).reshape(-1)
        code = (0xD0 + ((g[1:] - 1) & 7)).repeat(F).to(torch.uint8)
        flat[mpos - 2] = 0xFF
        flat[mpos - 1] = code
    return bufs, totals
