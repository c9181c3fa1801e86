"""K1: canonical-Huffman decode of restart segments, one segment per lane,
with its plain PyTorch version beside it.

Contract (the reference's ``decode_flat_pallas_t``): lane s decodes the
bytes ``flat[starts[s] : starts[s] + lens[s]]`` (bytes past the length
read as zero) into ``seg_blocks[s]`` blocks of 64 zigzag coefficients:

- codewords match against canonical range tables (``range_tables``; row
  t = comp for DC, C + comp for AC), values are (run<<4 | size) bytes;
- DC differences accumulate per component from zero;
- decoded values are saturated to int16;
- a step cap of 2·((65·B + 64)//2 + 2) symbols bounds the work of a
  corrupt stream (a valid segment needs at most 64 symbols a block).

Output: (S, B, 64) int32, zero where nothing was decoded. The wrapper
runs the plain version for CPU tensors and launches the CUDA kernel for
CUDA tensors (or raises).
"""

from __future__ import annotations

import torch

from .. import kernels

MAX_COMPONENTS = 4


def max_steps(blocks_per_segment: int) -> int:
    """Per-lane symbol cap, equal to the reference kernel's iteration cap
    times its two symbols per iteration."""
    return 2 * ((blocks_per_segment * 65 + 64) // 2 + 2)


def _peek32(flat: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
            bitpos: torch.Tensor) -> torch.Tensor:
    """The 32 stream bits at ``bitpos`` of every lane (int64), reading
    bytes past the lane's length as zero."""
    byte0 = bitpos >> 3
    word = torch.zeros_like(bitpos)
    last = flat.numel() - 1
    for k in range(5):
        pos = byte0 + k
        idx = (starts + pos).clamp(0, max(last, 0))
        b = flat[idx].to(torch.int64) if last >= 0 else torch.zeros_like(pos)
        word = (word << 8) | torch.where(pos < lens, b, torch.zeros_like(b))
    return (word >> (8 - (bitpos & 7))) & 0xFFFFFFFF


def decode_flat_plain(flat, starts, lens, seg_blocks, comp_sched, lo, hi,
                      offset, values, *, blocks_per_segment: int,
                      n_components: int) -> torch.Tensor:
    """Plain PyTorch K1: the symbol loop vectorized over lanes."""
    dev = starts.device
    S = starts.shape[0]
    B = blocks_per_segment
    C = n_components
    V = values.shape[0]
    starts = starts.to(torch.int64)
    lens = lens.to(torch.int64)
    nblk = seg_blocks.to(torch.int64).clamp(max=B)
    sched = comp_sched.to(torch.int64)
    lo, hi, off = (x.to(torch.int64) for x in (lo, hi, offset))
    values = values.to(torch.int64)
    lens16 = torch.arange(1, 17, device=dev, dtype=torch.int64)
    lane = torch.arange(S, device=dev, dtype=torch.int64)
    zero = torch.zeros(S, device=dev, dtype=torch.int64)

    bitpos = zero.clone()
    blk = zero.clone()
    cof = zero.clone()
    in_ac = torch.zeros(S, device=dev, dtype=torch.bool)
    dc = torch.zeros((S, C), device=dev, dtype=torch.int64)
    # one extra slot absorbs the writes of lanes that write nothing
    out = torch.zeros(S * B * 64 + 1, device=dev, dtype=torch.int32)
    sink = S * B * 64
    cap = max_steps(B)
    for step in range(cap):
        active = blk < nblk
        if step % 16 == 0 and not bool(active.any()):
            break
        # schedule entries past the tables clamp to the last component, as
        # in the kernel (the sessions never produce them)
        comp = sched[blk.clamp(0, B - 1)].clamp(0, C - 1)
        t = comp + torch.where(in_ac, C, 0)
        w32 = _peek32(flat, starts, lens, bitpos)
        w16 = w32 >> 16
        lo_t, hi_t, off_t = lo[t], hi[t], off[t]
        valid = (w16[:, None] >= lo_t) & (w16[:, None] < hi_t)
        code_len = torch.where(valid, lens16, 0).sum(1)
        lo_sel = torch.where(valid, lo_t, 0).sum(1)
        off_sel = torch.where(valid, off_t, 0).sum(1)
        shift = 16 - code_len.clamp(1, 16)
        idx = (off_sel + ((w16 - lo_sel) >> shift)).clamp(0, V - 1)
        data = torch.where(code_len > 0, values[idx] & 0xFF, 0)
        run = torch.where(in_ac, (data >> 4) & 0xF, 0)
        cat = torch.where(in_ac, data & 0xF, data).clamp(max=16)
        code = ((w32 << code_len) & 0xFFFFFFFF) >> (32 - cat.clamp(min=1))
        one = torch.ones_like(cat)
        neg = (code & (one << (cat - 1).clamp(min=0))) == 0
        val = torch.where(neg, code - (one << cat) + 1, code)
        val = torch.where(cat > 0, val, 0)
        bitpos = torch.where(active, bitpos + code_len + cat, bitpos)

        # DC phase
        is_dc = ~in_ac & active
        dc_val = dc[lane, comp] + torch.where(is_dc, val, 0)
        dc[lane, comp] = dc_val
        # AC phase
        is_eob = in_ac & (run == 0) & (cat == 0)
        nc = cof + run
        write_ac = in_ac & ~is_eob & active & (nc < 64)
        do_write = is_dc | write_ac
        wcof = torch.where(is_dc, 0, nc.clamp(0, 63))
        wval = torch.where(is_dc, dc_val, val).clamp(-32768, 32767)
        widx = torch.where(do_write,
                           (lane * B + blk.clamp(0, B - 1)) * 64 + wcof, sink)
        out[widx] = wval.to(torch.int32)

        cof_after = torch.where(in_ac, torch.where(is_eob, 64, nc + 1), 1)
        done = in_ac & (is_eob | (cof_after >= 64))
        blk = torch.where(done & active, blk + 1, blk)
        in_ac = torch.where(done, False, torch.where(in_ac, in_ac, True))
        cof = torch.where(done, 0, cof_after)
    return out[:sink].reshape(S, B, 64)


def decode_flat(flat: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
                seg_blocks: torch.Tensor, comp_sched: torch.Tensor,
                lo: torch.Tensor, hi: torch.Tensor, offset: torch.Tensor,
                values: torch.Tensor, *, blocks_per_segment: int,
                n_components: int) -> torch.Tensor:
    """K1: flat uint8 (M,), starts/lens/seg_blocks int32 (S,), comp_sched
    int32 (B,), lo/hi/offset int32 (T, 16), values int32 (V,) →
    (S, B, 64) int32 zigzag coefficients."""
    S = starts.shape[0]
    B = blocks_per_segment
    C = n_components
    dev = starts.device
    if not 1 <= C <= MAX_COMPONENTS:
        raise ValueError(f"n_components must be 1..{MAX_COMPONENTS}")
    T = lo.shape[0]
    for name, t, dtype, shape in (
            ("flat", flat, torch.uint8, (flat.shape[0],)),
            ("starts", starts, torch.int32, (S,)),
            ("lens", lens, torch.int32, (S,)),
            ("seg_blocks", seg_blocks, torch.int32, (S,)),
            ("comp_sched", comp_sched, torch.int32, (B,)),
            ("lo", lo, torch.int32, (T, 16)),
            ("hi", hi, torch.int32, (T, 16)),
            ("offset", offset, torch.int32, (T, 16)),
            ("values", values, torch.int32, (values.shape[0],))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous on {dev}")
    if T != 2 * C:
        raise ValueError(f"expected {2 * C} range tables, got {T}")
    if dev.type == "cpu":
        return decode_flat_plain(flat, starts, lens, seg_blocks, comp_sched,
                                 lo, hi, offset, values,
                                 blocks_per_segment=B, n_components=C)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.zeros((S, B, 64), dtype=torch.int32, device=dev)
    kernels.launch("vct_k1_huffman_decode", flat.data_ptr(),
                   starts.data_ptr(), lens.data_ptr(), seg_blocks.data_ptr(),
                   S, comp_sched.data_ptr(), B, C, lo.data_ptr(),
                   hi.data_ptr(), offset.data_ptr(), T, values.data_ptr(),
                   values.shape[0], max_steps(B), out.data_ptr())
    decode_flat.launches += 1
    return out


decode_flat.launches = 0
