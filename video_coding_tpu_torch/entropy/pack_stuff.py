"""K8: the split entropy encoder's bit packer — symbol slots in, stuffed
wire bytes out, one restart segment per lane — with its plain PyTorch
version beside it.

Contract (the reference's ``pack_stuff_pallas``): c_hi, c_lo (S, K) int32
raw bits of each slot's value ``(hi & 0xFFFFFFFF) << 32 | (lo &
0xFFFFFFFF)``, c_len (S, K) int32 bit lengths, raw_bytes_len (S,) int32
each lane's unstuffed byte count →

- out (S, m_out) uint8: per lane, for k = 0..K-1 the low c_len[k] bits of
  slot k appended MSB-first, every completed byte written at the lane's
  cursor; after a 0xFF byte the cursor advances one more over a stuffed
  0x00; a byte whose cursor is at or past m_out is dropped while the
  cursor goes on counting; every byte from the final cursor to m_out is
  zero;
- out_lens (S,) int32: the final cursor;
- overflow: any(raw_bytes_len > m_raw) or any(out_lens > m_out).

Bits of a value at or above its length may be garbage and are masked. A
zero length is a no-op. The caller's last slot pads each lane to a byte
boundary, so nothing is left pending. Lengths lie in 0..59
(``device_encoder_tables`` guarantees it); a length outside that range is
clamped into it, by the kernel and the plain version alike.
"""

from __future__ import annotations

import torch

from .. import kernels
from .huffman_encode import _Sink, m_out_for
from .symbols import SLOTS_PER_BLOCK, append_pad_slot, segment_slots
from .tables import _STATE_BUDGET

MAX_SLOT_BITS = 59

# Routing rules shared with the reference, kept as integer arithmetic so
# that a stream takes the same packer in both packages: a segment of at
# most FUSED_MAX_BLOCKS blocks goes to the fused encoder (K4), a longer one
# to the split form (symbols + K8); max_lane_chunk is the reference's lane
# chunk for a packer state budget of 8 MiB (0 when even 8 lanes don't fit).
FUSED_MAX_BLOCKS = 32


def max_lane_chunk(blocks_per_segment: int, max_seg_bytes: int) -> int:
    B = blocks_per_segment
    W4 = -(-m_out_for(max_seg_bytes) // 32) * 8
    if B <= FUSED_MAX_BLOCKS:
        per_lane = 4 * (B * 64 + B + 3 * W4)
    else:
        Kp = -(-(B * SLOTS_PER_BLOCK + 1) // 8) * 8
        per_lane = 4 * (3 * Kp + 3 * W4)
    ch = _STATE_BUDGET // per_lane
    if ch < 8:
        return 0
    return min(512, 1 << (int(ch).bit_length() - 1))


def pack_stuff_plain(c_hi, c_lo, c_len, raw_bytes_len, *, m_raw: int,
                     m_out: int):
    """Plain PyTorch K8: a loop over the K slots, vectorized over lanes.
    Each slot goes in as two pieces of at most 32 bits (high first), so
    the 64-bit accumulator never holds more than 39 bits."""
    S, K = c_len.shape
    sink = _Sink(S, m_out, c_len.device)
    ln_all = c_len.clamp(0, MAX_SLOT_BITS).to(torch.int64)
    used = (ln_all > 0).any(dim=0).tolist()
    any_hi = (ln_all > 32).any(dim=0).tolist()
    for k in range(K):
        if not used[k]:
            continue
        ln = ln_all[:, k]
        if any_hi[k]:
            sink.put(c_hi[:, k].to(torch.int64), (ln - 32).clamp(min=0),
                     passes=4)
        sink.put(c_lo[:, k].to(torch.int64), ln.clamp(max=32), passes=4)
    out_lens = sink.pos.to(torch.int32)
    out = sink.out[:sink.sink].reshape(S, m_out)
    overflow = (raw_bytes_len > m_raw).any() | (out_lens > m_out).any()
    return out, out_lens, overflow


def pack_stuff(c_hi: torch.Tensor, c_lo: torch.Tensor, c_len: torch.Tensor,
               raw_bytes_len: torch.Tensor, *, m_raw: int, m_out: int):
    """K8: see the module docstring. Returns (out (S, m_out) uint8,
    out_lens (S,) int32, overflow 0-dim bool tensor on the input's
    device). CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if c_len.dim() != 2:
        raise ValueError("c_len must be (S, K)")
    S, K = c_len.shape
    dev = c_len.device
    if m_out < 1 or m_raw < 0:
        raise ValueError("m_out must be >= 1 and m_raw >= 0")
    for name, t, shape in (("c_hi", c_hi, (S, K)), ("c_lo", c_lo, (S, K)),
                           ("c_len", c_len, (S, K)),
                           ("raw_bytes_len", raw_bytes_len, (S,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous on {dev}")
    if dev.type == "cpu":
        return pack_stuff_plain(c_hi, c_lo, c_len, raw_bytes_len,
                                m_raw=m_raw, m_out=m_out)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    # every byte of out is written by the kernel (the tail as zeros)
    out = torch.empty((S, m_out), dtype=torch.uint8, device=dev)
    out_lens = torch.empty(S, dtype=torch.int32, device=dev)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    kernels.launch("vct_k8_pack_stuff", c_hi.data_ptr(), c_lo.data_ptr(),
                   c_len.data_ptr(), raw_bytes_len.data_ptr(), S, K, m_raw,
                   m_out, out.data_ptr(), out_lens.data_ptr(),
                   overflow.data_ptr())
    pack_stuff.launches += 1
    return out, out_lens, overflow[0] != 0


pack_stuff.launches = 0


def encode_segments_split(qcoefs, comp_idx, prev_same_comp, dc_flat, ac_flat,
                          *, blocks_per_segment: int, max_seg_bytes: int,
                          valid=None):
    """The split entropy encoder: symbol construction in plain torch (its
    table lookup through K9), the slot that pads every lane to a byte
    boundary with 1-bits, then K8. Same arguments and results as
    ``gather_pack.encode_segments_device``, byte for byte; no slot
    compaction — a zero-length slot is a no-op of the packer."""
    sym_hi, sym_lo, sym_len = segment_slots(
        qcoefs, comp_idx, prev_same_comp, dc_flat, ac_flat,
        blocks_per_segment, valid)
    c_hi, c_lo, c_len, raw_bytes_len = append_pad_slot(sym_hi, sym_lo,
                                                       sym_len)
    return pack_stuff(c_hi, c_lo, c_len, raw_bytes_len,
                      m_raw=max_seg_bytes, m_out=m_out_for(max_seg_bytes))
