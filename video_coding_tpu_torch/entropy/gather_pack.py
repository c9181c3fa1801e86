"""The gather packer: the split entropy encoder's bit packing and 0xFF00
stuffing as prefix sums and gathers in plain torch (the reference's
``device_pack="xla"`` route and its ``entropy="tpu"`` coder). It holds no
hand-written kernel; its one (N, 63) table lookup inside ``_symbol_parts``
goes through K9.

1. symbols come from ``symbols._symbol_parts`` (65 slots a block);
2. bit offsets come from a prefix sum over the slot lengths of a segment,
   after zero-length slots are compacted away so that at most OVERLAP
   symbols touch one output byte;
3. every output byte gathers the symbols that cover it;
4. stuffing is another prefix sum (+1 output position per 0xFF) and gather.

Byte-identical to the host coder, to K4 and to K9 + K8 segment by segment.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .huffman_encode import device_encoder_tables, m_out_for, packed_tables
from .symbols import append_pad_slot, prev_same_component, segment_slots
from .tables import EncoderTables

# symbols that can overlap one output byte: composite symbols are >= 2 bits
# (the shortest canonical code), so at most ceil(8 / 2) + 1 = 5
OVERLAP = 6

_I32 = torch.int32
_I64 = torch.int64


def _extract_byte(hi: torch.Tensor, lo: torch.Tensor,
                  s: torch.Tensor) -> torch.Tensor:
    """Low byte of (hi·2^32 + lo) >> s for -8 <= s <= 63 (a left shift for
    s < 0), hi and lo int32 raw bits; int64 result in 0..255."""
    hi = hi.to(_I64) & 0xFFFFFFFF
    lo = lo.to(_I64) & 0xFFFFFFFF
    s = s.to(_I64)
    s_ge32 = hi >> (s - 32).clamp(0, 31)
    s_lt32 = (lo >> s.clamp(0, 31)) | (hi << (32 - s).clamp(0, 32))
    s_neg = lo << (-s).clamp(0, 8)
    return torch.where(s >= 32, s_ge32,
                       torch.where(s >= 0, s_lt32, s_neg)) & 0xFF


def _compact_symbols(sym_hi, sym_lo, sym_len):
    """Append the flush pad slot and compact away zero-length slots, so
    that consecutive symbols are >= 2 bits (except the final pad) and
    OVERLAP bounds the symbols per byte. Returns (c_hi, c_lo, c_end,
    c_off, n_compact, raw_bytes_len): compacted values, their bit end and
    start offsets (slot 0's past n_compact), symbol counts and the padded
    byte length of every segment."""
    sym_hi, sym_lo, sym_len, raw_bytes_len = append_pad_slot(
        sym_hi, sym_lo, sym_len)
    S, K = sym_len.shape
    dev = sym_len.device
    ends = torch.cumsum(sym_len, dim=1, dtype=_I32)
    offs = ends - sym_len

    nz = sym_len > 0
    rank = torch.cumsum(nz, dim=1, dtype=_I32)   # 1-based among non-empty
    n_compact = rank[:, -1]
    # a slot's destination is its rank; empty slots land in a spill column
    dst = torch.where(nz, rank - 1, K).to(_I64)
    comp_src = torch.zeros((S, K + 1), dtype=_I64, device=dev)
    comp_src.scatter_(1, dst, torch.arange(K, dtype=_I64, device=dev)
                      .expand(S, K))
    comp_src = comp_src[:, :K]

    def compact(values):
        return torch.gather(values, 1, comp_src)

    return (compact(sym_hi), compact(sym_lo), compact(ends), compact(offs),
            n_compact, raw_bytes_len)


def _count_before(marks_at: torch.Tensor, M: int) -> torch.Tensor:
    """marks_at (S, K) int64 positions (those >= M are dropped) → (S, M)
    int32 counts of marks at each position."""
    S = marks_at.shape[0]
    marks = torch.zeros((S, M + 1), dtype=_I32, device=marks_at.device)
    marks.scatter_add_(1, marks_at.clamp(max=M),
                       torch.ones_like(marks_at, dtype=_I32))
    return marks[:, :M]


def _pack_gather(sym_hi, sym_lo, sym_len, M: int):
    """Pack ordered variable-length symbols into bytes without colliding
    scatters: slot bit offsets are monotone within a segment, so every
    output byte gathers the <= OVERLAP symbols that cover it through a
    rank count. Returns (raw (S, M) uint8, raw_bytes_len, overflow)."""
    c_hi, c_lo, c_end, c_off, n_compact, raw_bytes_len = _compact_symbols(
        sym_hi, sym_lo, sym_len)
    S, K = c_end.shape
    dev = c_end.device
    overflow = (raw_bytes_len > M).any()
    r_idx = torch.arange(K, dtype=_I32, device=dev)
    valid_slot = r_idx[None, :] < n_compact[:, None]

    # a[b] = symbols ending at or before bit 8b: the first symbol that can
    # cover byte b
    byte_bits = torch.arange(M, dtype=_I32, device=dev)[None, :] * 8
    end_byte = torch.where(valid_slot, (c_end + 7) >> 3, M).to(_I64)
    a = torch.cumsum(_count_before(end_byte, M), dim=1, dtype=_I32)

    acc = torch.zeros((S, M), dtype=_I64, device=dev)
    for t in range(OVERLAP):
        idx = (a + t).clamp(0, K - 1).to(_I64)
        end = torch.gather(c_end, 1, idx)
        off = torch.gather(c_off, 1, idx)
        valid = ((a + t) < n_compact[:, None]) & (off < byte_bits + 8) \
            & (end > byte_bits)
        s = (end - byte_bits - 8).clamp(-8, 63)
        val = _extract_byte(torch.gather(c_hi, 1, idx),
                            torch.gather(c_lo, 1, idx), s)
        acc += torch.where(valid, val, 0)
    return (acc & 0xFF).to(torch.uint8), raw_bytes_len, overflow


def _stuff_gather(raw: torch.Tensor, raw_bytes_len: torch.Tensor,
                  M_out: int):
    """0xFF → 0xFF00 stuffing as a gather: output position o maps back to
    its source byte through a rank count over the monotone destination
    positions. Returns (out (S, M_out) uint8, out_lens, overflow)."""
    S, M = raw.shape
    dev = raw.device
    byte_pos = torch.arange(M, dtype=_I32, device=dev)[None, :]
    valid = byte_pos < raw_bytes_len[:, None]
    is_ff = (raw == 0xFF) & valid
    ff_incl = torch.cumsum(is_ff, dim=1, dtype=_I32)
    dest = torch.where(valid, byte_pos + ff_incl - is_ff.to(_I32), 1 << 30)
    out_lens = raw_bytes_len + ff_incl[:, -1]
    overflow = (out_lens > M_out).any()
    # src[o] = source bytes with dest < o (dest values are unique and
    # monotone per row; out-of-range ones drop)
    marks = _count_before(dest.to(_I64), M_out)
    src = torch.cumsum(marks, dim=1, dtype=_I32) - marks
    src_c = src.clamp(0, M - 1).to(_I64)
    out_pos = torch.arange(M_out, dtype=_I32, device=dev)[None, :]
    exact = torch.gather(dest, 1, src_c) == out_pos
    out = torch.where(exact, torch.gather(raw, 1, src_c), 0)
    return out, out_lens, overflow


def encode_segments_device(qcoefs, comp_idx, prev_same_comp, dc_flat,
                           ac_flat, *, blocks_per_segment: int,
                           max_seg_bytes: int, valid=None):
    """Encode all restart segments in parallel through the gather packer.

    qcoefs (N, 64) int32 zigzag quantized coefficients, N divisible by
    blocks_per_segment; dc_flat / ac_flat the packed (code << 5 | length)
    tables; valid an optional (N,) mask — blocks marked false (padding of
    a short last segment) contribute no symbols. Returns (bytes (S, m_out)
    uint8 stuffed and padded, seg_byte_lens (S,) int32, overflow)."""
    slots = segment_slots(qcoefs, comp_idx, prev_same_comp, dc_flat,
                           ac_flat, blocks_per_segment, valid)
    raw, raw_bytes_len, ovf1 = _pack_gather(*slots, max_seg_bytes)
    out, out_lens, ovf2 = _stuff_gather(raw, raw_bytes_len,
                                        m_out_for(max_seg_bytes))
    return out, out_lens, ovf1 | ovf2


def segment_coded_bits(qcoefs, comp_idx, prev_same_comp, dc_flat, ac_flat,
                       *, blocks_per_segment: int, valid=None):
    """Exact coded size of every restart segment in bits, before byte
    padding and 0xFF00 stuffing. Returns (S,) int32."""
    _hi, _lo, sym_len = segment_slots(
        qcoefs, comp_idx, prev_same_comp, dc_flat, ac_flat,
        blocks_per_segment, valid)
    return sym_len.sum(dim=1, dtype=_I32)


def encode_scan_tpu(qcoefs: np.ndarray, comp_idx: np.ndarray,
                    blocks_per_segment: int, tables: EncoderTables,
                    device=None) -> list[bytes]:
    """Drop-in alternative to ``scan.encode_scan`` with the packing on
    ``device`` (None: the card, raising without one) through the gather
    packer. Returns stuffed per-segment byte buffers."""
    n_blocks = len(comp_idx)
    B = blocks_per_segment
    n_segments = (n_blocks + B - 1) // B
    pad_blocks = n_segments * B - n_blocks
    q = np.ascontiguousarray(qcoefs, dtype=np.int32)
    ci = np.ascontiguousarray(comp_idx, dtype=np.int32)
    if pad_blocks:
        q = np.concatenate([q, np.zeros((pad_blocks, 64), np.int32)])
        ci = np.concatenate([ci, np.zeros(pad_blocks, np.int32)])
    dc_flat, ac_flat = packed_tables(*device_encoder_tables(tables))
    prev_same = np.array(prev_same_component(ci[:B]), dtype=np.int32)
    valid = (np.arange(n_segments * B) < n_blocks) if pad_blocks else None
    dev = resolve_device(device)
    q_t, ci_t, prev_t, dc_t, ac_t = (
        torch.from_numpy(a).to(dev) for a in (q, ci, prev_same, dc_flat,
                                              ac_flat))
    valid_t = None if valid is None else torch.from_numpy(valid).to(dev)
    # typical segments are far below the worst case (<= 208 raw bytes a
    # block, <= 2x after stuffing): start lean, escalate on overflow
    for max_seg_bytes in (B * 24 + 64, B * 128 + 64, B * 512 + 64):
        out, lens, overflow = encode_segments_device(
            q_t, ci_t, prev_t, dc_t, ac_t, blocks_per_segment=B,
            max_seg_bytes=max_seg_bytes, valid=valid_t)
        if not bool(overflow):
            break
    else:
        raise ValueError("device entropy encode overflow")
    out = out.cpu().numpy()
    lens = lens.cpu().numpy()
    return [out[s, :lens[s]].tobytes() for s in range(n_segments)]
