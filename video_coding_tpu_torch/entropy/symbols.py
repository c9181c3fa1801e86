"""Symbol construction of the split entropy encoder, data parallel per
block: every block becomes 65 symbol slots (DC + 63 AC positions + EOB),
each a bit-packed codeword + magnitude value of up to 59 bits and its bit
length (0 for an empty slot).

Zero runs come from a cumulative maximum over coefficient positions (no
sequential state machine), and the at most three ZRL codes a block can need
before a coefficient fold into that coefficient's slot. The values are
carried as (hi, lo) int32 raw bits — the 64-bit value is
``(hi & 0xFFFFFFFF) << 32 | (lo & 0xFFFFFFFF)`` — and everything stays
int32: at 1080p a 16-frame dispatch holds 49 million slots per
intermediate. Bits of a value at or above its length may be garbage (an
empty AC slot carries the code of its table entry); the packers mask them.

The one (N, 63) table lookup goes through ``ops.lookup.table_lookup`` (K9).
"""

from __future__ import annotations

import torch

from ..ops.lookup import table_lookup

# symbol slots per block: 1 DC + 63 positions (ZRLs folded in) + 1 EOB
SLOTS_PER_BLOCK = 65


def _pow2(n: torch.Tensor) -> torch.Tensor:
    """1 << n in n's integer type."""
    return torch.bitwise_left_shift(torch.ones_like(n), n)


def _size_category(v: torch.Tensor) -> torch.Tensor:
    """Bit length of |v| for |v| <= 4095 (12 thresholds), int32."""
    mag = v.abs()
    r = torch.zeros_like(mag)
    for t in range(12):
        r += mag >= (1 << t)
    return r


def _magnitude_bits(size: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    mask = _pow2(size) - 1
    return torch.where(v >= 0, v, v - 1) & mask


def _prepend(hi, lo, length, code, code_len, enable):
    """Prepend ``code`` (at most 16 bits) in front of the (hi, lo, length)
    symbol: new value = code·2^length + value. The right shift is of a
    non-negative code, and the adds are of disjoint bit ranges, so int32
    wrap-around reproduces the unsigned arithmetic exactly."""
    sh = length
    low = sh < 32
    lo_add = torch.where(low, code << sh.clamp(max=31), 0)
    hi_add = torch.where(
        low, torch.where(sh == 0, 0, code >> (32 - sh).clamp(1, 31)),
        code << (sh - 32).clamp(0, 31))
    new_hi = torch.where(enable, hi + hi_add, hi)
    new_lo = torch.where(enable, lo + lo_add, lo)
    new_len = torch.where(enable, length + code_len, length)
    return new_hi, new_lo, new_len


def prev_same_component(sched) -> list[int]:
    """For every position of a segment's block schedule, the position of
    the previous block of the same component in the segment, or -1."""
    prev, last_seen = [], {}
    for i, c in enumerate(sched):
        prev.append(last_seen.get(int(c), -1))
        last_seen[int(c)] = i
    return prev


def _symbol_parts(qcoefs: torch.Tensor, comp_idx: torch.Tensor,
                  prev_same_comp: torch.Tensor, dc_flat: torch.Tensor,
                  ac_flat: torch.Tensor, blocks_per_segment: int):
    """qcoefs (N, 64) int32 zigzag coefficients, comp_idx (N,) int32
    component of every block, prev_same_comp (B,) int32, dc_flat (C·12,)
    and ac_flat (C·176,) int32 packed (code << 5 | length) tables →
    (sym_hi, sym_lo, sym_len), each (N, SLOTS_PER_BLOCK) int32."""
    N = qcoefs.shape[0]
    B = blocks_per_segment
    S = N // B
    dev = qcoefs.device
    i32 = torch.int32
    q = qcoefs.to(i32)
    c = comp_idx.to(i32)

    # DC differential per scan component within each segment
    dcs = q[:, 0].reshape(S, B)
    has_prev = prev_same_comp >= 0
    prev = torch.where(has_prev[None, :],
                       dcs[:, prev_same_comp.clamp(0, B - 1).to(torch.int64)],
                       0)
    diff = (dcs - prev).reshape(N)
    dsize = _size_category(diff)
    dc_packed = dc_flat[(c * 12 + dsize).to(torch.int64)]
    dc_lo = ((dc_packed >> 5) << dsize) | _magnitude_bits(dsize, diff)
    dc_slen = (dc_packed & 31) + dsize

    # AC positions 1..63: zero runs via cumulative max of last-nonzero idx
    pos = torch.arange(64, dtype=i32, device=dev)
    nzmask = q != 0
    anchor = torch.where(nzmask | (pos == 0), pos, 0)  # DC anchors the run
    last_nz_before = torch.cummax(anchor, dim=1).values
    run = pos[1:] - last_nz_before[:, :-1] - 1          # (N, 63)
    last_nz = anchor.amax(dim=1)
    del anchor, last_nz_before

    ac = q[:, 1:]
    ac_nz = nzmask[:, 1:]
    asize = _size_category(ac)
    zrl_count = run >> 4
    ac_idx = (c[:, None] * 16 + (run & 15)) * 11 + asize
    del run
    ac_packed = table_lookup(ac_flat, ac_idx.contiguous())
    del ac_idx
    lo = ((ac_packed >> 5) << asize) | _magnitude_bits(asize, ac)
    ln = torch.where(ac_nz, (ac_packed & 31) + asize, 0)
    hi = torch.zeros_like(lo)
    del ac_packed, asize

    # fold the <= 3 ZRLs in front of their following code
    zrl_packed = ac_flat[(c * 176 + 15 * 11).to(torch.int64)][:, None]
    zrl_bits = zrl_packed >> 5
    zrl_len = zrl_packed & 31
    for k in (1, 2, 3):
        enable = ac_nz & (zrl_count >= k)
        hi, lo, ln = _prepend(hi, lo, ln, zrl_bits, zrl_len, enable)

    eob_packed = ac_flat[(c * 176).to(torch.int64)]
    need_eob = last_nz < 63
    eob_lo = torch.where(need_eob, eob_packed >> 5, 0)
    eob_len = torch.where(need_eob, eob_packed & 31, 0)

    zero = torch.zeros((N, 1), dtype=i32, device=dev)
    sym_hi = torch.cat([zero, hi, zero], dim=1)
    sym_lo = torch.cat([dc_lo[:, None], lo, eob_lo[:, None]], dim=1)
    sym_len = torch.cat([dc_slen[:, None], ln, eob_len[:, None]], dim=1)
    return sym_hi, sym_lo, sym_len


def segment_slots(qcoefs, comp_idx, prev_same_comp, dc_flat, ac_flat,
                   blocks_per_segment: int, valid):
    """The symbol slots of every segment: three (S, B·65) int32 arrays,
    with the slots of blocks whose ``valid`` is False emptied."""
    B = blocks_per_segment
    S = qcoefs.shape[0] // B
    sym_hi, sym_lo, sym_len = _symbol_parts(
        qcoefs, comp_idx, prev_same_comp, dc_flat, ac_flat, B)
    if valid is not None:
        sym_len = torch.where(valid.reshape(-1, 1) != 0, sym_len, 0)
    K = B * SLOTS_PER_BLOCK
    return (sym_hi.reshape(S, K), sym_lo.reshape(S, K),
            sym_len.reshape(S, K))


def append_pad_slot(sym_hi, sym_lo, sym_len):
    """(S, K) slots → (S, K + 1) with the slot that pads each lane to a
    byte boundary with 1-bits, and raw_bytes_len (S,) int32, the padded
    byte count of every lane."""
    S = sym_len.shape[0]
    total_bits = sym_len.sum(dim=1, dtype=torch.int32)
    pad_len = (-total_bits) & 7
    pad_bits = torch.bitwise_left_shift(torch.ones_like(pad_len),
                                        pad_len) - 1
    zero = torch.zeros((S, 1), dtype=torch.int32, device=sym_len.device)
    return (torch.cat([sym_hi, zero], dim=1),
            torch.cat([sym_lo, pad_bits[:, None]], dim=1),
            torch.cat([sym_len, pad_len[:, None]], dim=1),
            (total_bits + pad_len) >> 3)
