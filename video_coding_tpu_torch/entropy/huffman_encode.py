"""K4: the whole baseline entropy encoder (16 lanes a restart segment on
the card), with its plain PyTorch version beside it.

Contract (the reference's ``encode_segments_fused``): (S, B·64) int32
quantized zigzag coefficients and an (S, B) valid mask →

- out (S, m_out) uint8: each segment's stuffed bytes from byte 0 (bytes
  past m_out are dropped, the rest of the slot is zero);
- lens (S,) int32: each segment's stuffed byte length;
- overflow: True when some segment needs more than m_out bytes.

Per block: DC difference against the component's predictor, size
category, lookups in packed (code << 5 | len) tables, AC runs with ZRL at
run 16 (only before the last nonzero) and EOB unless position 63 is
nonzero; 0xFF is followed by a stuffed 0x00; each segment ends with a
flush to a byte boundary with 1-bits. Blocks with valid == 0 emit nothing
and leave the predictors alone.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .tables import EncoderTables

MAX_COMPONENTS = 4


def device_encoder_tables(tables: EncoderTables):
    """Reshape packed encoder tables for device lookup: (dc_bits (C, 12),
    dc_len, ac_bits (C, 16, 11), ac_len) int32.

    Validates the device coders' structural assumptions, which hold for
    every standard table (Annex-K defaults included): every code is ≥ 2
    bits, and a composite symbol (≤ 3 ZRL + code + ≤ 10 magnitude bits)
    fits 59 bits. Tables that break them are refused."""
    c = len(tables.dc_bits) // 12
    dc_bits = tables.dc_bits.reshape(c, 12).astype(np.int32)
    dc_len = tables.dc_len.reshape(c, 12).astype(np.int32)
    ac_bits = tables.ac_bits.reshape(c, 16, 11).astype(np.int32)
    ac_len = tables.ac_len.reshape(c, 16, 11).astype(np.int32)
    lens = np.concatenate([dc_len.ravel(), ac_len.ravel()])
    if lens[lens > 0].min(initial=2) < 2:
        raise ValueError("device entropy encoder requires codes ≥ 2 bits")
    worst = 3 * int(ac_len[:, 15, 0].max(initial=0)) \
        + int(ac_len.max(initial=0)) + 10
    if worst > 59:
        raise ValueError("device entropy encoder composite symbol would "
                         "exceed 59 bits")
    return dc_bits, dc_len, ac_bits, ac_len


def packed_tables(dc_bits, dc_len, ac_bits, ac_len):
    """(C·12,) and (C·176,) int32 (code << 5 | len) lookup tables."""
    dctab = (dc_bits.astype(np.int32) << 5) | dc_len.astype(np.int32)
    actab = (ac_bits.astype(np.int32) << 5) | ac_len.astype(np.int32)
    return dctab.reshape(-1), actab.reshape(-1)


def m_out_for(max_seg_bytes: int) -> int:
    """Per-segment output slot for a raw byte budget, with room for
    worst-case stuffing."""
    return max_seg_bytes + max_seg_bytes // 4 + 8


def _size_category(v: torch.Tensor) -> torch.Tensor:
    """Bit length of v ≥ 0, saturating at 11."""
    r = torch.zeros_like(v)
    for t in range(11):
        r += (v >= (1 << t)).to(v.dtype)
    return r


def _magnitude_bits(v: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 0, v, v - 1) & ((1 << size) - 1)


class _Sink:
    """Vectorized bit accumulator + byte writer over lanes."""

    def __init__(self, S: int, m_out: int, device):
        self.m_out = m_out
        self.acc = torch.zeros(S, dtype=torch.int64, device=device)
        self.nbits = torch.zeros(S, dtype=torch.int64, device=device)
        self.pos = torch.zeros(S, dtype=torch.int64, device=device)
        self.base = torch.arange(S, dtype=torch.int64, device=device) * m_out
        self.sink = S * m_out
        self.out = torch.zeros(S * m_out + 1, dtype=torch.uint8,
                               device=device)

    def put(self, val: torch.Tensor, ln: torch.Tensor, passes: int) -> None:
        """Shift ``ln`` low bits of ``val`` in (ln may be 0), then emit
        complete bytes; ``passes`` bounds the bytes one call can complete
        (pending bits stay below 8 + 8·passes)."""
        mask = (torch.ones_like(ln) << ln) - 1
        self.acc = torch.where(ln > 0, (self.acc << ln) | (val & mask),
                               self.acc)
        self.nbits = self.nbits + ln
        for _ in range(passes):
            can = self.nbits >= 8
            byte = (self.acc >> (self.nbits - 8).clamp(min=0)) & 0xFF
            ok = can & (self.pos < self.m_out)
            self.out[torch.where(ok, self.base + self.pos, self.sink)] = \
                byte.to(torch.uint8)
            self.pos = self.pos + torch.where(can, 1 + (byte == 0xFF).long(),
                                              0)
            self.nbits = self.nbits - torch.where(can, 8, 0)
        # keep only the pending bits so the accumulator never grows
        self.acc = self.acc & ((torch.ones_like(self.nbits) << self.nbits)
                               - 1)


def encode_segments_plain(qc_seg, valid_seg, comp_sched, dctab, actab, *,
                          m_out: int):
    """Plain PyTorch K4: the per-position encoder loop vectorized over
    lanes."""
    dev = qc_seg.device
    S = qc_seg.shape[0]
    B = comp_sched.shape[0]
    C = dctab.shape[0] // 12
    # schedule entries past the tables clamp to the last component, as in
    # the kernel (the sessions never produce them)
    sched = [min(max(int(c), 0), C - 1) for c in comp_sched.tolist()]
    q = qc_seg.to(torch.int64).reshape(S, B, 64)
    vmask = valid_seg.reshape(S, B) != 0
    dct = dctab.to(torch.int64)
    act = actab.to(torch.int64)
    sink = _Sink(S, m_out, dev)
    dcpred = torch.zeros((C, S), dtype=torch.int64, device=dev)
    jrows = torch.arange(1, 64, dtype=torch.int64, device=dev)
    for b in range(B):
        comp = sched[b]
        vb = vmask[:, b]
        row = q[:, b]
        dcrow = dct[comp * 12:(comp + 1) * 12]
        acrow = act[comp * 176:(comp + 1) * 176]
        zpk = int(acrow[15 * 11])
        epk = int(acrow[0])

        coef0 = row[:, 0]
        diff = torch.where(vb, coef0 - dcpred[comp], 0)
        dcpred[comp] = torch.where(vb, coef0, dcpred[comp])
        dsize = _size_category(diff.abs())
        dpk = dcrow[dsize]
        dval = ((dpk >> 5) << dsize) | _magnitude_bits(diff, dsize)
        sink.put(dval, torch.where(vb, (dpk & 31) + dsize, 0), passes=4)

        ac = row[:, 1:]
        last_nz = torch.where(ac != 0, jrows, 0).amax(dim=1)
        maxj = int(torch.where(vb, last_nz, 0).max()) if S else 0
        run = torch.zeros(S, dtype=torch.int64, device=dev)
        for j in range(1, maxj + 1):
            coef = row[:, j]
            active = vb & (j <= last_nz)
            nz = active & (coef != 0)
            run = run + (active & (coef == 0)).long()
            zfire = run == 16
            sink.put(torch.full_like(run, zpk >> 5),
                     torch.where(zfire, zpk & 31, 0), passes=0)
            run = torch.where(zfire, 0, run)
            asize = _size_category(coef.abs())
            idx = run * 11 + asize
            apk = torch.where(idx < 176, acrow[idx.clamp(max=175)], 0)
            aval = ((apk >> 5) << asize) | _magnitude_bits(coef, asize)
            sink.put(aval, torch.where(nz, (apk & 31) + asize, 0), passes=6)
            run = torch.where(nz, 0, run)
        need_eob = vb & (last_nz < 63)
        sink.put(torch.full_like(run, epk >> 5),
                 torch.where(need_eob, epk & 31, 0), passes=2)
    pad = (-sink.nbits) & 7
    sink.put((torch.ones_like(pad) << pad) - 1, pad, passes=1)
    lens = sink.pos.to(torch.int32)
    out = sink.out[:sink.sink].reshape(S, m_out)
    return out, lens, (lens > m_out).any()


def encode_segments(qc_seg: torch.Tensor, valid_seg: torch.Tensor,
                    comp_sched: torch.Tensor, dctab: torch.Tensor,
                    actab: torch.Tensor, *, m_out: int):
    """K4: qc_seg (S, B·64) int32, valid_seg (S, B) uint8, comp_sched (B,)
    int32, dctab (C·12,) / actab (C·176,) int32 packed tables →
    (out (S, m_out) uint8, lens (S,) int32, overflow 0-dim bool tensor on
    the input's device). On the card qc_seg must start on a 16-byte
    boundary (a fresh tensor does; a view may not)."""
    S = qc_seg.shape[0]
    B = comp_sched.shape[0]
    C = dctab.shape[0] // 12
    dev = qc_seg.device
    if not 1 <= C <= MAX_COMPONENTS:
        raise ValueError(f"tables must cover 1..{MAX_COMPONENTS} components")
    for name, t, dtype, shape in (
            ("qc_seg", qc_seg, torch.int32, (S, B * 64)),
            ("valid_seg", valid_seg, torch.uint8, (S, B)),
            ("comp_sched", comp_sched, torch.int32, (B,)),
            ("dctab", dctab, torch.int32, (C * 12,)),
            ("actab", actab, torch.int32, (C * 176,))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous on {dev}")
    if dev.type == "cpu":
        return encode_segments_plain(qc_seg, valid_seg, comp_sched, dctab,
                                     actab, m_out=m_out)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if qc_seg.data_ptr() % 16:
        raise ValueError("qc_seg: K4 copies 16-byte pieces; the data must "
                         "start on a 16-byte boundary")
    out = torch.zeros((S, m_out), dtype=torch.uint8, device=dev)
    lens = torch.empty(S, dtype=torch.int32, device=dev)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    kernels.launch("vct_k4_huffman_encode", qc_seg.data_ptr(),
                   valid_seg.data_ptr(), S, B, comp_sched.data_ptr(), C,
                   dctab.data_ptr(), actab.data_ptr(), m_out, out.data_ptr(),
                   lens.data_ptr(), overflow.data_ptr())
    encode_segments.launches += 1
    return out, lens, overflow[0] != 0


encode_segments.launches = 0
