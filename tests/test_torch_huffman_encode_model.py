"""A numpy model of K4's warp encoder (csrc/huffman_encode.cu), step for
step: a warp runs kSegs segments side by side, kGroup lanes each, block by
block. Per block, the lanes of a segment place its symbols in segment
order from the block's nonzero mask (DC against the component's
predictor, each nonzero AC coefficient with its run, EOB when coefficient
63 is zero) in the segment's ring; whenever a segment holds kGroup
symbols, each segment codes up to kGroup of them, one a lane (the ZRL
prefix, size 11 saturation and its table-index quirk), one scan gives
the bit offsets, the bits are ORed into the segment's word buffer, and a
full buffer and the segment's end are stuffed word by word. Held on the
adversarial blocks of ``chip_smoke.k4_blocks`` against the plain version,
and against the JAX fused encoder (Pallas in interpret mode). Tolerance:
exact equality of bytes, lengths and the overflow flag."""

import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import k4_segments, k4_tables
from video_coding_tpu.entropy import pallas_encode
from video_coding_tpu_torch.entropy import huffman_encode
from video_coding_tpu_torch.model.header import Parameters
from video_coding_tpu_torch.runtime.engine import JpegEncoderSession

SOURCE = (pathlib.Path(__file__).resolve().parent.parent
          / "video_coding_tpu_torch" / "csrc" / "huffman_encode.cu").read_text()
MASK64 = (1 << 64) - 1


def _constant(name: str) -> int:
    """A constexpr int of the kernel source (a sum of products)."""
    expr = re.search(rf"constexpr int {name} = ([0-9 *+]+);", SOURCE).group(1)
    return sum(math.prod(int(f) for f in term.split("*"))
               for term in expr.split("+"))


BUF_WORDS = _constant("kBufWords")
MAX_PASS_BITS = _constant("kMaxPassBits")
RING = _constant("kRing")
GROUP = _constant("kGroup")
SEGS = 32 // GROUP
AC, DC, EOB = range(3)


def _coded(pk: int, v: int, size: int):
    mag = (v if v >= 0 else v - 1) & ((1 << size) - 1)
    return ((pk & 0xFFFFFFFF) >> 5 << size) | mag, (pk & 31) + size


class _Warp:
    """One segment's state in its warp: the ring of symbols, the shared
    word buffer, the bit offset in it and the byte cursor in the output
    slot."""

    def __init__(self, dst: np.ndarray, m_out: int):
        self.ring = []
        self.buf = [0] * BUF_WORDS
        self.bitpos = 0
        self.outpos = 0
        self.dst, self.m_out = dst, m_out

    def put(self, off: int, val: int, ln: int) -> None:
        if ln <= 0:
            return
        x = (val << (64 - ln)) & MASK64
        hi, lo = x >> 32, x & 0xFFFFFFFF
        w, s = off >> 5, off & 31
        self.buf[w] |= hi >> s
        if s + ln > 32:
            self.buf[w + 1] |= ((((hi << 32) | lo) >> s) & 0xFFFFFFFF)
        if s + ln > 64:
            self.buf[w + 2] |= (lo << (32 - s)) & 0xFFFFFFFF

    def flush(self) -> None:
        nbytes = self.bitpos >> 3
        nwords = (self.bitpos + 31) >> 5
        tail = self.buf[nbytes >> 2] if nbytes >> 2 < BUF_WORDS else 0
        for w0 in range(0, nwords, GROUP):
            words = [self.buf[i] if i < nwords else 0
                     for i in range(w0, w0 + GROUP)]
            nb = [min(max(nbytes - 4 * i, 0), 4)
                  for i in range(w0, w0 + GROUP)]
            data = [[(w >> (24 - 8 * k)) & 0xFF for k in range(n)]
                    for w, n in zip(words, nb)]
            count = [len(d) + d.count(0xFF) for d in data]
            starts = self.outpos + np.cumsum([0] + count)[:-1]
            for p, d in zip(starts, data):
                for byte in d:
                    if p < self.m_out:
                        self.dst[p] = byte
                    p += 1 + (byte == 0xFF)
            self.outpos += sum(count)
        for i in range(nwords):
            self.buf[i] = 0
        self.buf[0] = (tail << (8 * (nbytes & 3))) & 0xFF000000
        self.bitpos &= 7


def _code_pass(warp: _Warp, dctab, actab) -> None:
    """Code up to kGroup of the segment's oldest symbols, one a lane."""
    if warp.bitpos > 32 * BUF_WORDS - MAX_PASS_BITS:
        warp.flush()
    symbols, warp.ring = warp.ring[:GROUP], warp.ring[GROUP:]
    coded = []
    for v, kind, run, comp in symbols:
        acrow = actab[comp * 176:(comp + 1) * 176]
        size = 0 if kind == EOB else min(abs(v).bit_length(), 11)
        idx = (run & 15) * 11 + size if kind == AC else 0
        pk = int(dctab[comp * 12 + size]) if kind == DC else \
            int(acrow[idx]) if idx < 176 else 0
        zpk = int(acrow[15 * 11]) if kind == AC else 0
        nzrl = run >> 4 if kind == AC else 0
        coded.append((*_coded(pk, v, size), nzrl, zpk))
    bits = [ln + nzrl * (zpk & 31) for _, ln, nzrl, zpk in coded]
    offsets = warp.bitpos + np.cumsum([0] + bits)[:-1]
    for off, (val, ln, nzrl, zpk) in zip(offsets, coded):
        off = int(off)
        for _ in range(nzrl):
            warp.put(off, zpk >> 5, zpk & 31)
            off += zpk & 31
        warp.put(off, val, ln)
    warp.bitpos += sum(bits)


def _block_symbols(blk, pred, comp):
    """The block's symbols in segment order, placed as the lanes place
    them: lane l holds positions l + kGroup * r, and a symbol's place is
    the popcount of the nonzero mask below it."""
    mask = 1                      # the DC counts as nonzero
    for r in range(64 // GROUP):
        for lane in range(GROUP):
            if blk[lane + GROUP * r]:
                mask |= 1 << (lane + GROUP * r)
    n = bin(mask).count("1")
    slots = [None] * (n + (not mask >> 63))
    slots[0] = (blk[0] - pred[comp], DC, 0, comp)
    pred[comp] = blk[0]
    for lane in range(GROUP):
        for r in range(64 // GROUP):
            j = lane + GROUP * r
            if j > 0 and blk[j]:
                prev = mask & ((1 << j) - 1)
                slots[bin(prev).count("1")] = (
                    blk[j], AC, j - 1 - (prev.bit_length() - 1), comp)
    if not mask >> 63:
        slots[n] = (0, EOB, 0, comp)
    assert None not in slots
    return slots


def model_encode(qc_seg, valid, sched, dctab, actab, m_out):
    """K4 on numpy inputs, as the warps run it: (out, lens, overflow)."""
    S, B = valid.shape
    C = len(dctab) // 12
    out = np.zeros((S, m_out), np.uint8)
    lens = np.zeros(S, np.int32)
    for first in range(0, S, SEGS):
        segs = range(first, min(first + SEGS, S))
        warps = [_Warp(out[s], m_out) for s in segs]
        preds = [[0] * 4 for _ in segs]
        for b in range(B):
            comp = min(max(int(sched[b]), 0), C - 1)
            for s, warp, pred in zip(segs, warps, preds):
                if valid[s, b]:
                    warp.ring += _block_symbols(
                        [int(v) for v in qc_seg[s, b * 64:(b + 1) * 64]],
                        pred, comp)
                    assert len(warp.ring) <= RING
            while any(len(w.ring) >= GROUP for w in warps):
                for w in warps:
                    _code_pass(w, dctab, actab)
        while any(w.ring for w in warps):
            for w in warps:
                _code_pass(w, dctab, actab)
        for s, warp in zip(segs, warps):
            pad = -warp.bitpos & 7
            warp.put(warp.bitpos, (1 << pad) - 1, pad)
            warp.bitpos += pad
            warp.flush()
            lens[s] = warp.outpos
    return out, lens, bool((lens > m_out).any())


def _tables(C: int):
    st = JpegEncoderSession(Parameters.c420(64, 48, 75), 1, device="cpu") \
        .state
    return tuple(t.numpy() for t in k4_tables(st.dctab, st.actab, C))


def _plain(qc, valid, sched, dctab, actab, m_out):
    out, lens, ovf = huffman_encode.encode_segments_plain(
        *map(torch.from_numpy, (qc, valid, sched, dctab, actab)),
        m_out=m_out)
    return out.numpy(), lens.numpy(), bool(ovf)


# (S, B, C): single block, the main path's B = 6, the Pallas kernel's
# 32-block cap and path E's 48 blocks, lane counts on both sides of a warp
CASES = [(1, 1, 1), (31, 6, 3), (33, 6, 4), (33, 32, 3), (31, 48, 3)]


@pytest.mark.parametrize("S,B,C", CASES)
def test_model_matches_plain_on_adversarial_blocks(S, B, C):
    """m_out one below, at and one above the longest segment's stuffed
    length: truncation, lengths that count past m_out, and overflow."""
    rng = np.random.default_rng(S * 100 + B)
    qc, valid, sched = k4_segments(S, B, C, rng)
    dctab, actab = _tables(C)
    longest = int(_plain(qc, valid, sched, dctab, actab, 1)[1].max())
    for m_out in (longest - 1, longest, longest + 1):
        got = model_encode(qc, valid, sched, dctab, actab, m_out)
        ref = _plain(qc, valid, sched, dctab, actab, m_out)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == ref[2] == (m_out < longest)


def test_adversarial_blocks_stuff_and_fill_the_buffer():
    """The case set reaches what it is there for: many stuffed 0xFF
    bytes, and segments long enough to flush the bit buffer mid-way."""
    qc, valid, sched = k4_segments(31, 48, 3, np.random.default_rng(0))
    dctab, actab = _tables(3)
    out, lens, _ = _plain(qc, valid, sched, dctab, actab, 1)
    out, lens, _ = _plain(qc, valid, sched, dctab, actab, int(lens.max()))
    pairs = int(((out[:, :-1] == 0xFF) & (out[:, 1:] == 0)).sum())
    assert pairs > 1000
    assert int(lens.max()) * 8 > 32 * BUF_WORDS


@pytest.mark.parametrize("S,B,C", [(31, 6, 3), (33, 6, 4)])
def test_model_matches_pallas_fused(S, B, C):
    """The model against the reference's fused Pallas encoder (interpret
    mode) on the adversarial blocks, with a schedule inside the tables
    (the Pallas kernel does not clamp)."""
    rng = np.random.default_rng(S + B)
    qc, valid, sched = k4_segments(S, B, C, rng, clamp=False)
    dctab, actab = _tables(C)
    longest = int(_plain(qc, valid, sched, dctab, actab, 1)[1].max())
    for m_out in (longest - 1, longest + 1):
        out, lens, ovf = pallas_encode.encode_segments_fused(
            jnp.asarray(qc), jnp.asarray(valid.astype(np.int32)),
            jnp.asarray(dctab.reshape(-1, 1)),
            jnp.asarray(actab.reshape(-1, 1)),
            comp_sched=tuple(int(c) for c in sched), m_out=m_out,
            interpret=True)
        got = model_encode(qc, valid, sched, dctab, actab, m_out)
        np.testing.assert_array_equal(got[0], np.asarray(out))
        np.testing.assert_array_equal(got[1], np.asarray(lens))
        assert got[2] == bool(ovf)
