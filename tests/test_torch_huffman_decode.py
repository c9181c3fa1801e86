"""The port's Huffman decode kernels (plain versions, CPU) against the
reference Pallas kernels in interpret mode: K1 with and without its
start-state hooks (decode_flat_pallas_t), K5 (decode_segments_pallas),
K6 (decode_segments_pallas_bs) and K7 (decode_flat_pallas_dma), on small
streams from the reference model encoder and on corrupt inputs
(truncated segments, random bytes, rows without guard bytes) that reach
the reads past a lane's end and the saturation. Tolerance: exact
equality."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_coding_tpu.entropy import pallas_decode, tpu_decode
from video_coding_tpu.entropy import scan as jscan
from video_coding_tpu.runtime import engine
from video_coding_tpu_torch.entropy import huffman_decode

from _torch_fixtures import encode, header_payload, synth_frame


def _lane_inputs(sub: str, q: int, seed: int):
    stream = encode(sub, synth_frame(sub, 64, 48, seed), q, 1)
    header, payload = header_payload(stream)
    dec = engine.JpegDecoderSession(header)
    flat, lens64 = jscan.destuff_flat(payload)
    segb = dec._expected_seg_blocks(len(lens64))
    return dec, dec._flat_lane_inputs(flat, lens64, segb)


def _both(dec, flat_p, starts, lens, segb, L):
    B = dec.blocks_per_segment
    C = len(dec.components)
    sched = dec.comp_idx[:B].astype(np.int32)
    tabs = tpu_decode.range_tables(dec.tables)
    ref = np.asarray(pallas_decode.decode_flat_pallas_t(
        jnp.asarray(flat_p), jnp.asarray(starts), jnp.asarray(lens),
        jnp.asarray(segb), jnp.asarray(sched), *map(jnp.asarray, tabs),
        L=L, blocks_per_segment=B, n_components=C, interpret=True))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = huffman_decode.decode_flat(
        t(flat_p), t(starts), t(lens), t(segb), t(sched), *map(t, tabs),
        blocks_per_segment=B, n_components=C).numpy()
    return got, ref


@pytest.mark.parametrize("sub,q", [("420", 75), ("444", 50)])
def test_decode_flat_matches_pallas(sub, q):
    dec, (flat_p, starts, lens, segb, _inv, L, _M) = _lane_inputs(
        sub, q, seed=5)
    got, ref = _both(dec, flat_p, starts, lens, segb, L)
    assert got.shape == ref.shape == (len(starts), dec.blocks_per_segment,
                                      64)
    np.testing.assert_array_equal(got, ref)
    assert np.abs(got).sum() > 0


def test_decode_flat_corrupt_truncated_terminates_and_matches():
    """Random bytes in place of entropy data and segments cut short:
    both decoders still terminate (step cap / zero fill past the length)
    and agree bit for bit."""
    dec, (flat_p, starts, lens, segb, _inv, L, _M) = _lane_inputs(
        "420", 75, seed=9)
    rng = np.random.default_rng(9)
    bad = flat_p.copy()
    n = int(lens.sum())
    bad[:n] = rng.integers(0, 256, n).astype(np.uint8)
    cut = (lens // 2).astype(np.int32)
    got, ref = _both(dec, bad, starts, cut, segb, L)
    np.testing.assert_array_equal(got, ref)
    assert np.abs(got).max() <= 32767


def test_decode_flat_rejects_bad_inputs():
    i32 = torch.zeros(2, dtype=torch.int32)
    tab = torch.zeros((6, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        huffman_decode.decode_flat(
            torch.zeros(8, dtype=torch.int64), i32, i32, i32,
            torch.zeros(6, dtype=torch.int32), tab, tab, tab,
            torch.zeros(128, dtype=torch.int32), blocks_per_segment=6,
            n_components=3)


# --- K1 with start-state hooks, K7 ------------------------------------------

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _indexed_inputs(sub: str, w: int, h: int, q: int, seed: int):
    """Virtual segments of a restart-free stream, as the indexed route
    cuts them: lane arrays with the start bit and DC predictors."""
    stream = encode(sub, synth_frame(sub, w, h, seed), q, 0)
    header, payload = header_payload(stream)
    dec = engine.JpegDecoderSession(header)
    flat, lens64 = jscan.destuff_flat(payload)
    assert len(lens64) == 1
    stride = dec._index_stride()
    bo, dp = jscan._index_scan_py(flat, dec.comp_idx, stride, dec.tables)
    R = len(bo)
    s64 = bo >> 3
    ends = np.append((bo[1:] + 7) >> 3, len(flat))
    segb = np.full(R, stride, np.int32)
    if dec.n_blocks % stride:
        segb[-1] = dec.n_blocks % stride
    lens = (ends - s64).astype(np.int32)
    L = 1 << max(6, int(int(lens.max()) + 4 - 1).bit_length())
    M = 1 << max(12, (len(flat) + 8 - 1).bit_length())
    flat_p = np.zeros(M, np.uint8)
    flat_p[:len(flat)] = flat
    return dec, stride, (flat_p, s64.astype(np.int32), lens, segb,
                         (bo - 8 * s64).astype(np.int32),
                         dp[:, :3].astype(np.int32), L)


def _flat_both(jfn, pfn, dec, B, flat_p, starts, lens, segb, bp0, dc0, L):
    C = len(dec.components)
    sched = dec.comp_idx[:B].astype(np.int32)
    tabs = tpu_decode.range_tables(dec.tables)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else _t(a)  # noqa: E731
    ref = None if jfn is None else np.asarray(jfn(
        j(flat_p), j(starts), j(lens), j(segb), j(sched), *map(j, tabs),
        L=L, blocks_per_segment=B, n_components=C, init_bitpos=j(bp0),
        init_dc=j(dc0), interpret=True))
    got = pfn(t(flat_p), t(starts), t(lens), t(segb), t(sched),
              *map(t, tabs), blocks_per_segment=B, n_components=C,
              init_bitpos=t(bp0), init_dc=t(dc0)).numpy()
    return got, ref


@pytest.mark.parametrize("sub,w,h,q", [("420", 128, 64, 90),
                                       ("444", 96, 64, 50)])
def test_decode_flat_hooks_match_pallas(sub, w, h, q):
    dec, stride, (flat_p, starts, lens, segb, bp0, dc0, L) = \
        _indexed_inputs(sub, w, h, q, seed=3)
    assert bp0.any() and dc0.any()
    got, ref = _flat_both(pallas_decode.decode_flat_pallas_t,
                          huffman_decode.decode_flat, dec, stride, flat_p,
                          starts, lens, segb, bp0, dc0, L)
    np.testing.assert_array_equal(got, ref)
    # the virtual segments, laid end to end, are the golden coefficients
    golden = jscan.decode_scan(
        [flat_p[:int(starts[-1] + lens[-1])].tobytes()], dec.comp_idx,
        dec.n_blocks, dec.tables, use_native=False)
    np.testing.assert_array_equal(
        got.reshape(-1, 64)[:dec.n_blocks], golden)


def test_decode_flat_hooks_corrupt_matches_pallas():
    """Random bytes, lanes cut short, large start predictors: the zero
    fill past the length and the int16 saturation are reached on both
    sides alike."""
    dec, stride, (flat_p, starts, lens, segb, bp0, dc0, L) = \
        _indexed_inputs("420", 128, 64, 75, seed=4)
    rng = np.random.default_rng(4)
    bad = flat_p.copy()
    n = int(starts[-1] + lens[-1])
    bad[:n] = rng.integers(0, 255, n).astype(np.uint8)
    dc_big = rng.integers(-40000, 40000, dc0.shape).astype(np.int32)
    got, ref = _flat_both(pallas_decode.decode_flat_pallas_t,
                          huffman_decode.decode_flat, dec, stride, bad,
                          starts, (lens // 2).astype(np.int32), segb, bp0,
                          dc_big, L)
    np.testing.assert_array_equal(got, ref)
    assert np.abs(got).max() == 32767 or got.min() == -32768


@pytest.mark.parametrize("hooks", [False, True])
def test_decode_flat_staged_matches_pallas_dma_and_k1(hooks):
    if hooks:
        dec, B, (flat_p, starts, lens, segb, bp0, dc0, L) = \
            _indexed_inputs("420", 128, 64, 75, seed=6)
    else:
        dec, (flat_p, starts, lens, segb, _inv, L, _M) = _lane_inputs(
            "420", 75, seed=6)
        B, bp0, dc0 = dec.blocks_per_segment, None, None
    assert (starts & 15).any()        # lanes start inside a 16-byte row
    got, ref = _flat_both(pallas_decode.decode_flat_pallas_dma,
                          huffman_decode.decode_flat_staged, dec, B, flat_p,
                          starts, lens, segb, bp0, dc0, L)
    np.testing.assert_array_equal(got, ref)
    k1, _ = _flat_both(None, huffman_decode.decode_flat, dec, B, flat_p,
                       starts, lens, segb, bp0, dc0, L)
    np.testing.assert_array_equal(got, k1)
    assert np.abs(got).sum() > 0


def test_decode_flat_staged_corrupt_matches_pallas_dma():
    dec, (flat_p, starts, lens, segb, _inv, L, _M) = _lane_inputs(
        "420", 75, seed=12)
    rng = np.random.default_rng(12)
    bad = rng.integers(0, 255, flat_p.size).astype(np.uint8)
    cut = (lens // 2).astype(np.int32)
    got, ref = _flat_both(pallas_decode.decode_flat_pallas_dma,
                          huffman_decode.decode_flat_staged, dec,
                          dec.blocks_per_segment, bad, starts, cut, segb,
                          None, None, L)
    np.testing.assert_array_equal(got, ref)


# --- K7's staged word source, modelled --------------------------------------

CSRC = pathlib.Path(__file__).resolve().parent.parent / \
    "video_coding_tpu_torch" / "csrc"
MASK64 = (1 << 64) - 1


def _k7_half_rows_log() -> int:
    text = (CSRC / "huffman_decode_staged.cu").read_text()
    return int(re.search(r"constexpr int kHalfRowsLog = (\d+);",
                         text).group(1))


class _StagedWordsModel:
    """K7's ``StagedWords``, step by step: a ring of two halves of
    2^kHalfRowsLog rows; a copy lands only when a wait retires its group;
    a read must find its own row landed in its slot (a stale slot or one
    still in flight fails the test). Rows outside the buffer are filled
    with its nearest byte at once."""

    def __init__(self, flat: np.ndarray, row0: int, len_eff: int):
        self.flat, self.row0, self.len_eff = flat, row0, len_eff
        self.log = _k7_half_rows_log()
        self.ring = 2 << self.log
        self.slots = {}          # slot -> [row, bytes, landed]
        self.groups = []         # pending groups of slots, oldest first
        self.issued = self.waited = -(1 << 30)
        self.halves = 0

    def _issue(self, h: int) -> None:
        group, n_rows = [], len(self.flat) // 16
        for i in range(1 << self.log):
            r = (h << self.log) + i
            if r * 16 >= self.len_eff:
                break
            row = self.row0 + r
            if 0 <= row < n_rows:
                data, landed = self.flat[row * 16:row * 16 + 16], False
                group.append(r % self.ring)
            else:
                b = self.flat[0 if row < 0 else n_rows * 16 - 1]
                data, landed = np.full(16, b, np.uint8), True
            self.slots[r % self.ring] = [r, data, landed]
        self.groups.append(group)
        self.halves += 1

    def _wait(self, n: int) -> None:
        while len(self.groups) > n:
            for slot in self.groups.pop(0):
                self.slots[slot][2] = True

    def word(self, j: int) -> int:
        q = 4 * j
        keep = self.len_eff - q
        if keep <= 0:
            return 0
        h = (q >> 4) >> self.log
        if h >= self.issued or h < self.issued - 2:
            self._wait(0)
            self._issue(h)
            self._issue(h + 1)
            self.issued = h + 2
            self._wait(1)
            self.waited = h + 1
        elif h >= self.waited:
            self._wait(0)
            self.waited = self.issued
            self._issue(self.issued)
            self.issued += 1
        row, data, landed = self.slots[(q >> 4) % self.ring]
        assert row == q >> 4 and landed, (row, q >> 4, landed)
        x = int.from_bytes(bytes(data[q & 15:(q & 15) + 4]), "big")
        return x if keep >= 4 else x & ~(0xFFFFFFFF >> (8 * keep))


class _BitWindowModel:
    """``BitWindow``: words k and k+1 in a 64-bit buffer, word k+2 asked
    for one step ahead."""

    def __init__(self, src: _StagedWordsModel):
        self.src, self.buf, self.nxt, self.k = src, 0, 0, None

    def peek16(self, p: int) -> int:
        kk = p >> 5
        if kk != self.k:
            if self.k is not None and kk == self.k + 1:
                self.buf = ((self.buf << 32) | self.nxt) & MASK64
            else:
                self.buf = (self.src.word(kk) << 32) | self.src.word(kk + 1)
            self.nxt = self.src.word(kk + 2)
            self.k = kk
        return ((self.buf << (p & 31)) & MASK64) >> 48


@pytest.mark.parametrize("hooks", [False, True])
def test_staged_word_source_model_matches_plain(hooks):
    """K7's ring and bit window, modelled, feed the symbol loop and give
    decode_flat_staged_plain's coefficients on lanes of 513 bytes and more
    (a whole restart-free frame, random bytes, one past the buffer's end),
    crossing many halves of the ring."""
    stream = encode("420", synth_frame("420", 128, 64, 9), 90, 0)
    header, payload = header_payload(stream)
    dec = engine.JpegDecoderSession(header)
    scan, _ = jscan.destuff_flat(payload)
    assert len(scan) > 1024
    rng = np.random.default_rng(9)
    flat = rng.integers(0, 256, len(scan) + 4096).astype(np.uint8)
    flat = np.concatenate([flat, np.zeros(-len(flat) % 16, np.uint8)])
    flat[5:5 + len(scan)] = scan
    S, B = 8, dec.n_blocks
    starts = np.concatenate([[5, 5], rng.integers(len(scan) + 8,
                             len(flat) - 1300, S - 3),
                             [len(flat) - 300]]).astype(np.int32)
    lens = np.concatenate([[len(scan), 700], rng.integers(513, 1200, S - 3),
                           [900]]).astype(np.int32)
    segb = np.full(S, B, np.int32)
    segb[2:] = 40
    sched = _t(dec.comp_idx[:B].astype(np.int32))
    tabs = [_t(a) for a in tpu_decode.range_tables(dec.tables)]
    bp0 = dc0 = None
    if hooks:
        bp0 = _t(rng.integers(0, 64, S).astype(np.int32))
        dc0 = _t(rng.integers(-40000, 40000, (S, 3)).astype(np.int32))
    args = (_t(flat), _t(starts), _t(lens), _t(segb), sched, *tabs)
    kw = dict(blocks_per_segment=B, n_components=3, init_bitpos=bp0,
              init_dc=dc0)
    ref = huffman_decode.decode_flat_staged_plain(*args, **kw)
    row_starts, lens_eff, bitpos = huffman_decode._staged_view(
        args[1], args[2], bp0)
    windows = [_BitWindowModel(_StagedWordsModel(flat, int(r) >> 4, int(n)))
               for r, n in zip(row_starts, lens_eff)]

    def peek16(pos):
        return torch.tensor([w.peek16(int(p)) for w, p in zip(windows, pos)],
                            dtype=torch.int64)

    got = huffman_decode._symbol_loop_plain(
        peek16, args[3], sched, *tabs, blocks_per_segment=B, n_components=3,
        saturate=True, total_cap=huffman_decode.max_steps(B), block_cap=None,
        init_bitpos=bitpos, init_dc=dc0)
    assert torch.equal(got, ref)
    half_bytes = 16 << _k7_half_rows_log()
    assert windows[0].src.halves >= len(scan) // half_bytes
    assert min(w.src.halves for w in windows) > 2
    if not hooks:    # lane 0 is the whole frame, decoded
        golden = jscan.decode_scan([scan.tobytes()], dec.comp_idx,
                                   dec.n_blocks, dec.tables,
                                   use_native=False)
        np.testing.assert_array_equal(got[0].numpy(), golden)


# --- K5 and K6 on padded lane matrices --------------------------------------

def _segment_inputs(sub: str, w: int, h: int, q: int, ri: int, seed: int):
    stream = encode(sub, synth_frame(sub, w, h, seed), q, ri)
    header, payload = header_payload(stream)
    dec = engine.JpegDecoderSession(header)
    flat, lens64 = jscan.destuff_flat(payload)
    segb = dec._expected_seg_blocks(len(lens64))
    lanebuf, _st, _lens, segb, _inv, L, _M = dec._padded_lane_inputs(
        flat, lens64, segb)
    return dec, lanebuf.reshape(-1, L), segb


def _segments_both(kind: str, dec, segbytes, segb):
    B = dec.blocks_per_segment
    C = len(dec.components)
    sched = dec.comp_idx[:B].astype(np.int32)
    tabs = tpu_decode.range_tables(dec.tables)
    kw = dict(blocks_per_segment=B, n_components=C)
    if kind == "K5":
        ref = pallas_decode.decode_segments_pallas(
            jnp.asarray(segbytes), jnp.asarray(segb), jnp.asarray(sched),
            *map(jnp.asarray, tabs), interpret=True, **kw)
        pfn = huffman_decode.decode_segments
    else:
        ref = pallas_decode.decode_segments_pallas_bs(
            jnp.asarray(segbytes), jnp.asarray(segb),
            *map(jnp.asarray, tabs), comp_sched_t=tuple(map(int, sched)),
            win=min(pallas_decode.BS_WIN, B), interpret=True, **kw)
        pfn = huffman_decode.decode_segments_streamed
    got = pfn(_t(segbytes), _t(segb), _t(sched), *map(_t, tabs), **kw)
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("sub,q,ri", [("420", 90, 1), ("422", 50, 2)])
def test_decode_segments_matches_pallas(sub, q, ri):
    dec, segbytes, segb = _segment_inputs(sub, 64, 48, q, ri, seed=7)
    got, ref = _segments_both("K5", dec, segbytes, segb)
    np.testing.assert_array_equal(got, ref)
    assert np.abs(got).sum() > 0


# ri=0: one segment of 36 blocks, two output windows of 18; ri=5: segments
# of 30 blocks in two windows and a last short segment of 12
@pytest.mark.parametrize("sub,w,h,q,ri", [("420", 48, 32, 90, 0),
                                          ("420", 64, 48, 50, 5)])
def test_decode_segments_streamed_matches_pallas(sub, w, h, q, ri):
    dec, segbytes, segb = _segment_inputs(sub, w, h, q, ri, seed=8)
    assert dec.blocks_per_segment > pallas_decode.BS_WIN
    if ri:
        assert segb.min() < dec.blocks_per_segment
    got, ref = _segments_both("K6", dec, segbytes, segb)
    np.testing.assert_array_equal(got, ref)
    assert np.abs(got).sum() > 0


# Row lengths with and without tile padding of the window array: past the
# row K5/K6 read zero windows (L=64), or the last real window again when
# the window count is already a tile multiple (K5: L-3 = 128; K6:
# (L-2)//2 = 64) — rows of random bytes without guard bytes tell the two
# apart. (The symbol caps cannot be reached by any input: every symbol
# moves a block forward, so a block takes at most 64.)
@pytest.mark.parametrize("kind,L", [("K5", 64), ("K5", 131), ("K6", 64),
                                    ("K6", 130)])
def test_decode_segments_corrupt_rows_match_pallas(kind, L):
    dec, _segbytes, _segb = _segment_inputs("420", 64, 48, 75, 5, seed=9)
    rng = np.random.default_rng(L)
    S = 5
    rows = rng.integers(0, 255, (S, L)).astype(np.uint8)
    rows[1, L // 3:] = 0                      # a truncated segment
    rows[2] = np.where(rng.random(L) < .5, 0xFE, rows[2])  # long codes
    segb = np.array([30, 30, 30, 12, 0], np.int32)
    got, ref = _segments_both(kind, dec, rows, segb)
    np.testing.assert_array_equal(got, ref)
    assert not got[4].any() and not got[3, 12:].any()


def test_saturation_differs_between_k1_and_k5():
    """The same padded rows through K1 (saturating) and K5 (not): a DC
    predictor driven past int16 is where they part."""
    dec, _segbytes, _segb = _segment_inputs("420", 64, 48, 75, 1, seed=10)
    B, C = dec.blocks_per_segment, len(dec.components)
    # DC category 11 + eleven 1 bits (+2047), then EOB, block after block,
    # in one segment of many luma blocks
    def code(lut, value):
        idx = next(i for i in range(1 << lut.max_bits)
                   if lut.lengths[i] and lut.data[i] == value)
        n = int(lut.lengths[idx])
        return format(idx >> (lut.max_bits - n), f"0{n}b")

    luma = dec.components[0]
    nblk = 20
    bits = (code(luma.dc_tab, 11) + "1" * 11 + code(luma.ac_tab, 0)) * nblk
    bits += "1" * (-len(bits) % 8)
    data = np.frombuffer(int(bits, 2).to_bytes(len(bits) // 8, "big"),
                         np.uint8)
    L = 1 << (len(data) + 4 - 1).bit_length()
    rows = np.zeros((1, L), np.uint8)
    rows[0, :len(data)] = data
    tabs = list(map(_t, tpu_decode.range_tables(dec.tables)))
    sched = torch.zeros(nblk, dtype=torch.int32)
    kw = dict(blocks_per_segment=nblk, n_components=C)
    segb = torch.tensor([nblk], dtype=torch.int32)
    k5 = huffman_decode.decode_segments(_t(rows), segb, sched, *tabs, **kw)
    k1 = huffman_decode.decode_segments_lanes(_t(rows), segb, sched, *tabs,
                                              **kw)
    assert int(k5[0, -1, 0]) == 2047 * nblk > 32767
    assert int(k1[0, -1, 0]) == 32767
    assert torch.equal(k1.clamp(-32768, 32767), k5.clamp(-32768, 32767))


# --- facts the redesigned K6 and K1 rely on ----------------------------------

def _session_tables(sub: str = "420"):
    dec, _segbytes, _segb = _segment_inputs(sub, 64, 48, 75, 5, seed=11)
    return dec, [_t(a) for a in tpu_decode.range_tables(dec.tables)]


# K6 decodes a row in parallel from states that carry no symbol count: the
# per-block cap of 134 symbols must never bind (a block ends within 64
# symbols; a failed AC match reads as EOB)
@pytest.mark.parametrize("kind", ["random", "zeros", "ones", "short"])
def test_streamed_block_cap_never_binds(kind):
    dec, tabs = _session_tables()
    rng = np.random.default_rng(21)
    S, L, B = 6, 130, 40
    rows = rng.integers(0, 256, (S, L)).astype(np.uint8)
    if kind == "zeros":
        rows[:] = 0
    elif kind == "ones":
        rows[:] = 0xFF
    elif kind == "short":
        for s in range(S):
            rows[s, rng.integers(0, L // 2):] = 0
    segb = torch.tensor([B, B, 7, 0, B, 25], dtype=torch.int32)
    sched = torch.from_numpy(np.resize(dec.comp_idx[:6], B).astype(np.int32))
    kw = dict(blocks_per_segment=B, n_components=3, saturate=False,
              total_cap=None)
    peek = huffman_decode._window_peek(_t(rows), 2, 8)
    capped = huffman_decode._symbol_loop_plain(
        peek, segb, sched, *tabs, block_cap=huffman_decode.BLOCK_STEPS, **kw)
    free = huffman_decode._symbol_loop_plain(peek, segb, sched, *tabs,
                                             block_cap=None, **kw)
    assert torch.equal(capped, free)


def _match_np(lo, hi, off, values, t: int, w: np.ndarray):
    """The range match, written out again in numpy: (code_len, data) of
    every window in ``w`` against table row t."""
    code_len = np.zeros(w.shape, np.int64)
    lo_sel = np.zeros(w.shape, np.int64)
    off_sel = np.zeros(w.shape, np.int64)
    for l in range(16):
        hit = (w >= lo[t, l]) & (w < hi[t, l])
        code_len += np.where(hit, l + 1, 0)
        lo_sel += np.where(hit, lo[t, l], 0)
        off_sel += np.where(hit, off[t, l], 0)
    idx = off_sel + ((w - lo_sel) >> (16 - np.clip(code_len, 1, 16)))
    data = values[np.clip(idx, 0, len(values) - 1)] & 0xFF
    return code_len, np.where(code_len > 0, data, 0)


def _malformed_tables(seed: int):
    """Range tables no DHT produces: overlapping and inverted ranges,
    negative and out-of-range offsets."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << 16, (6, 16)).astype(np.int32)
    hi = (lo + rng.integers(-500, 9000, (6, 16))).astype(np.int32)
    off = rng.integers(-50, 400, (6, 16)).astype(np.int32)
    values = rng.integers(0, 1000, 384).astype(np.int32)
    lo[0] = 0
    hi[0] = 1 << 16                         # every length matches: len 136
    return [_t(a) for a in (lo, hi, off, values)]


@pytest.mark.parametrize("tables", ["420", "444", "malformed1",
                                    "malformed2"])
def test_decode_lut_agrees_with_match_on_every_window(tables):
    if tables.startswith("malformed"):
        tabs = _malformed_tables(int(tables[-1]))
    else:
        tabs = _session_tables(tables)[1]
    lut = huffman_decode.decode_lut(*tabs).numpy().astype(np.int64) & 0xFFFF
    bits = huffman_decode.LUT_BITS
    span = 1 << (16 - bits)
    lo, hi, off, values = (a.numpy().astype(np.int64) for a in tabs)
    T = lo.shape[0]
    level1 = lut[:T << bits]
    pool = lut[T << bits:].reshape(huffman_decode.LUT_POOL, span)
    w = np.arange(1 << 16, dtype=np.int64)
    res = np.concatenate([
        np.stack(_match_np(lo, hi, off, values, t, w)) for t in range(T)],
        axis=1)
    res = ((res[0] << 8) | res[1]).reshape(T << bits, span)
    uniform = (res == res[:, :1]).all(1) & (res[:, 0] >> 8 <= 16)
    # level 1 holds every window's match where the prefix's windows agree
    # (and the code is at most 16 bits long) ...
    np.testing.assert_array_equal(level1[uniform], res[uniform, 0])
    # ... elsewhere the prefixes, in order, take level-2 blocks that hold
    # each window's match, and the range match once the blocks run out
    marked = np.flatnonzero(~uniform)
    n_pool = min(len(marked), huffman_decode.LUT_POOL)
    np.testing.assert_array_equal(
        level1[marked[:n_pool]], huffman_decode.LUT_POOLED + np.arange(n_pool))
    np.testing.assert_array_equal(pool[:n_pool], res[marked[:n_pool]])
    assert not pool[n_pool:].any()
    assert (level1[marked[n_pool:]] == huffman_decode.LUT_FALLBACK).all()
    if tables.startswith("malformed"):
        # row 0 matches all 16 lengths: 136-bit codes at every window
        assert len(marked) > huffman_decode.LUT_POOL
    else:
        # canonical codes: a few prefixes of codes longer than LUT_BITS,
        # all in level-2 blocks
        assert 0 < len(marked) <= huffman_decode.LUT_POOL


# --- K5's word source and values, modelled -----------------------------------

def _k5_constant(name: str) -> int:
    text = (CSRC / "huffman_decode_padded.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _k5_lanes() -> int:
    """Rows a K5 CTA decodes (and stages)."""
    return _k5_constant("kWarps") * _k5_constant("kLanesPerWarp")


class _PaddedWordsModel:
    """K5's ``PaddedWords``: word j of row s is the aligned word of memory
    at seg[4·(w0 + j) - mis], w0 = (s·L + mis) // 4, for a matrix whose
    first byte lies mis bytes past a word boundary; bytes outside the
    matrix read as zero. ``staged``: the CTA that holds row s has copied
    the words of its rows, and a word past them reads as zero."""

    def __init__(self, seg: np.ndarray, s: int, mis: int, staged: bool):
        S, L = seg.shape
        self.flat, self.mis = seg.reshape(-1), mis
        self.w0 = (s * L + mis) >> 2
        self.last = None
        if staged:
            n = _k5_lanes()
            end = min((s // n + 1) * n, S) * L
            self.last = (end - 1 + mis) >> 2

    def word(self, j: int) -> int:
        if self.last is not None and self.w0 + j > self.last:
            return 0
        a = 4 * (self.w0 + j) - self.mis
        return int.from_bytes(bytes(
            int(self.flat[a + i]) if 0 <= a + i < self.flat.size else 0
            for i in range(4)), "big")


class _PaddedReaderModel:
    """K5's ``PaddedReader``: below bit 8·(L - 3) the row's bits through
    the bit window, past it the last window (bytes L-4..L-1) at offset
    p % 8 when L - 3 is a multiple of kWindowTile, else zero."""

    def __init__(self, seg: np.ndarray, s: int, mis: int,
                 staged: bool = False):
        L = seg.shape[1]
        self.win = _BitWindowModel(_PaddedWordsModel(seg, s, mis, staged))
        self.off0 = 8 * ((s * L + mis) & 3)
        self.tail_lim = 8 * (L - 3)
        self.tail = int.from_bytes(bytes(seg[s, L - 4:]), "big") \
            if (L - 3) % _k5_constant("kWindowTile") == 0 else 0

    def peek16(self, p: int) -> int:
        if p >= self.tail_lim:
            return (self.tail >> (16 - (p & 7))) & 0xFFFF
        return self.win.peek16(self.off0 + p)


# L % 4 != 0 (67, 131, 259), window counts that are a tile multiple (131,
# 259) and not (64, 67, 2048), every misalignment of the matrix, and rows
# read from global memory or from a CTA's staged copy (the last row of a
# CTA among them)
@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("L", [64, 67, 131, 259, 2048])
def test_padded_reader_model_matches_plain_peek(L, staged):
    rng = np.random.default_rng(L)
    n = _k5_lanes()
    rows = [0, n - 1, n, n + 1] if staged else [0, 1, 2]
    S = rows[-1] + 1
    seg = rng.integers(0, 256, (S, L)).astype(np.uint8)
    peek = huffman_decode._window_peek(_t(seg), 1,
                                       _k5_constant("kWindowTile"))
    # every bit of the row and past it, then peeks far past the row
    pos = np.concatenate([np.arange(8 * L + 300),
                          8 * L + rng.integers(300, 1 << 20, 200)])
    for mis in range(4):
        readers = [_PaddedReaderModel(seg, s, mis, staged) for s in rows]
        for p in pos:
            want = peek(torch.full((S,), int(p), dtype=torch.int64))
            got = [r.peek16(int(p)) for r in readers]
            assert got == want[rows].tolist(), (mis, int(p))


@pytest.mark.parametrize("L,luma_only", [(64, True), (131, False)])
def test_padded_reader_model_decodes_as_plain(L, luma_only):
    """The reader model feeds the symbol loop (values unsaturated) and
    gives decode_segments_plain's coefficients on chip_smoke.k5_rows, with
    a luma-only schedule (the DC ramp row passes int16) and a 4:2:0 one."""
    from chip_smoke import k5_rows

    dec, tabs = _session_tables()
    rng = np.random.default_rng(L + 1)
    S, B = 12, 30
    rows = k5_rows(dec, S, L, B, rng)
    segb = _t(np.array([B] * 8 + [12, 0, 1, B], np.int32))
    sched = np.zeros(B) if luma_only else np.resize(dec.comp_idx[:6], B)
    sched = _t(sched.astype(np.int32))
    kw = dict(blocks_per_segment=B, n_components=3)
    ref = huffman_decode.decode_segments_plain(_t(rows), segb, sched, *tabs,
                                               **kw)
    readers = [_PaddedReaderModel(rows, s, 1, staged=True)
               for s in range(S)]

    def peek16(pos):
        return torch.tensor([r.peek16(int(p)) for r, p in zip(readers, pos)],
                            dtype=torch.int64)

    got = huffman_decode._symbol_loop_plain(
        peek16, segb, sched, *tabs, saturate=False,
        total_cap=huffman_decode.max_steps(B), block_cap=None, **kw)
    assert torch.equal(got, ref)
    if luma_only:
        assert int(ref[6, :, 0].max()) > 32767        # the DC ramp row


class _RowStagedWordsModel(_PaddedWordsModel):
    """The word source of K5's "row" regime: the CTA of row s has copied
    the 16-byte chunks of memory from the boundary at or below the row's
    first byte up to its last byte (bytes outside the matrix as zero), and
    a word past them reads as zero. The matrix's first byte lies base16
    bytes past a 16-byte boundary."""

    def __init__(self, seg: np.ndarray, s: int, base16: int):
        super().__init__(seg, s, base16 & 3, staged=False)
        L = seg.shape[1]
        a0 = base16 + s * L
        g0 = a0 & ~15
        self.n_chunks = (a0 + L - g0 + 15) // 16
        first = (g0 - (base16 - (base16 & 3))) >> 2
        self.last = first + 4 * self.n_chunks - 1


def _row_stage_bytes(L: int) -> int:
    """Shared-memory bytes K5's "row" regime keeps for a staged row."""
    text = (CSRC / "huffman_decode_padded.cu").read_text()
    assert "return (long long)(L + 30) / 16 * 16;" in text
    return (L + 30) // 16 * 16


# every 16-byte alignment of the matrix, L % 16 != 0 (67, 131, 259, 4099)
# and tile-multiple window counts (131, 259), the last row of the matrix
@pytest.mark.parametrize("L", [64, 67, 131, 259, 2048, 4099])
def test_row_staged_reader_model_matches_plain_peek(L):
    rng = np.random.default_rng(L + 7)
    S = 3
    seg = rng.integers(0, 256, (S, L)).astype(np.uint8)
    peek = huffman_decode._window_peek(_t(seg), 1,
                                       _k5_constant("kWindowTile"))
    pos = np.concatenate([np.arange(8 * L + 300),
                          8 * L + rng.integers(300, 1 << 20, 100)])
    want = [peek(torch.full((S,), int(p), dtype=torch.int64)).tolist()
            for p in pos]
    for base16 in range(16):
        readers = []
        for s in range(S):
            rd = _PaddedReaderModel(seg, s, base16 & 3)
            words = _RowStagedWordsModel(seg, s, base16)
            assert 16 * words.n_chunks <= _row_stage_bytes(L)
            rd.win = _BitWindowModel(words)
            readers.append(rd)
        for p, w in zip(pos, want):
            assert [r.peek16(int(p)) for r in readers] == w, (base16, int(p))


# --- K5's regime ------------------------------------------------------------

# the benchmark cell's lanes: 272 two-MCU-row segments of a 4K frame
CELL_SHAPE = (272, 32768, 2880)
# one 1080p frame at a restart every MCU (paths A, F, H; K5's phase 7 row)
# and 16 of them a dispatch, at the lane buckets such segments take
SHORT_1080P = [(S, L, 6) for S in (8160, 16 * 8160)
               for L in (32, 64, 128, 256, 512, 1024)]


def test_k5_regime_row_at_the_cell_shape():
    assert huffman_decode.k5_regime(*CELL_SHAPE) == "row"


@pytest.mark.parametrize("S,L,B", SHORT_1080P)
def test_k5_regime_lane_on_short_1080p_lanes(S, L, B):
    assert huffman_decode.k5_regime(S, L, B) == "lane"


@pytest.mark.parametrize("S", [1, 16, 272, 1024, 1088, 2048, 4096])
@pytest.mark.parametrize("B", [6, 240, 2880])
def test_k5_regime_boundary_in_L(S, B):
    """"row" from max(K5_ROW_MIN_BYTES, S * K5_ROW_BYTES_PER_ROW) bytes on,
    "lane" below it, at S up to K5_ROW_MAX_ROWS and any B."""
    edge = max(huffman_decode.K5_ROW_MIN_BYTES,
               S * huffman_decode.K5_ROW_BYTES_PER_ROW)
    assert huffman_decode.k5_regime(S, edge - 1, B) == "lane"
    assert huffman_decode.k5_regime(S, edge, B) == "row"
    assert huffman_decode.k5_regime(S, (1 << 28) - 1, B) == "row"
    # blocks a row past the row regime's 24-bit place in the schedule
    assert huffman_decode.k5_regime(S, edge, 1 << 24) == "lane"


@pytest.mark.parametrize("L", [4096, 8192, 32768, 262144])
@pytest.mark.parametrize("B", [6, 2880])
def test_k5_regime_boundary_in_S(L, B):
    """"lane" past min(L // K5_ROW_BYTES_PER_ROW, K5_ROW_MAX_ROWS) rows,
    where the "lane" regime's serial chains beat a wave of CTAs a row;
    "row" up to it; "lane" at 8,160 rows (one 1080p frame at ri = 1)."""
    edge = min(L // huffman_decode.K5_ROW_BYTES_PER_ROW,
               huffman_decode.K5_ROW_MAX_ROWS)
    assert huffman_decode.k5_regime(edge, L, B) == "row"
    assert huffman_decode.k5_regime(edge + 1, L, B) == "lane"
    assert huffman_decode.k5_regime(8160, L, B) == "lane"


def test_k5_regime_reads_the_shape_only(monkeypatch):
    """The regime is a function of (S, L, B): the same for the same shape
    whatever the environment or the row regime's subsequence length."""
    import inspect

    assert list(inspect.signature(huffman_decode.k5_regime).parameters) == \
        ["S", "L", "blocks_per_segment"]
    shapes = [CELL_SHAPE, *SHORT_1080P, (16, 4096, 240), (2, 262144, 1440)]
    before = [huffman_decode.k5_regime(*x) for x in shapes]
    monkeypatch.setattr(huffman_decode, "PADDED_ROW_SUB_BITS", 64)
    monkeypatch.setenv("VCT_K5_REGIME", "lane")
    assert [huffman_decode.k5_regime(*x) for x in shapes] == before
    assert set(before) == set(huffman_decode.K5_REGIMES)


def _c_entry_params(name: str) -> list[str]:
    """The parameter types of a C entry point of csrc/, as ctypes would
    pass them: "P" a pointer, "I" an int, "L" a long long."""
    for src in sorted(CSRC.glob("*.cu")):
        m = re.search(rf'extern "C" int {name}\((.*?)\)', src.read_text(),
                      re.S)
        if m:
            break
    else:
        raise AssertionError(f"{name}: no C entry in csrc/")
    kinds = []
    for param in m.group(1).split(","):
        param = " ".join(param.split())
        kinds.append("P" if "*" in param else
                     "L" if param.startswith("long long") else "I")
    return kinds


@pytest.mark.parametrize("name", sorted(__import__(
    "video_coding_tpu_torch.kernels", fromlist=["_SIGNATURES"])._SIGNATURES))
def test_kernel_signature_matches_its_c_entry(name):
    """kernels._SIGNATURES gives each C entry point its arity and types
    (bool parameters are ints, the last the stream pointer)."""
    import ctypes

    from video_coding_tpu_torch import kernels

    names = {ctypes.c_void_p: "P", ctypes.c_int: "I",
             ctypes.c_longlong: "L"}
    assert [names[t] for t in kernels._SIGNATURES[name]] == \
        _c_entry_params(name)


def test_unsaturated_dc_matches_pallas():
    """A luma DC that climbs by 2047 a block passes int16 in K5's plain
    version and the Pallas kernel alike; K1 saturates it."""
    from chip_smoke import dc_ramp_blocks

    dec, _segbytes, _segb = _segment_inputs("420", 64, 48, 75, 1, seed=13)
    B, C = 24, len(dec.components)
    data = dc_ramp_blocks(dec, B)
    rows = np.zeros((2, 131), np.uint8)
    rows[0, :len(data)] = data
    rows[1, :len(data) // 2] = data[:len(data) // 2]
    segb = np.array([B, B], np.int32)
    sched = np.zeros(B, np.int32)
    tabs = tpu_decode.range_tables(dec.tables)
    kw = dict(blocks_per_segment=B, n_components=C)
    ref = np.asarray(pallas_decode.decode_segments_pallas(
        jnp.asarray(rows), jnp.asarray(segb), jnp.asarray(sched),
        *map(jnp.asarray, tabs), interpret=True, **kw))
    got = huffman_decode.decode_segments(_t(rows), _t(segb), _t(sched),
                                         *map(_t, tabs), **kw).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[0, -1, 0] == 2047 * B > 32767
    k1 = huffman_decode.decode_segments_lanes(
        _t(rows), _t(segb), _t(sched), *map(_t, tabs), **kw).numpy()
    assert k1[0, -1, 0] == 32767
