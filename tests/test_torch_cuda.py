"""K1-K9 CUDA kernels against their plain versions on the card, and the
transcode (device and host routes), the decode routes (device and
host-entropy, resync included) and the encoder's packer routes on the
card against the same sessions on the CPU. Marked
``cuda``: they skip without a GPU (run them on one with
``python -m pytest -m cuda tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from video_coding_tpu_torch.common.bitstream import BitReader
from video_coding_tpu_torch.entropy import (huffman_decode, huffman_encode,
                                            pack_stuff)
from video_coding_tpu_torch.entropy.scan import destuff_dispatch
from video_coding_tpu_torch.model.header import Header, Parameters
from video_coding_tpu_torch.ops import datapath, lookup
from video_coding_tpu_torch.runtime import engine
from video_coding_tpu_torch.runtime.engine import (JpegDecoderSession,
                                                   JpegEncoderSession,
                                                   JpegTranscodeSession)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _streams(gpu, n=3, w=256, h=128, ri=1):
    rng = np.random.default_rng(0)
    frames = [(rng.integers(0, 256, (h, w), dtype=np.uint8),
               rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
               rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
              for _ in range(n)]
    enc = JpegEncoderSession(Parameters.c420(w, h, 80), ri, device=gpu)
    streams = enc.encode_device_batch(frames)
    bits = BitReader(streams[0])
    header = Header.decode(bits)
    return header, [s[bits.bit_pos >> 3:] for s in streams]


def test_kernels_match_plain_versions(gpu):
    header, payloads = _streams(gpu)
    t = JpegTranscodeSession(header, quality=75, restart_interval=1,
                             device=gpu)
    dec, enc = t.decoder, t.encoder
    d = destuff_dispatch(payloads, dec.n_segments)
    plan = dec._segment_plan(d)
    args = [torch.from_numpy(a).to(gpu)
            for a in (d.flat, plan.starts, plan.lens, plan.blocks)]
    st = dec.state
    kw = dict(blocks_per_segment=dec.blocks_per_segment,
              n_components=len(dec.components))
    k1 = (*args, dec._comp_sched, st.lo, st.hi, st.offset, st.values)
    coefs = huffman_decode.decode_flat(*k1, **kw)
    assert torch.equal(coefs, huffman_decode.decode_flat_plain(*k1, **kw))
    pool = coefs.view(-1, 64)
    px = datapath.decode_datapath(pool, dec._quant_seg)
    assert torch.equal(px, datapath.decode_datapath_plain(pool,
                                                          dec._quant_seg))
    qc = datapath.encode_datapath(px, enc.state.quant[:6].contiguous())
    assert torch.equal(qc, datapath.encode_datapath_plain(
        px, enc.state.quant[:6].contiguous()))
    qc_seg = qc.view(-1, enc.blocks_per_segment * 64)
    valid = torch.ones((qc_seg.shape[0], enc.blocks_per_segment),
                       dtype=torch.uint8, device=gpu)
    for m_out in (40, 400):       # overflowing and fitting budgets
        k4 = (qc_seg, valid, enc._comp_sched, enc.state.dctab,
              enc.state.actab)
        got = huffman_encode.encode_segments(*k4, m_out=m_out)
        ref = huffman_encode.encode_segments_plain(*k4, m_out=m_out)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


def test_transcode_on_card_matches_cpu(gpu):
    header, payloads = _streams(gpu)
    outs = JpegTranscodeSession(header, 70, 2, device=gpu) \
        .transcode_batch(payloads)
    ref = JpegTranscodeSession(header, 70, 2, device="cpu") \
        .transcode_batch(payloads)
    assert outs == ref


class _Spy:
    """Stands in for a kernel wrapper in its module: keeps every call's
    arguments and result, and passes attribute reads and writes (the
    launch count) through to the wrapper."""

    def __init__(self, fn):
        object.__setattr__(self, "fn", fn)
        object.__setattr__(self, "calls", [])

    def __call__(self, *a, **k):
        out = self.fn(*a, **k)
        self.calls.append((a, k, out))
        return out

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __setattr__(self, name, value):
        setattr(self.fn, name, value)


# route → (restart interval of the source, session keywords, the wrapper
# the route must launch, frames a call)
ROUTES = {
    "A indexed, K1 with hooks": (0, {}, "decode_flat", 3),
    "A indexed, K7 with hooks": (0, {"decode_gather": "dma"},
                                 "decode_flat_staged", 3),
    "B long segments, K6": (16, {}, "decode_segments_streamed", 3),
    "C padded single frame, K5": (1, {"device_huffman": "pallas"},
                                  "decode_segments", 1),
    "D flat batch, K7": (1, {"decode_gather": "dma"}, "decode_flat_staged",
                         3),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_decode_routes_on_card(gpu, monkeypatch, route):
    """Each route launches its kernel, the kernel equals its plain version
    on the arguments the session gave it, and the planes equal the same
    session's on the CPU."""
    ri, kw, name, n = ROUTES[route]
    header, payloads = _streams(gpu, ri=ri)
    payloads = payloads[:n]
    if name == "decode_segments_streamed":
        # 24 lanes of 96 blocks: the shape rule keeps K6 for more and longer
        monkeypatch.setattr(huffman_decode, "auto_strategy",
                            lambda S, L, B: "streamed")
    wrapper = getattr(huffman_decode, name)
    spy = _Spy(wrapper)
    monkeypatch.setattr(huffman_decode, name, spy)
    before = wrapper.launches
    got = JpegDecoderSession(header, device=gpu, **kw) \
        .decode_device_batch_stacked(payloads)
    assert wrapper.launches == before + 1 and len(spy.calls) == 1
    a, k, out = spy.calls[0]
    assert torch.equal(out, getattr(huffman_decode, name + "_plain")(*a, **k))
    if "hooks" in route:
        assert k["init_bitpos"] is not None and k["init_dc"] is not None
    ref = JpegDecoderSession(header, device="cpu", **kw) \
        .decode_device_batch_stacked(payloads)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


def _tables(gpu):
    header, _ = _streams(gpu, n=1)
    dec = JpegDecoderSession(header, device=gpu)
    st = dec.state
    return dec, (st.lo, st.hi, st.offset, st.values)


@pytest.mark.parametrize("kind,L", [("K5", 64), ("K5", 131), ("K5", 2048),
                                    ("K6", 64), ("K6", 130), ("K6", 2048)])
def test_padded_kernels_on_corrupt_rows(gpu, kind, L):
    """Random rows without guard bytes (reads past the row), at row lengths
    with and without tile padding of the window array, staged through
    shared memory (K5, L % 4 == 0 and short) and not."""
    dec, tabs = _tables(gpu)
    rng = np.random.default_rng(L)
    S, B = 300, 30
    rows = rng.integers(0, 255, (S, L)).astype(np.uint8)
    rows[::3, L // 3:] = 0
    segb = rng.integers(0, B + 1, S).astype(np.int32)
    sched = torch.from_numpy(np.resize(dec.comp_idx[:6], B)).to(gpu)
    args = (torch.from_numpy(rows).to(gpu), torch.from_numpy(segb).to(gpu),
            sched, *tabs)
    kw = dict(blocks_per_segment=B, n_components=3)
    fn, plain = {
        "K5": (huffman_decode.decode_segments,
               huffman_decode.decode_segments_plain),
        "K6": (huffman_decode.decode_segments_streamed,
               huffman_decode.decode_segments_streamed_plain)}[kind]
    assert torch.equal(fn(*args, **kw), plain(*args, **kw))


@pytest.mark.parametrize("B", [6, 30])
@pytest.mark.parametrize("malformed", [False, True])
@pytest.mark.parametrize("L", [64, 131, 2048])
def test_padded_kernel_on_adversarial_rows(gpu, L, malformed, B):
    """K5 on chip_smoke.k5_rows (random rows without guard bytes, cut
    rows, long codes, all-zero and all-0xFF rows, one symbol a block, a DC
    that passes int16) with a luma-only and a 4:2:0 schedule, the
    session's tables and malformed ones; on the matrix and on a view of it
    one byte past a word boundary; lanes of 6 blocks (kept in shared
    memory until the CTA is done) and of 30 (flushed block by block); the
    output from torch.empty with the allocator's next block poisoned, so
    every block must be written."""
    from chip_smoke import k5_rows

    dec, tabs = _tables(gpu)
    if malformed:
        tabs = _malformed_tables(gpu, seed=L)
    rng = np.random.default_rng(L)
    S = 301
    rows = torch.from_numpy(k5_rows(dec, S, L, B, rng)).to(gpu)
    shifted = torch.empty(S * L + 8, dtype=torch.uint8, device=gpu)
    shifted[1:1 + S * L] = rows.view(-1)
    segb = rng.integers(0, B + 1, S).astype(np.int32)
    segb[:8] = B
    segb = torch.from_numpy(segb).to(gpu)
    kw = dict(blocks_per_segment=B, n_components=3)
    for sched in (np.zeros(B), np.resize(dec.comp_idx[:6], B)):
        sched = torch.from_numpy(sched.astype(np.int32)).to(gpu)
        ref = huffman_decode.decode_segments_plain(rows, segb, sched, *tabs,
                                                   **kw)
        for seg in (rows, shifted[1:1 + S * L].view(S, L)):
            poison = torch.full((S * B * 64 * 4,), 0x7F, dtype=torch.uint8,
                                device=gpu)
            torch.cuda.synchronize()
            del poison
            before = (huffman_decode.decode_segments.launches,
                      huffman_decode.decode_lut.launches)
            got = huffman_decode.decode_segments(seg, segb, sched, *tabs,
                                                 **kw)
            assert (huffman_decode.decode_segments.launches,
                    huffman_decode.decode_lut.launches) == (before[0] + 1,
                                                            before[1] + 1)
            assert torch.equal(got, ref)
    if not malformed and L >= 131 and B == 30:  # the DC ramp, luma-only
        ref = huffman_decode.decode_segments_plain(
            rows, segb, torch.zeros(B, dtype=torch.int32, device=gpu),
            *tabs, **kw)
        assert int(ref[6, :, 0].max()) > 32767


@pytest.mark.parametrize("staged", [False, True])
def test_flat_kernels_on_corrupt_lanes(gpu, staged):
    """Random bytes, start bits and predictors; lanes of up to 700 bytes,
    so K7 streams each through many halves of its ring."""
    dec, tabs = _tables(gpu)
    rng = np.random.default_rng(5)
    S, B = 500, 24
    lens = rng.integers(0, 700, S).astype(np.int32)
    starts = rng.integers(0, 4000, S).astype(np.int32)
    flat = rng.integers(0, 255, 4800).astype(np.uint8)
    flat[4700:] = 0
    segb = rng.integers(0, B + 1, S).astype(np.int32)
    bp0 = rng.integers(0, 64, S).astype(np.int32)
    dc0 = rng.integers(-40000, 40000, (S, 3)).astype(np.int32)
    sched = torch.from_numpy(np.resize(dec.comp_idx[:6], B)).to(gpu)
    up = [torch.from_numpy(a).to(gpu)
          for a in (flat, starts, lens, segb, bp0, dc0)]
    args = (*up[:4], sched, *tabs)
    kw = dict(blocks_per_segment=B, n_components=3, init_bitpos=up[4],
              init_dc=up[5])
    k1 = huffman_decode.decode_flat(*args, **kw)
    assert torch.equal(k1, huffman_decode.decode_flat_plain(*args, **kw))
    if staged:
        k7 = huffman_decode.decode_flat_staged(*args, **kw)
        assert torch.equal(k7, k1)
        assert torch.equal(k7, huffman_decode.decode_flat_staged_plain(
            *args, **kw))


@pytest.mark.parametrize("malformed", [False, True])
@pytest.mark.parametrize("hooks", [False, True])
def test_staged_kernel_matches_plain_and_k1(gpu, hooks, malformed):
    """K7 on random lanes of up to 1,500 bytes (one past the buffer's
    end), all-0xFF lanes and lanes of one symbol a block, with the
    session's tables and with malformed ones (level-2 blocks and the range
    match), against its plain version and against K1; each call builds
    the lookup table once."""
    dec, tabs = _tables(gpu)
    if malformed:
        tabs = _malformed_tables(gpu, seed=3)
    rng = np.random.default_rng(11 + hooks)
    S, B = 600, 24
    lens = rng.integers(0, 1500, S).astype(np.int32)
    starts = rng.integers(0, 6000, S).astype(np.int32)
    flat = rng.integers(0, 256, 7504).astype(np.uint8)
    ones = _one_symbol_blocks(dec, B)
    flat[100:100 + len(ones)] = ones
    starts[1], lens[1] = 100, len(ones)
    flat[2000:2600] = 0xFF
    starts[2], lens[2] = 2000, 600
    lens[0] = 7504 - starts[0] + 40          # past the buffer's end
    segb = rng.integers(0, B + 1, S).astype(np.int32)
    segb[:3] = B
    sched = torch.from_numpy(
        np.resize(dec.comp_idx[:6], B).astype(np.int32)).to(gpu)
    up = [torch.from_numpy(a).to(gpu) for a in (flat, starts, lens, segb)]
    kw = dict(blocks_per_segment=B, n_components=3)
    if hooks:
        kw["init_bitpos"] = torch.from_numpy(
            rng.integers(0, 64, S).astype(np.int32)).to(gpu)
        kw["init_dc"] = torch.from_numpy(
            rng.integers(-40000, 40000, (S, 3)).astype(np.int32)).to(gpu)
    args = (*up, sched, *tabs)
    before = (huffman_decode.decode_flat_staged.launches,
              huffman_decode.decode_lut.launches)
    k7 = huffman_decode.decode_flat_staged(*args, **kw)
    assert (huffman_decode.decode_flat_staged.launches,
            huffman_decode.decode_lut.launches) == (before[0] + 1,
                                                    before[1] + 1)
    assert torch.equal(k7, huffman_decode.decode_flat_staged_plain(
        *args, **kw))
    assert torch.equal(k7, huffman_decode.decode_flat(*args, **kw))


def test_staged_kernel_writes_every_block(gpu):
    """K7's output comes from torch.empty: with the allocator's next block
    poisoned (0x7F bytes, freed just before), blocks past each lane's
    decoded ones still read zero."""
    dec, tabs = _tables(gpu)
    rng = np.random.default_rng(13)
    S, B = 300, 24
    lens = rng.integers(0, 200, S).astype(np.int32)
    starts = rng.integers(0, 3000, S).astype(np.int32)
    flat = rng.integers(0, 256, 3200).astype(np.uint8)
    segb = rng.integers(0, B + 1, S).astype(np.int32)
    sched = torch.from_numpy(
        np.resize(dec.comp_idx[:6], B).astype(np.int32)).to(gpu)
    args = (*[torch.from_numpy(a).to(gpu) for a in (flat, starts, lens,
                                                     segb)], sched, *tabs)
    kw = dict(blocks_per_segment=B, n_components=3)
    poison = torch.full((S * B * 64 * 4,), 0x7F, dtype=torch.uint8,
                        device=gpu)
    torch.cuda.synchronize()
    del poison
    got = huffman_decode.decode_flat_staged(*args, **kw)
    ref = huffman_decode.decode_flat_staged_plain(*args, **kw)
    assert torch.equal(got, ref)
    past = torch.arange(B, device=gpu)[None] >= args[3][:, None]
    assert past.any() and not got[past].any()


@pytest.mark.parametrize("p", ["1", "6", "720", "N"])
@pytest.mark.parametrize("n", [1, 31, 33, 127, 129, 783361])
def test_decode_datapath_kernel_on_adversarial_blocks(gpu, n, p):
    """K2 at block counts off its tile (783,361 is one past the main
    path's dispatch), quant periods of 1, 6, 720 and N (staged in shared
    memory and read from global memory), on chip_smoke.k2_coefs: zero,
    DC-only, ±2047, ±32767, wrapping 2^20 products and random int32."""
    from chip_smoke import k2_coefs, k2_quant
    rng = np.random.default_rng(n)
    coefs = torch.from_numpy(k2_coefs(n, rng)).to(gpu)
    quant = torch.from_numpy(
        k2_quant(n if p == "N" else int(p), rng)).to(gpu)
    before = datapath.decode_datapath.launches
    got = datapath.decode_datapath(coefs, quant)
    assert datapath.decode_datapath.launches == before + 1
    assert torch.equal(got, datapath.decode_datapath_plain(coefs, quant))


def test_decode_datapath_rejects_unaligned_views(gpu):
    """K2 reads 16-byte vectors: a coefficient or quant view off a 16-byte
    boundary is refused, an aligned view (a block on) is decoded."""
    from chip_smoke import k2_coefs, k2_quant
    rng = np.random.default_rng(4)
    coefs = torch.from_numpy(k2_coefs(101, rng)).to(gpu)
    quant = torch.from_numpy(k2_quant(7, rng)).to(gpu)
    flat = coefs.view(-1)
    for shift in (1, 2, 3):
        with pytest.raises(ValueError):
            datapath.decode_datapath(
                flat[shift:shift + 100 * 64].view(100, 64), quant[:6])
    with pytest.raises(ValueError):
        datapath.decode_datapath(coefs[:100],
                                 quant.view(-1)[1:6 * 64 + 1].view(6, 64))
    assert torch.equal(datapath.decode_datapath(coefs[1:], quant[1:]),
                       datapath.decode_datapath_plain(coefs[1:], quant[1:]))


@pytest.mark.parametrize("T,n,offset", [(1, 5, 0), (128, 1000, 1),
                                        (528, 100003, 3), (1024, 4096, 0)])
def test_table_lookup_kernel_matches_plain(gpu, T, n, offset):
    """K9 on in-range and out-of-range indices, at element offsets that
    leave the index array off a 16-byte boundary."""
    rng = np.random.default_rng(T)
    table = torch.from_numpy(
        rng.integers(-2**31, 2**31, T, dtype=np.int64).astype(np.int32)
    ).to(gpu)
    idx = rng.integers(0, T, n + offset).astype(np.int32)
    idx[::7] = rng.integers(-5, T + 5, len(idx[::7]))
    idx[:3] = (-1, T, 2**31 - 1)
    idx = torch.from_numpy(idx).to(gpu)[offset:]
    before = lookup.table_lookup.launches
    got = lookup.table_lookup(table, idx)
    assert lookup.table_lookup.launches == before + 1
    assert torch.equal(got, lookup.table_lookup_plain(table, idx))
    two_d = idx[:n // 5 * 5].reshape(-1, 5).contiguous()
    assert torch.equal(lookup.table_lookup(table, two_d),
                       lookup.table_lookup_plain(table, two_d))
    with pytest.raises(ValueError):
        lookup.table_lookup(torch.zeros(1025, dtype=torch.int32, device=gpu),
                            idx)


@pytest.mark.parametrize("S,K", [(1, 1), (31, 66), (70, 131), (300, 2341)])
def test_pack_stuff_kernel_matches_plain(gpu, S, K):
    """K8 on synthetic slots: lengths over and outside 0..59, garbage
    above the length, all-ones values (runs of 0xFF), lane counts and
    slot counts off the tile sizes, fitting and overflowing budgets."""
    rng = np.random.default_rng(S * K)
    c_len = rng.integers(0, 60, (S, K)).astype(np.int32)
    c_len[rng.random((S, K)) < 0.5] = 0
    c_len[:, ::11] = 32
    c_len[0, :4] = (-3, 64, 60, 59)[:K]
    c_hi = rng.integers(-2**31, 2**31, (S, K), dtype=np.int64) \
        .astype(np.int32)
    c_lo = rng.integers(-2**31, 2**31, (S, K), dtype=np.int64) \
        .astype(np.int32)
    c_hi[S // 2:] = -1
    c_lo[S // 2:] = -1
    raw = rng.integers(0, 500, S).astype(np.int32)
    args = [torch.from_numpy(a).to(gpu) for a in (c_hi, c_lo, c_len, raw)]
    for m_raw, m_out in ((10**6, K * 16 + 8), (250, max(1, K))):
        before = pack_stuff.pack_stuff.launches
        got = pack_stuff.pack_stuff(*args, m_raw=m_raw, m_out=m_out)
        assert pack_stuff.pack_stuff.launches == before + 1
        ref = pack_stuff.pack_stuff_plain(*args, m_raw=m_raw, m_out=m_out)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("S,K", [(13, 1), (70, 131), (9, 3121)])
@pytest.mark.parametrize("case", ["mixed", "dense 0xFF", "33 to 59",
                                  "chunk edges", "0xFF across chunks",
                                  "mid-byte ends"])
def test_pack_stuff_kernel_on_adversarial_slots(gpu, case, S, K):
    """K8 on chip_smoke.k8_slots: lane counts off a CTA's, K = 1 and odd
    K, dense 0xFF output, lengths 33..59 and 32/33/59 at chunk edges, lanes
    that end mid-byte, an empty lane; at a budget that fits, one a byte
    short in m_raw and an m_out that cuts lanes inside a chunk. The output
    comes from torch.empty with the allocator's next block poisoned, so
    every byte of it must be written."""
    from chip_smoke import k8_budgets, k8_slots

    rng = np.random.default_rng(S + K)
    arrays = k8_slots(case, S, K, rng)
    args = [torch.from_numpy(a).to(gpu) for a in arrays]
    overflows = []
    for m_raw, m_out in k8_budgets(arrays[3]):
        poison = torch.full((S * m_out,), 0xA5, dtype=torch.uint8,
                            device=gpu)
        torch.cuda.synchronize()
        del poison
        got = pack_stuff.pack_stuff(*args, m_raw=m_raw, m_out=m_out)
        ref = pack_stuff.pack_stuff_plain(*args, m_raw=m_raw, m_out=m_out)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        overflows.append(bool(got[2]))
    assert overflows[:2] == [False, bool(arrays[3].max() > 0)]


@pytest.mark.parametrize("ri,pack,kernel", [(6, "pallas", "K8"),
                                            (2, "pallas", "K4"),
                                            (6, "xla", None),
                                            (6, "auto", "K8")])
def test_encoder_routes_on_card_match_cpu(gpu, ri, pack, kernel):
    """encode_device_batch by device_pack on the card: the route launches
    its kernels and the bytes equal the same session's on the CPU."""
    rng = np.random.default_rng(ri)
    w, h = 256, 128
    frames = [(rng.integers(0, 256, (h, w), dtype=np.uint8),
               rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
               rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
              for _ in range(4)]
    params = Parameters.c420(w, h, 60)
    counts = {"K4": huffman_encode.encode_segments, "K8": pack_stuff.pack_stuff,
              "K9": lookup.table_lookup}
    before = {k: fn.launches for k, fn in counts.items()}
    got = JpegEncoderSession(params, ri, device=gpu, device_pack=pack) \
        .encode_device_batch(frames)
    delta = {k: fn.launches - before[k] for k, fn in counts.items()}
    assert (delta["K4"] > 0) == (kernel == "K4")
    assert (delta["K8"] > 0) == (kernel == "K8")
    assert (delta["K9"] > 0) == (kernel != "K4")
    ref = JpegEncoderSession(params, ri, device="cpu", device_pack=pack) \
        .encode_device_batch(frames)
    assert got == ref


def _malformed_tables(gpu, seed=1):
    """Range tables no DHT produces: overlapping and inverted ranges,
    negative offsets (codes up to 136 bits long)."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << 16, (6, 16)).astype(np.int32)
    hi = (lo + rng.integers(-500, 9000, (6, 16))).astype(np.int32)
    off = rng.integers(-50, 400, (6, 16)).astype(np.int32)
    values = rng.integers(0, 1000, 384).astype(np.int32)
    return tuple(torch.from_numpy(a).to(gpu) for a in (lo, hi, off, values))


@pytest.mark.parametrize("malformed", [False, True])
def test_decode_lut_kernel_matches_plain(gpu, malformed):
    tabs = _malformed_tables(gpu) if malformed else _tables(gpu)[1]
    before = huffman_decode.decode_lut.launches
    got = huffman_decode.decode_lut(*tabs)
    assert huffman_decode.decode_lut.launches == before + 1
    assert torch.equal(got, huffman_decode.decode_lut_plain(*tabs))


def _one_symbol_blocks(dec, n: int) -> np.ndarray:
    """A luma segment of n blocks of all-zero coefficients: DC category 0
    and EOB, block after block."""
    def code(lut, value):
        idx = next(i for i in range(1 << lut.max_bits)
                   if lut.lengths[i] and lut.data[i] == value)
        k = int(lut.lengths[idx])
        return format(idx >> (lut.max_bits - k), f"0{k}b")

    luma = dec.components[0]
    bits = (code(luma.dc_tab, 0) + code(luma.ac_tab, 0)) * n
    bits += "1" * (-len(bits) % 8)
    return np.frombuffer(int(bits, 2).to_bytes(len(bits) // 8, "big"),
                         np.uint8)


# rows that take several sync rounds (random bytes, short subsequences),
# one symbol a block, a schedule with no short period, rows shorter than
# L, seg_blocks of 0 and of B; rows too long to stage in shared memory,
# at unaligned starts
@pytest.mark.parametrize("case,sub_bits", [
    ("random", 1024), ("random", 64), ("zero_blocks", 1024),
    ("zero_blocks", 64), ("no_period", 64), ("short_rows", 256),
    ("malformed", 64), ("long_rows", 1024)])
def test_streamed_kernel_on_adversarial_rows(gpu, monkeypatch, case,
                                             sub_bits):
    monkeypatch.setattr(huffman_decode, "STREAMED_SUB_BITS", sub_bits)
    dec, tabs = _tables(gpu)
    rng = np.random.default_rng(sub_bits)
    S, L, B = 64, 1024, 240
    if case == "long_rows":
        S, L = 16, 16401
    rows = rng.integers(0, 256, (S, L)).astype(np.uint8)
    sched = np.resize(dec.comp_idx[:6], B)
    if case == "zero_blocks":
        data = _one_symbol_blocks(dec, B)
        rows[:] = 0
        rows[:, :len(data)] = data
        sched = np.zeros(B, np.int64)
    elif case == "no_period":
        sched = rng.integers(0, 3, B)
    elif case == "short_rows":
        for s in range(S):
            rows[s, rng.integers(0, L):] = 0
    elif case == "malformed":
        tabs = _malformed_tables(gpu)
    rows[1] = 0
    rows[2] = 0xFF
    segb = rng.integers(0, B + 1, S).astype(np.int32)
    segb[:6] = (B, B, B, 0, B, 1)
    args = (torch.from_numpy(rows).to(gpu), torch.from_numpy(segb).to(gpu),
            torch.from_numpy(sched.astype(np.int32)).to(gpu), *tabs)
    kw = dict(blocks_per_segment=B, n_components=3)
    got = huffman_decode.decode_segments_streamed(*args, **kw)
    assert torch.equal(got, huffman_decode.decode_segments_streamed_plain(
        *args, **kw))
    rounds, n_sub = huffman_decode.decode_segments_streamed.stats.cpu().T[:2]
    assert int(rounds[3]) == 0 and int(rounds.max()) >= 2
    assert int(n_sub.max()) <= -(-(8 * L + 32) // sub_bits)


@pytest.mark.parametrize("malformed", [False, True])
@pytest.mark.parametrize("hooks", [False, True])
def test_flat_kernel_on_random_lanes(gpu, hooks, malformed):
    """K1 with and without its hooks on random lanes (one past the
    buffer's end), with the session's tables and with range tables whose
    codes reach 136 bits (the range match and magnitude peeks past the
    64-bit window)."""
    tabs = _malformed_tables(gpu, seed=2) if malformed else _tables(gpu)[1]
    rng = np.random.default_rng(7)
    S, B = 400, 24
    lens = rng.integers(0, 700, S).astype(np.int32)
    starts = rng.integers(0, 4000, S).astype(np.int32)
    flat = rng.integers(0, 256, 4803).astype(np.uint8)
    lens[0] = 4803 - starts[0] + 40          # past the buffer's end
    segb = rng.integers(0, B + 1, S).astype(np.int32)
    sched = torch.from_numpy(rng.integers(0, 3, B).astype(np.int32)).to(gpu)
    up = [torch.from_numpy(a).to(gpu) for a in (flat, starts, lens, segb)]
    kw = dict(blocks_per_segment=B, n_components=3)
    if hooks:
        kw["init_bitpos"] = torch.from_numpy(
            rng.integers(0, 64, S).astype(np.int32)).to(gpu)
        kw["init_dc"] = torch.from_numpy(
            rng.integers(-40000, 40000, (S, 3)).astype(np.int32)).to(gpu)
    args = (*up, sched, *tabs)
    assert torch.equal(huffman_decode.decode_flat(*args, **kw),
                       huffman_decode.decode_flat_plain(*args, **kw))


@pytest.mark.parametrize("hooks", [False, True])
@pytest.mark.parametrize("shift", [1, 2, 3])
def test_flat_kernel_on_unaligned_view(gpu, shift, hooks):
    """K1 reads its buffer in aligned words: a view that starts 1..3 bytes
    past a word boundary (``buf[shift:]``, a row slice of a padded matrix)
    decodes as the plain version does."""
    dec, tabs = _tables(gpu)
    rng = np.random.default_rng(shift)
    S, B = 300, 24
    lens = rng.integers(0, 700, S).astype(np.int32)
    starts = rng.integers(0, 4000, S).astype(np.int32)
    flat = rng.integers(0, 256, 4803 + shift).astype(np.uint8)
    lens[0] = 4803 - starts[0] + 40          # past the buffer's end
    segb = rng.integers(0, B + 1, S).astype(np.int32)
    sched = torch.from_numpy(
        np.resize(dec.comp_idx[:6], B).astype(np.int32)).to(gpu)
    view = torch.from_numpy(flat).to(gpu)[shift:]
    assert view.data_ptr() % 4 == shift
    up = [view] + [torch.from_numpy(a).to(gpu) for a in (starts, lens, segb)]
    kw = dict(blocks_per_segment=B, n_components=3)
    if hooks:
        kw["init_bitpos"] = torch.from_numpy(
            rng.integers(0, 64, S).astype(np.int32)).to(gpu)
        kw["init_dc"] = torch.from_numpy(
            rng.integers(-40000, 40000, (S, 3)).astype(np.int32)).to(gpu)
    args = (*up, sched, *tabs)
    assert torch.equal(huffman_decode.decode_flat(*args, **kw),
                       huffman_decode.decode_flat_plain(*args, **kw))


@pytest.mark.parametrize("p", ["1", "6", "N"])
@pytest.mark.parametrize("n", [1, 31, 33, 783361])
def test_encode_datapath_kernel_on_adversarial_blocks(gpu, n, p):
    """K3 at block counts off its tile (783,361 is one past the main
    path's dispatch), quant periods of 1, 6 and N, on all-0, all-255 and
    ±128 checkerboard blocks, with quant rows of 1, 255, random 8-bit and
    past the reciprocal table."""
    from chip_smoke import K3_QUANTS, k3_pixels, k3_quant
    rng = np.random.default_rng(n)
    pixels = torch.from_numpy(k3_pixels(n, rng)).to(gpu)
    for kind in K3_QUANTS:
        quant = torch.from_numpy(
            k3_quant(kind, n if p == "N" else int(p), rng)).to(gpu)
        before = datapath.encode_datapath.launches
        got = datapath.encode_datapath(pixels, quant)
        assert datapath.encode_datapath.launches == before + 1
        assert torch.equal(got, datapath.encode_datapath_plain(pixels, quant))


def test_encode_datapath_rejects_unaligned_views(gpu):
    """K3 reads 16-byte vectors: a pixel or quant view off a 16-byte
    boundary is refused, an aligned view (a block offset) is encoded."""
    n = 100
    rng = np.random.default_rng(3)
    flat = torch.from_numpy(rng.integers(0, 256, n * 64 + 64,
                                         dtype=np.uint8)).to(gpu)
    quant = torch.from_numpy(rng.integers(1, 256, (7, 64)).astype(
        np.int32)).to(gpu)
    for shift in (1, 4, 8, 15):
        with pytest.raises(ValueError):
            datapath.encode_datapath(
                flat[shift:shift + n * 64].view(n, 8, 8), quant[:6])
    with pytest.raises(ValueError):
        datapath.encode_datapath(flat[:n * 64].view(n, 8, 8),
                                 quant.view(-1)[1:6 * 64 + 1].view(6, 64))
    view = flat[64:].view(n, 8, 8)
    assert torch.equal(datapath.encode_datapath(view, quant[1:]),
                       datapath.encode_datapath_plain(view, quant[1:]))


def _k4_tables(gpu, C):
    from chip_smoke import k4_tables
    st = JpegEncoderSession(Parameters.c420(64, 48, 75), 1,
                            device="cpu").state
    return tuple(t.to(gpu) for t in k4_tables(st.dctab, st.actab, C))


@pytest.mark.parametrize("S,B,C", [(1, 1, 1), (31, 6, 3), (33, 6, 4),
                                   (33, 32, 3), (31, 48, 4), (33, 48, 1),
                                   (4000, 6, 3)])
def test_huffman_encode_kernel_on_adversarial_blocks(gpu, S, B, C):
    """K4 on the entropy coder's edge cases (``chip_smoke.k4_blocks``:
    EOB-only and EOB-free blocks, runs around 16, 32 and 48, long trailing
    zeros, saturated sizes at runs 0, 14 and 15, DC steps of ±2047 and
    ±4094, 0xFF-dense streams), invalid blocks mid-segment and clamped
    schedule entries, with m_out one below, at and one above the longest
    segment's stuffed length."""
    from chip_smoke import k4_segments
    qc, valid, sched = (torch.from_numpy(a).to(gpu) for a in k4_segments(
        S, B, C, np.random.default_rng(S * B * C)))
    args = (qc, valid, sched, *_k4_tables(gpu, C))
    longest = int(huffman_encode.encode_segments_plain(*args, m_out=1)[1]
                  .max())
    for m_out in (longest - 1, longest, longest + 1):
        before = huffman_encode.encode_segments.launches
        got = huffman_encode.encode_segments(*args, m_out=m_out)
        assert huffman_encode.encode_segments.launches == before + 1
        ref = huffman_encode.encode_segments_plain(*args, m_out=m_out)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert bool(got[2]) == (m_out < longest)


def test_huffman_encode_rejects_unaligned_views(gpu):
    """K4 copies its coefficients in 16-byte pieces: an int32 view 4, 8 or
    12 bytes off a 16-byte boundary is refused, one 16 bytes on is
    encoded as the plain version does."""
    from chip_smoke import k4_segments
    S, B = 40, 6
    qc, valid, sched = (torch.from_numpy(a).to(gpu) for a in k4_segments(
        S, B, 3, np.random.default_rng(9)))
    tabs = _k4_tables(gpu, 3)
    flat = torch.zeros(qc.numel() + 4, dtype=torch.int32, device=gpu)
    for shift in (1, 2, 3, 4):
        view = flat[shift:shift + qc.numel()].view(S, B * 64)
        view.copy_(qc)
        args = (view, valid, sched, *tabs)
        if shift < 4:
            with pytest.raises(ValueError):
                huffman_encode.encode_segments(*args, m_out=900)
            continue
        for a, b in zip(huffman_encode.encode_segments(*args, m_out=900),
                        huffman_encode.encode_segments_plain(*args,
                                                             m_out=900)):
            assert torch.equal(a, b)


def _frames_equal(a, b):
    return all(np.array_equal(getattr(a, c).data, getattr(b, c).data)
               for c in "yuv")


_HUFFMAN = {"K1": huffman_decode.decode_flat,
            "K5": huffman_decode.decode_segments,
            "K6": huffman_decode.decode_segments_streamed,
            "K7": huffman_decode.decode_flat_staged}


@pytest.mark.parametrize("entropy,transfer,how,kernel", [
    ("native", "dense", "auto", None), ("python", "sparse", "auto", None),
    ("tpu", "auto", "auto", "K1"), ("tpu", "dense", "pallas", "K5"),
    ("tpu", "sparse", "pallas_t", "K1"), ("tpu", "auto", "lut", None),
    ("tpu", "auto", "range", None)])
def test_host_entropy_routes_on_card_match_cpu(gpu, entropy, transfer, how,
                                               kernel):
    """decode() by entropy and coef_transfer on the card: K2 once, the
    strategy's Huffman kernel once (none for the host decoder and the
    plain loops), planes equal to the same session on the CPU and to
    decode_device()."""
    header, payloads = _streams(gpu)
    kw = dict(entropy=entropy, coef_transfer=transfer, device_huffman=how)
    sess = JpegDecoderSession(header, device=gpu, **kw)
    before = {k: fn.launches for k, fn in _HUFFMAN.items()}
    k2 = datapath.decode_datapath.launches
    got = sess.decode(payloads[0])
    delta = {k: fn.launches - before[k] for k, fn in _HUFFMAN.items()}
    assert datapath.decode_datapath.launches - k2 == 1
    assert delta == {k: int(k == kernel) for k in _HUFFMAN}
    ref = JpegDecoderSession(header, device="cpu", **kw).decode(payloads[0])
    assert _frames_equal(got, ref)
    assert _frames_equal(got, JpegDecoderSession(header, device=gpu)
                         .decode_device(payloads[0]))


def test_host_entropy_batch_iter_and_resync_on_card_match_cpu(gpu):
    header, payloads = _streams(gpu)
    cpu = JpegDecoderSession(header, device="cpu")
    refs = [cpu.decode(p) for p in payloads]
    for entropy in ("native", "tpu"):
        sess = JpegDecoderSession(header, device=gpu, entropy=entropy)
        assert all(_frames_equal(g, r) for g, r in
                   zip(sess.decode_batch(payloads), refs))
        got = list(sess.decode_iter([payloads[2], payloads[0]]))
        assert _frames_equal(got[0], refs[2])
        assert _frames_equal(got[1], refs[0])
    from video_coding_tpu_torch.entropy import scan as hscan
    segs = hscan.destuff_segments(payloads[1])
    segs[5] = b"\xff" * len(segs[5])
    bad = hscan.join_segments([s.replace(b"\xff", b"\xff\x00")
                               for s in segs]) + b"\xff\xd9"
    for data in (bad, payloads[1][:len(payloads[1]) // 2]):
        gpu_sess = JpegDecoderSession(header, device=gpu)
        got = gpu_sess.decode(data, resync=True)
        assert _frames_equal(got, cpu.decode(data, resync=True))
        assert gpu_sess.last_damaged_segments == cpu.last_damaged_segments
        assert gpu_sess.last_damaged_segments
    with pytest.raises(hscan.SegmentDecodeError):
        JpegDecoderSession(header, device=gpu).decode(bad)


def test_transcode_host_route_on_card_matches_device_route(gpu):
    header, payloads = _streams(gpu)
    host = JpegTranscodeSession(header, quality=60, restart_interval=1,
                                device=gpu, entropy_out="host")
    k4 = huffman_encode.encode_segments.launches
    k3 = datapath.encode_datapath.launches
    got = host.transcode_batch(payloads)
    assert huffman_encode.encode_segments.launches == k4
    assert datapath.encode_datapath.launches == k3 + 1
    dev = JpegTranscodeSession(header, quality=60, restart_interval=1,
                               device=gpu)
    assert got == dev.transcode_batch(payloads)
    assert got == JpegTranscodeSession(
        header, quality=60, restart_interval=1, device="cpu",
        entropy_out="host").transcode_batch(payloads)
    assert list(host.transcode_iter(payloads[::-1])) == got[::-1]



def _rgb_stream(gpu, sub, w, h, ri, n=3):
    """n random frames of one sampling (a ChromaSubsampling value) encoded
    on the card: (header, header bytes, payloads)."""
    from video_coding_tpu_torch.common.frame import ChromaSubsampling

    cs = ChromaSubsampling(sub)
    enc = JpegEncoderSession(getattr(Parameters, "c" + sub)(w, h, 85), ri,
                             device=gpu)
    rng = np.random.default_rng(w * h + ri)
    cw, ch = cs.chroma_width(w), cs.chroma_height(h)
    frames = [(rng.integers(0, 256, (h, w), dtype=np.uint8),
               rng.integers(0, 256, (ch, cw), dtype=np.uint8),
               rng.integers(0, 256, (ch, cw), dtype=np.uint8))
              for _ in range(n)]
    streams = enc.encode_device_batch(frames)
    bits = BitReader(streams[0])
    header = Header.decode(bits)
    hdr_len = bits.bit_pos >> 3
    return header, streams[0][:hdr_len], [s[hdr_len:] for s in streams]


@pytest.mark.parametrize("sub,w,h,ri", [
    ("420", 256, 128, 1), ("422", 256, 128, 0), ("440", 128, 96, 2),
    ("444", 96, 64, 1), ("420", 1919, 1079, 1), ("422", 61, 45, 3)])
def test_rgb_on_card_matches_cpu(gpu, sub, w, h, ri):
    """decode_device_rgb(_batch) on the card: the CPU session's RGB, uint8
    on the card, K2 launched once a batch."""
    header, _hdr, payloads = _rgb_stream(gpu, sub, w, h, ri)
    card = JpegDecoderSession(header, device=gpu)
    cpu = JpegDecoderSession(header, device="cpu")
    datapath.decode_datapath.launches = 0
    rgb = card.decode_device_rgb_batch(payloads)
    torch.cuda.synchronize()
    assert datapath.decode_datapath.launches == 1
    assert rgb.device.type == gpu.type and rgb.dtype == torch.uint8
    assert rgb.shape == (len(payloads), h, w, 3)
    assert torch.equal(rgb.cpu(), cpu.decode_device_rgb_batch(payloads))
    assert torch.equal(card.decode_device_rgb(payloads[1]), rgb[1])


def test_rgb_dataset_and_mjpeg_on_card(gpu):
    from video_coding_tpu_torch.runtime.dataset import JpegRgbDataset
    from video_coding_tpu_torch.tools import mjpeg

    header, hdr, payloads = _rgb_stream(gpu, "420", 256, 128, 1, n=5)
    stream = mjpeg.join_stream([hdr + p for p in payloads])
    batches = list(JpegRgbDataset(stream, batch_size=2, prefetch=2))
    assert [tuple(b.shape) for b in batches] == [(2, 128, 256, 3)] * 2 \
        + [(1, 128, 256, 3)]
    assert all(b.device.type == gpu.type for b in batches)
    ref = JpegDecoderSession(header, device="cpu").decode_device_rgb_batch(
        payloads)
    assert torch.equal(torch.cat(batches).cpu(), ref)
    for g, r in zip(mjpeg.decode_stream(stream),
                    mjpeg.decode_stream(stream, device="cpu"), strict=True):
        assert all((getattr(g, c).data == getattr(r, c).data).all()
                   for c in "yuv")


def test_pipeline_trace_on_card_matches_cpu(gpu):
    """runtime.trace.pipeline_trace runs its stages on the card by default
    and gives the CPU's trace, stage by stage."""
    from video_coding_tpu_torch.runtime import trace

    rng = np.random.default_rng(9)
    coefs = rng.choice([-32767, -2047, -5, 0, 7, 2047, 32767],
                       (300, 64)).astype(np.int32)
    quant = rng.integers(1, 256, (300, 64)).astype(np.int32)
    got = trace.pipeline_trace(coefs, quant)
    want = trace.pipeline_trace(coefs, quant, device="cpu")
    for f in ("coefs_zigzag", "dequant_zigzag", "dequant_natural",
              "after_row_pass", "after_col_pass", "clipped", "recon"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


_MESH_CHILD = """
import socket
import numpy as np
import torch
import torch.distributed as dist
from video_coding_tpu_torch.common.bitstream import BitReader
from video_coding_tpu_torch.entropy import huffman_decode, huffman_encode
from video_coding_tpu_torch.entropy import pack_stuff
from video_coding_tpu_torch.model.header import Header, Parameters
from video_coding_tpu_torch.parallel import codec_mesh
from video_coding_tpu_torch.runtime.engine import (
    JpegDecoderSession, JpegEncoderSession, JpegTranscodeSession)

with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=1, rank=0)
mesh = codec_mesh(1)
assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda"
rng = np.random.default_rng(0)
w, h = 256, 128
frames = [(rng.integers(0, 256, (h, w), dtype=np.uint8),
           rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
           rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
          for _ in range(4)]
for ri, kernel in ((1, huffman_encode.encode_segments),
                   (8, pack_stuff.pack_stuff)):
    p = Parameters.c420(w, h, 80)
    ref = JpegEncoderSession(p, ri, device_pack="pallas")
    sharded = JpegEncoderSession(p, ri, device_pack="pallas", mesh=mesh)
    kernel.launches = 0
    got = sharded.encode_device_batch(frames)
    assert kernel.launches >= 1, ri   # one a rung of the budget ladder
    assert got == ref.encode_device_batch(frames), ri
streams = JpegEncoderSession(Parameters.c420(w, h, 80), 1) \\
    .encode_device_batch(frames)
bits = BitReader(streams[0])
header = Header.decode(bits)
payloads = [s[bits.bit_pos >> 3:] for s in streams]
dec = JpegDecoderSession(header)
mdec = JpegDecoderSession(header, mesh=mesh)
huffman_decode.decode_flat.launches = 0
planes = mdec.decode_device_batch_stacked(payloads)
assert huffman_decode.decode_flat.launches == 1
for a, b in zip(planes, dec.decode_device_batch_stacked(payloads)):
    assert torch.equal(a.full_tensor(), b)
for a, b in zip(mdec.decode_device_e2e(payloads[1]),
                dec.decode_device_e2e(payloads[1])):
    assert torch.equal(a, b)
t_ref = JpegTranscodeSession(header, 60, 1).transcode_batch(payloads)
assert JpegTranscodeSession(header, 60, 1, mesh=mesh) \\
    .transcode_batch(payloads) == t_ref
dist.destroy_process_group()
print("MESH OK")
"""


def test_one_rank_nccl_mesh_sessions_match_unsharded(gpu):
    """A one-rank NCCL mesh on the card: the sharded decode (K1), encode
    (K4 at ri=1, K9 + K8 at ri=8) and transcode equal the unsharded
    sessions. In a subprocess: the process group must not outlive it."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    r = subprocess.run([sys.executable, "-c", _MESH_CHILD], cwd=root,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "MESH OK" in r.stdout, r.stderr[-4000:]


def test_generate_prints_k2_ptx(gpu, capsys):
    from video_coding_tpu_torch.cli import generate_cli

    assert generate_cli.main(["decoder"]) == 0
    out = capsys.readouterr().out
    assert ".target sm_90a" in out and ".entry" in out
    assert "decode_datapath_kernel" in out
    assert generate_cli.main(["entropy-decoder", "--compiled"]) == 0
    sass = capsys.readouterr().out
    assert "huffman_decode_padded_kernel" in sass
    assert "huffman_decode_kernel" in sass


def test_simulate_codeblock_launches_k1(gpu, tmp_path, capsys):
    from video_coding_tpu_torch.cli import simulate_cli

    header, payloads = _streams(gpu, n=1, w=512, h=256)
    enc = JpegEncoderSession(Parameters.c420(512, 256, 80), 1, device=gpu)
    jpg = tmp_path / "f.jpg"
    jpg.write_bytes(enc._header_bytes + payloads[0] + b"\xff\xd9")
    huffman_decode.decode_flat.launches = 0
    assert simulate_cli.main(["codeblock", str(jpg), "--entropy",
                              "tpu"]) == 0
    assert "0 mismatched" in capsys.readouterr().out
    assert huffman_decode.decode_flat.launches == 1


@pytest.mark.parametrize("sub,w,h,ri", [("420", 16, 16, 2), ("420", 16, 16, 5),
                                        ("420", 8, 9, 2), ("420", 32, 16, 3),
                                        ("444", 8, 8, 2)])
def test_restart_interval_longer_than_the_frame_on_card(gpu, sub, w, h, ri):
    """One segment, shorter than the interval's B blocks: the device
    decode routes (K5 or K1 on one lane; K2), decode(entropy="tpu"),
    both transcode routes and encode_device(_batch) under every
    device_pack on the card equal the CPU sessions and the golden
    model's bytes."""
    from video_coding_tpu_torch.common.frame import ChromaSubsampling, Frame
    from video_coding_tpu_torch.common.plane import Plane
    from video_coding_tpu_torch.model import encoder as menc

    rng = np.random.default_rng(w * h + ri)
    s = ChromaSubsampling[f"C{sub}"]
    frame = Frame(*(Plane(data=rng.integers(0, 256, (ph, pw),
                                            dtype=np.uint8))
                    for pw, ph in ((w, h), (s.chroma_width(w),
                                            s.chroma_height(h)),
                                   (s.chroma_width(w), s.chroma_height(h)))),
                  s)
    make = {"420": Parameters.c420, "444": Parameters.c444}[sub]
    golden = {"420": menc.encode_420,
              "444": menc.encode_444}[sub](frame, 75, restart_interval=ri)
    for pack in ("xla", "auto", "pallas"):
        enc = JpegEncoderSession(make(w, h, 75), ri, device=gpu,
                                 device_pack=pack)
        assert enc.blocks_per_segment > enc.n_blocks
        assert enc.encode_device(frame) == golden
        assert enc.encode_device_batch([frame, frame]) == [golden] * 2
    bits = BitReader(golden)
    header = Header.decode(bits)
    payload = golden[bits.bit_pos >> 3:]
    cpu = JpegDecoderSession(header, device="cpu").decode_device(payload)
    dec = JpegDecoderSession(header, device=gpu)
    for got in (dec.decode_device(payload),
                dec._to_frame(dec.decode_device_batch([payload] * 2)[1]),
                JpegDecoderSession(header, device=gpu,
                                   entropy="tpu").decode(payload),
                dec.decode(payload)):
        for a, b in zip((got.y, got.u, got.v), (cpu.y, cpu.u, cpu.v)):
            assert np.array_equal(a.data, b.data)
    want = JpegTranscodeSession(header, quality=60, restart_interval=ri,
                                device="cpu").transcode(payload)
    for out in ("device", "host"):
        assert JpegTranscodeSession(header, quality=60, restart_interval=ri,
                                    device=gpu, entropy_out=out
                                    ).transcode_batch([payload] * 2) == \
            [want] * 2


def _golden_stream(sub, w, h, q, ri, seed):
    """(frame, the golden model's stream of it) for a random frame."""
    from video_coding_tpu_torch.common.frame import ChromaSubsampling, Frame
    from video_coding_tpu_torch.common.plane import Plane
    from video_coding_tpu_torch.model import encoder as menc

    rng = np.random.default_rng(seed)
    s = ChromaSubsampling[f"C{sub}"]
    cw, ch = s.chroma_width(w), s.chroma_height(h)
    frame = Frame(*(Plane(data=rng.integers(0, 256, (ph, pw),
                                            dtype=np.uint8))
                    for pw, ph in ((w, h), (cw, ch), (cw, ch))), s)
    encode = getattr(menc, f"encode_{sub}")
    return frame, encode(frame, q, restart_interval=ri)


@pytest.mark.parametrize("sub,interval,q", [
    ("420", "1", 10), ("420", "1", 95), ("420", "row", 10),
    ("420", "row", 95), ("444", "1", 50), ("422", "1", 50)])
def test_decode_quality_sweep_on_card(gpu, sub, interval, q):
    """The JAX package's on-chip decode sweep (tests/test_tpu_lane.py):
    96x64 random frames by sampling, restart interval and quality decode
    on the card to the golden model's planes."""
    from video_coding_tpu_torch.model import decoder as mdec

    mcu_w = 8 if sub == "444" else 16
    ri = 1 if interval == "1" else -(-96 // mcu_w)
    _frame, stream = _golden_stream(sub, 96, 64, q, ri, 3)
    bits = BitReader(stream)
    header = Header.decode(bits)
    got = JpegDecoderSession(header, device=gpu).decode_device(
        stream[bits.bit_pos >> 3:])
    golden = mdec.decode_a_frame(stream)
    for p in "yuv":
        assert np.array_equal(getattr(got, p).data, getattr(golden, p).data)


@pytest.mark.parametrize("sub,q", [("420", 50), ("444", 95)])
def test_encode_quality_sweep_on_card(sub, q, gpu):
    """The JAX package's on-chip encode sweep: the device encode of a
    96x64 random frame gives the golden model's bytes."""
    frame, stream = _golden_stream(sub, 96, 64, q, 1, 4)
    make = {"420": Parameters.c420, "444": Parameters.c444}[sub]
    sess = JpegEncoderSession(make(96, 64, q), 1, device=gpu)
    assert sess.encode_device(frame) == stream
    assert sess.encode_device_batch([frame, frame]) == [stream, stream]


@pytest.mark.parametrize("name,wrapper", [
    ("webcam_422_q75_opt.jpg", "decode_flat"),
    ("rows_420_q90_rst_row.jpg", "decode_segments_streamed"),
    ("blocks_444_q85_rst1.jpg", "decode_flat")])
def test_foreign_streams_on_card(gpu, name, wrapper):
    """The committed libjpeg-turbo streams (tests/data/torch_foreign) on
    the card: decode_device_batch of three copies and decode_device launch
    the kernel their shape routes to (the index scan's K1 with hooks, K6,
    K1) and give the host-entropy route's planes; the transcode to q75
    ri=1 gives the host route's bytes."""
    from pathlib import Path

    data = (Path(__file__).parent / "data" / "torch_foreign" / name) \
        .read_bytes()
    bits = BitReader(data)
    header = Header.decode(bits)
    payload = data[bits.bit_pos >> 3:]
    ref = JpegDecoderSession(header, device=gpu, entropy="native") \
        .decode(payload)
    ref = [ref.y.data, ref.u.data, ref.v.data]
    dec = JpegDecoderSession(header, device=gpu)
    fn = getattr(huffman_decode, wrapper)
    before = fn.launches
    for planes in dec.decode_device_batch([payload] * 3):
        for c, p, r in zip(dec.components, planes, ref):
            assert np.array_equal(
                p[:c.actual_height, :c.actual_width].cpu().numpy(), r)
    got = dec.decode_device(payload)
    assert fn.launches == before + 2
    for p, r in zip((got.y.data, got.u.data, got.v.data), ref):
        assert np.array_equal(p, r)
    outs = JpegTranscodeSession(header, 75, 1, device=gpu) \
        .transcode_batch([payload] * 2)
    assert outs == JpegTranscodeSession(header, 75, 1, device=gpu,
                                        entropy_out="host") \
        .transcode_batch([payload] * 2)


def _long_rows(gpu, S, L, seed, mcu_rows=1):
    """(S, L) rows of segments of ``mcu_rows`` MCU rows of a 3840-wide
    4:2:0 q90 frame (1,440 blocks and ~13.5 KB a row, encoded on the
    card): every other row with random bytes after its segment up to L
    (read by the guessed subsequences of K6 and of K5's "row" regime, never
    by the true decode), the rest zero-padded; and the segments' decode
    session."""
    from chip_smoke import synth_frames

    h = 16 * mcu_rows * S
    enc = JpegEncoderSession(Parameters.c420(3840, h, 90), 240 * mcu_rows,
                             device=gpu)
    stream = enc.encode_device_batch(synth_frames(1, seed, 3840, h))[0]
    bits = BitReader(stream)
    dec = JpegDecoderSession(Header.decode(bits), device=gpu)
    d = destuff_dispatch([stream[bits.bit_pos >> 3:]], S)
    rng = np.random.default_rng(seed)
    rows = np.zeros((S, L), np.uint8)
    for s in range(S):
        n, st = int(d.lens[0, s]), int(d.starts[0, s])
        assert n + 4 <= L
        rows[s, :n] = d.flat[st:st + n]
        if s % 2:
            rows[s, n + 4:] = rng.integers(0, 256, L - n - 4)
    return rows, dec


@pytest.mark.parametrize("L", [16383, 16385, "limit"])
def test_streamed_kernel_on_long_rows(gpu, L):
    """K6 on rows around its shared-memory staging bound (kRowStage =
    16,384 bytes: staged at 16,383, read from global memory at 16,385) and
    at the longest row the auto route gives it (the max_win_bs limit,
    28,675 bytes), with the matrix 16-byte aligned and one byte off (odd
    L: rows alternate 4-byte alignment either way), equal to its plain
    version (run on the host: a row of 1,440 blocks is ~23,000 steps)."""
    from video_coding_tpu_torch.entropy.decode_tables import max_win_bs

    if L == "limit":
        L = max(n for n in range(16385, 65536) if max_win_bs(n))
        assert L == 28675 and not max_win_bs(L + 1)
    S, B = 8, 1440
    rows, dec = _long_rows(gpu, S, L, seed=L)
    st = dec.state
    segb = np.full(S, B, np.int32)
    segb[2] = B // 2
    tabs = tuple(t.cpu() for t in (st.lo, st.hi, st.offset, st.values))
    kw = dict(blocks_per_segment=B, n_components=3)
    sched = dec._comp_sched.cpu()
    ref = huffman_decode.decode_segments_streamed_plain(
        torch.from_numpy(rows), torch.from_numpy(segb), sched, *tabs, **kw)
    buf = torch.zeros(S * L + 32, dtype=torch.uint8, device=gpu)
    for shift in (0, 1):
        view = buf[16 + shift:16 + shift + S * L].view(S, L)
        view.copy_(torch.from_numpy(rows))
        got = huffman_decode.decode_segments_streamed(
            view, torch.from_numpy(segb).to(gpu), sched.to(gpu),
            *(t.to(gpu) for t in tabs), **kw)
        assert torch.equal(got.cpu(), ref)
        rounds = huffman_decode.decode_segments_streamed.stats.cpu()[:, 0]
        assert int(rounds.min()) >= 1


@pytest.mark.parametrize("S,L,B", [(33, 513, 12), (100, 2048, 30),
                                   (64, 32768, 1440)])
def test_padded_kernel_unstaged_without_lane_buffer(gpu, S, L, B):
    """K5 with more than one CTA of rows (32 a CTA), rows too long to
    stage (32·L > kStageBytes from L = 512 on) and lanes too long for the
    lane buffer (B >= 12), on chip_smoke.k5_rows, in the "lane" regime
    (L < K5_ROW_MIN_BYTES); and on real one-MCU-row segments of a
    3840-wide frame at B = 1,440 and L = 32,768, which k5_regime sends to
    the "row" regime (test_padded_lane_regime_on_long_rows holds the
    "lane" regime on such rows); equal to its plain version (run on the
    host)."""
    from chip_smoke import k5_rows

    dec, tabs = _tables(gpu)
    rng = np.random.default_rng(S)
    rows = k5_rows(dec, S, L, B, rng)
    if B == 1440:
        real, dec = _long_rows(gpu, 8, L, seed=B)
        rows[8:16] = real
        st = dec.state
        tabs = (st.lo, st.hi, st.offset, st.values)
    segb = rng.integers(0, B + 1, S).astype(np.int32)
    segb[:16] = B
    sched = np.resize(dec.comp_idx[:6], B).astype(np.int32)
    kw = dict(blocks_per_segment=B, n_components=3)
    args = (torch.from_numpy(rows), torch.from_numpy(segb),
            torch.from_numpy(sched))
    ref = huffman_decode.decode_segments_plain(
        *args, *(t.cpu() for t in tabs), **kw)
    got = huffman_decode.decode_segments(*(a.to(gpu) for a in args), *tabs,
                                         **kw)
    assert torch.equal(got.cpu(), ref)


def _k5_row_call(gpu, seg, segb, sched, tabs, kw, staged=True):
    """K5 in its "row" regime on ``seg``, its output and scratch from
    torch.empty over poisoned memory (so every block must be written):
    one launch, counted in ``row_launches``, and one lookup table; each
    row staged in shared memory or not, as ``staged`` says. Returns the
    output and the (S, 4) stats on the host."""
    S, L = seg.shape
    B = kw["blocks_per_segment"]
    assert huffman_decode.k5_regime(S, L, B) == "row"
    poison = torch.full((S * B * 256 + S * L * 8 + (4 << 20),), 0x7F,
                        dtype=torch.uint8, device=gpu)
    torch.cuda.synchronize()
    del poison
    fn = huffman_decode.decode_segments
    before = (fn.launches, fn.row_launches,
              huffman_decode.decode_lut.launches)
    got = fn(seg, segb, sched, *tabs, **kw)
    assert (fn.launches, fn.row_launches,
            huffman_decode.decode_lut.launches) == tuple(
                b + 1 for b in before)
    stats = fn.stats.cpu()
    assert stats.shape == (S, len(huffman_decode.K5_ROW_STATS))
    rounds, n_sub, threads, in_smem = stats.T
    assert bool((in_smem == int(staged)).all())
    nblk = segb.cpu().clamp(min=0)
    assert bool(((rounds == 0) == (nblk == 0)).all())
    assert bool((threads > 0).all())
    U = huffman_decode.PADDED_ROW_SUB_BITS
    assert int(n_sub.max()) <= -(-(8 * L + 32) // U)
    return got, stats


@pytest.mark.parametrize("shift", [0, 1])
def test_padded_row_regime_on_two_row_lanes(gpu, shift):
    """K5's "row" regime on real two-MCU-row segments of a 3840-wide q90
    frame (the benchmark cell's lanes) at L = 32,768 and B = 2,880, staged
    in shared memory, the matrix 16-byte aligned and one byte off; equal
    to its plain version (run on the host)."""
    S, L, B = 8, 32768, 2880
    rows, dec = _long_rows(gpu, S, L, seed=B, mcu_rows=2)
    st = dec.state
    segb = np.full(S, B, np.int32)
    segb[2], segb[5] = B // 2, 0
    tabs = tuple(t.cpu() for t in (st.lo, st.hi, st.offset, st.values))
    kw = dict(blocks_per_segment=B, n_components=3)
    sched = dec._comp_sched.cpu()
    ref = huffman_decode.decode_segments_plain(
        torch.from_numpy(rows), torch.from_numpy(segb), sched, *tabs, **kw)
    buf = torch.zeros(S * L + 32, dtype=torch.uint8, device=gpu)
    view = buf[16 + shift:16 + shift + S * L].view(S, L)
    view.copy_(torch.from_numpy(rows))
    got, stats = _k5_row_call(gpu, view, torch.from_numpy(segb).to(gpu),
                              sched.to(gpu), tuple(t.to(gpu) for t in tabs),
                              kw)
    assert torch.equal(got.cpu(), ref)
    # 13.3-27.2 KB segments in subsequences of U bits
    U = huffman_decode.PADDED_ROW_SUB_BITS
    assert int(stats[:, 1].max()) >= 8 * 13000 // U


# rows of chip_smoke.k5_rows at the regime's shortest rows and at the
# cell's, one row and an odd count; the wrapper's U = 2,048 and U = 64
# (many subsequences a thread, many sync rounds)
@pytest.mark.parametrize("sub_bits", [2048, 64])
@pytest.mark.parametrize("malformed", [False, True])
@pytest.mark.parametrize("S,L", [(67, 4096), (67, 32768), (1, 4096)])
def test_padded_row_regime_on_adversarial_rows(gpu, monkeypatch, S, L,
                                               malformed, sub_bits):
    """K5's "row" regime on chip_smoke.k5_rows (random rows without guard
    bytes, cut rows, long codes, all-zero and all-0xFF rows, one symbol a
    block, a DC that passes int16), with seg_blocks of 0, of B and random,
    a luma-only and a 4:2:0 schedule, the session's tables and malformed
    ones, on the matrix and on a view one byte past a word boundary; equal
    to its plain version."""
    from chip_smoke import k5_rows

    monkeypatch.setattr(huffman_decode, "PADDED_ROW_SUB_BITS", sub_bits)
    dec, tabs = _tables(gpu)
    if malformed:
        tabs = _malformed_tables(gpu, seed=L + S)
    rng = np.random.default_rng(L + S + sub_bits)
    B = 120
    # the last S of k5_rows' rows: one row is its DC ramp
    rows = torch.from_numpy(k5_rows(dec, max(S, 7), L, B, rng)[-S:]).to(gpu)
    shifted = torch.empty(S * L + 8, dtype=torch.uint8, device=gpu)
    shifted[1:1 + S * L] = rows.view(-1)
    segb = rng.integers(0, B + 1, S).astype(np.int32)
    segb[:8] = B
    segb[8:9] = 0
    segb = torch.from_numpy(segb).to(gpu)
    kw = dict(blocks_per_segment=B, n_components=3)
    rounds = []
    for sched in (np.zeros(B), np.resize(dec.comp_idx[:6], B)):
        sched = torch.from_numpy(sched.astype(np.int32)).to(gpu)
        ref = huffman_decode.decode_segments_plain(rows, segb, sched, *tabs,
                                                   **kw)
        for seg in (rows, shifted[1:1 + S * L].view(S, L)):
            got, stats = _k5_row_call(gpu, seg, segb, sched, tabs, kw)
            assert torch.equal(got, ref)
            rounds.append(int(stats[:, 0].max()))
    if sub_bits == 64 and S > 1:
        assert max(rounds) >= 2


@pytest.mark.parametrize("sub_bits", [2048, 64])
def test_padded_row_regime_past_the_staging_limit(gpu, monkeypatch,
                                                  sub_bits):
    """K5's "row" regime on rows too long for shared memory (L = 262,144:
    peeks read global memory), real one-MCU-row segments (one row with
    random bytes after its segment) and a random row, at the wrapper's
    U = 2,048 and at U = 64; equal to its plain version (run on the
    host)."""
    monkeypatch.setattr(huffman_decode, "PADDED_ROW_SUB_BITS", sub_bits)
    S, L, B = 3, 262144, 1440
    real, dec = _long_rows(gpu, 8, L, seed=L)
    rng = np.random.default_rng(sub_bits)
    rows = np.concatenate([real[:2], rng.integers(0, 256, (1, L)).astype(
        np.uint8)])
    st = dec.state
    segb = np.array([B, B, B // 3], np.int32)
    tabs = tuple(t.cpu() for t in (st.lo, st.hi, st.offset, st.values))
    kw = dict(blocks_per_segment=B, n_components=3)
    sched = dec._comp_sched.cpu()
    ref = huffman_decode.decode_segments_plain(
        torch.from_numpy(rows), torch.from_numpy(segb), sched, *tabs, **kw)
    got, _stats = _k5_row_call(gpu, torch.from_numpy(rows).to(gpu),
                               torch.from_numpy(segb).to(gpu), sched.to(gpu),
                               tuple(t.to(gpu) for t in tabs), kw,
                               staged=False)
    assert torch.equal(got.cpu(), ref)


def test_padded_lane_regime_on_long_rows(gpu):
    """K5's "lane" regime on long rows, where k5_regime keeps it for their
    number (S = K5_ROW_MAX_ROWS + 1 rows at L = 32,768: 129 CTAs,
    unstaged, no lane buffer): real one-MCU-row segments of a 3840-wide q90 frame
    at B = 1,440, cycled over the rows, with seg_blocks of B, 0 and random;
    one launch, no "row" launch, no stats; every row equal to its plain
    version (run on the host on the distinct rows)."""
    S, L, B = huffman_decode.K5_ROW_MAX_ROWS + 1, 32768, 1440
    assert huffman_decode.k5_regime(S, L, B) == "lane"
    real, dec = _long_rows(gpu, 8, L, seed=S)
    st = dec.state
    rng = np.random.default_rng(S)
    nb = np.concatenate([[B, 0], rng.integers(0, B + 1, 6)]).astype(np.int32)
    tabs = tuple(t.cpu() for t in (st.lo, st.hi, st.offset, st.values))
    kw = dict(blocks_per_segment=B, n_components=3)
    sched = dec._comp_sched.cpu()
    ref = huffman_decode.decode_segments_plain(
        torch.from_numpy(real), torch.from_numpy(nb), sched, *tabs, **kw)
    pick = torch.arange(S) % 8
    rows = torch.from_numpy(real).to(gpu)[pick.to(gpu)]
    segb = torch.from_numpy(nb).to(gpu)[pick.to(gpu)]
    poison = torch.full((S * B * 256 + (4 << 20),), 0x7F, dtype=torch.uint8,
                        device=gpu)
    torch.cuda.synchronize()
    del poison
    fn = huffman_decode.decode_segments
    before = (fn.launches, fn.row_launches,
              huffman_decode.decode_lut.launches)
    got = fn(rows, segb, sched.to(gpu), *(t.to(gpu) for t in tabs), **kw)
    assert (fn.launches, fn.row_launches,
            huffman_decode.decode_lut.launches) == (
                before[0] + 1, before[1], before[2] + 1)
    assert fn.stats is None
    for i in range(8):
        assert torch.equal(got[pick.to(gpu) == i].cpu(),
                           ref[i].expand(int((pick == i).sum()), B, 64))


def test_decode_launch_span_names_the_k5_regime(gpu):
    """The huffman stage's ``decode.launch`` span carries ``k5_regime``:
    "row" on the benchmark cell's dispatch (4 frames of 3840x2160 q90, a
    restart every two MCU rows: 272 lanes of 2,880 blocks, L = 32,768),
    where every K5 launch is a "row" one, and "lane" on short lanes asked
    for K5 (256x128, a restart every MCU); planes equal to the
    host-entropy route's."""
    from chip_smoke import synth_frames
    from video_coding_tpu_torch.runtime import trace

    enc = JpegEncoderSession(Parameters.c420(3840, 2160, 90), 480,
                             device=gpu)
    streams = enc.encode_device_batch(synth_frames(4, 17, 3840, 2160))
    bits = BitReader(streams[0])
    header = Header.decode(bits)
    cell = (header, [s[bits.bit_pos >> 3:] for s in streams])
    for (header, payloads), regime in ((cell, "row"),
                                       (_streams(gpu), "lane")):
        dec = JpegDecoderSession(header, device=gpu,
                                 device_huffman="pallas")
        fn = huffman_decode.decode_segments
        before = (fn.launches, fn.row_launches)
        trace.start()
        try:
            got = dec.decode_device_batch(payloads)
        finally:
            rec = trace.stop()
        launched = (fn.launches - before[0], fn.row_launches - before[1])
        assert launched == ((1, 1) if regime == "row" else (1, 0))
        spans = [s for s in rec.spans if s.name == "decode.launch"
                 and s.attrs.get("stage") == "huffman"]
        assert [s.attrs.get("k5_regime") for s in spans] == [regime]
        if regime == "row":
            assert spans[0].attrs["route"] == "pallas"
        ref = dec.decode_batch(payloads)
        for g, r in zip(got, ref):
            for gp, rp in zip(g, (r.y.data, r.u.data, r.v.data)):
                assert np.array_equal(gp.cpu().numpy()[:rp.shape[0],
                                                       :rp.shape[1]], rp)
