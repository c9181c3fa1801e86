"""Frames past 1080p on the CPU, against the JAX package: the rules that
route a stream to a Huffman decode kernel or an encoder packer, on a grid
of lane counts, lane lengths and blocks a segment that covers the long
lanes of 4K and 7680x4800 frames; the decoder and encoder geometry of
every standard size at least 2048 wide; and a 3996x2160 frame (a partial
MCU column) through the host entropy engine's sessions. Tolerance: exact
equality of every rule, size, count, byte and plane."""

import functools
from types import SimpleNamespace

import numpy as np
import pytest

from video_coding_tpu.common import stdsizes as jstdsizes
from video_coding_tpu.common.bitstream import BitReader as JBitReader
from video_coding_tpu.common.bitstream import BitWriter as JBitWriter
from video_coding_tpu.common.frame import ChromaSubsampling, Frame
from video_coding_tpu.common.plane import Plane
from video_coding_tpu.entropy import pallas_decode as jpd
from video_coding_tpu.entropy import pallas_encode as jpe
from video_coding_tpu.model import decoder as jdecoder
from video_coding_tpu.model import encoder as jencoder
from video_coding_tpu.runtime import engine as jengine
from video_coding_tpu_torch.common import stdsizes
from video_coding_tpu_torch.common.bitstream import BitReader, BitWriter
from video_coding_tpu_torch.entropy import decode_tables, pack_stuff
from video_coding_tpu_torch.model import decoder as tdecoder
from video_coding_tpu_torch.model.header import (EncoderGeometry, Header,
                                                 Parameters)
from video_coding_tpu_torch.runtime import engine
from video_coding_tpu_torch.runtime.engine import (JpegDecoderSession,
                                                   JpegEncoderSession)

# lane lengths around the kernels' branches (K6 stages rows of up to
# 16,384 bytes, max_win_bs is 0 past 28,675) and the power-of-two widths
# the sessions give; blocks a segment from 1 to a one-MCU-row segment of
# a 7680-wide 4:4:4 frame and beyond; lanes a dispatch
L_GRID = [4, 5, 64, 131, 512, 513, 2048, 4096, 8192, 13787, 16383, 16384,
          16385, 20444, 23199, 27094, 28674, 28675, 28676, 32768, 65536]
B_GRID = [1, 3, 6, 12, 24, 30, 32, 33, 48, 240, 720, 1440, 2880, 5760]
S_GRID = [1, 32, 63, 64, 65, 127, 128, 540, 600, 1024, 4096]
PRESETS = ["c420", "c422", "c440", "c444", "monochrome"]
WIDE = sorted(n for n, (w, _h, _d) in jstdsizes.SIZES.items() if w >= 2048)


def _jax_auto(S: int, L: int, B: int) -> str:
    """The JAX package's auto route (runtime/engine.py,
    JpegDecoderSession._device_decode_fn) on its accelerator, with its own
    rules: its K1, K6 or K5 (the port's names), and K5 where it would
    leave its kernels for a compiler-generated loop (the port has none)."""
    def eligible(ch):
        return ch >= 128 and S >= 64

    lanes = jpd.max_lanes_t(L, B)
    if eligible(lanes):
        return "pallas_t"
    if lanes == 0 and jpd.max_win_bs(L) and eligible(jpd.BS_LANES):
        return "streamed"
    return "pallas"


@pytest.mark.parametrize("L", L_GRID)
def test_decode_routing_rules_equal_the_jax_package(L):
    assert decode_tables.max_win_bs(L) == jpd.max_win_bs(L)
    assert decode_tables.BS_LANES == jpd.BS_LANES
    for B in B_GRID:
        assert decode_tables.max_lanes_t(L, B) == jpd.max_lanes_t(L, B)
        assert decode_tables.max_lane_chunk(L, B) == jpd.max_lane_chunk(L, B)
        lanes_words = jpd.max_lanes_t(L + 48, B)
        for S in S_GRID:
            assert decode_tables.auto_strategy(S, L, B) == _jax_auto(S, L, B)
            # the flat-buffer route (the JAX package's use_words)
            assert decode_tables.flat_words_route(S, L, B, "auto") == (
                lanes_words != 0 and lanes_words >= 128 and S >= 64)


def test_max_win_bs_limit_is_where_path_m_puts_it():
    """The longest lane K6 takes under the auto route, 28,675 bytes, in
    both packages; one-MCU-row lanes of 4K q95 and 7680x4800 q90 sit
    between K6's staging bound and it, and their power-of-two session
    widths past it."""
    limit = max(L for L in range(16385, 65536) if jpd.max_win_bs(L))
    assert limit == 28675
    assert decode_tables.max_win_bs(limit) and not \
        decode_tables.max_win_bs(limit + 1)
    for L in (23199, 27094, 20444):
        assert decode_tables.auto_strategy(135, L, 1440) == "streamed"
    for B in (1440, 2880):
        assert decode_tables.auto_strategy(540, 16384, B) == "streamed"
        assert decode_tables.auto_strategy(540, 32768, B) == "pallas"


@pytest.mark.parametrize("B", B_GRID)
def test_encoder_packer_rules_equal_the_jax_package(B):
    budgets = [64, 136, 640, 1216, B * 24 + 64, B * 128 + 64, B * 512 + 64,
               1 << 16]
    for msb in budgets:
        ch = jpe.max_lane_chunk(B, msb)
        assert pack_stuff.max_lane_chunk(B, msb) == ch
        for S in S_GRID:
            stub = SimpleNamespace(blocks_per_segment=B, device_pack="auto")
            want = ("gather" if not (ch >= 128 and S >= 64) else
                    "fused" if B <= jpe.FUSED_MAX_BLOCKS else "split")
            assert JpegEncoderSession._pack_route(stub, S, msb) == want
    assert pack_stuff.FUSED_MAX_BLOCKS == jpe.FUSED_MAX_BLOCKS


def _headers(preset: str, w: int, h: int, ri: int):
    """Each package's header bytes for a preset, and its own parse of
    them into its golden decoder's geometry."""
    tw = BitWriter()
    EncoderGeometry(getattr(Parameters, preset)(w, h, 90), ri) \
        .write_headers(tw)
    jw = JBitWriter()
    jencoder.Encoder(getattr(jencoder.Parameters, preset)(w, h, 90), jw,
                     restart_interval=ri).write_headers()
    tb, jb = tw.get_buffer(), jw.get_buffer()
    return tb, jb, (tdecoder.Decoder(Header.decode(BitReader(tb)),
                                     BitReader(b"\x00")),
                    jdecoder.Decoder(jdecoder.Header.decode(JBitReader(jb)),
                                     JBitReader(b"\x00")))


def _layout(dec) -> tuple:
    comps = tuple((c.decoded_width, c.decoded_height, c.actual_width,
                   c.actual_height, c.component.horizontal_sampling_factor,
                   c.component.vertical_sampling_factor)
                  for c in dec.components)
    n_blocks = sum(c[0] * c[1] // 64 for c in comps)
    mcu = sum(c[4] * c[5] for c in comps)
    return (comps, dec.macroblocks_wide, dec.macroblocks_high,
            dec.restart_interval, n_blocks, mcu)


@pytest.mark.parametrize("name", WIDE)
def test_large_geometry_equals_the_jax_package(name):
    """At every standard size at least 2048 wide, every preset sampling
    and ri 0, 1 and one MCU row: the headers, the components' padded and
    actual sizes, MCUs across and down, blocks a frame and a MCU, blocks
    a segment, segments a frame, the last segment's blocks, the indexed
    route's stride, and the encoder's segment and wire geometry."""
    w, h, _d = jstdsizes.SIZES[name]
    assert stdsizes.SIZES[name] == jstdsizes.SIZES[name]
    for preset in PRESETS:
        tscans = EncoderGeometry(getattr(Parameters, preset)(w, h, 90)).scans
        jscans = jencoder.Encoder(
            getattr(jencoder.Parameters, preset)(w, h, 90)).scans
        assert [(s.hscale, s.vscale, s.width, s.height) for s in tscans] == \
            [(s.hscale, s.vscale, s.plane.width, s.plane.height)
             for s in jscans]
        mcu_w = 8 * max(s.hscale for s in tscans)
        for ri in (0, 1, -(-w // mcu_w)):
            tb, jb, (tdec, jdec) = _headers(preset, w, h, ri)
            assert tb == jb
            layout = _layout(tdec)
            assert layout == _layout(jdec)
            _c, mbw, mbh, ri_hdr, n_blocks, mcu = layout
            assert ri_hdr == ri and n_blocks == mbw * mbh * mcu
            B = ri * mcu if ri else n_blocks
            stub = SimpleNamespace(n_blocks=n_blocks, blocks_per_segment=B,
                                   mcu_size=mcu, mesh=None)
            n_seg = JpegDecoderSession.n_segments.fget(stub)
            assert n_seg == -(-n_blocks // B)
            assert JpegDecoderSession._expected_seg_blocks(stub, n_seg)[-1] \
                == (n_blocks % B or B)
            assert JpegDecoderSession._index_stride(stub) == \
                jengine.JpegDecoderSession._index_stride(stub)
            geo = JpegEncoderSession._enc_geometry(stub, B * 24 + 64)
            m_out = (B * 24 + 64) + (B * 24 + 64) // 4 + 8
            assert geo == (B, n_blocks, n_seg, n_seg, n_seg * B, m_out,
                           n_seg * m_out + 2 * n_seg)


@pytest.mark.parametrize("preset", PRESETS + ["h2v1", "h1v2"])
def test_vectorised_block_schedule_equals_the_golden_models(preset):
    """The sessions' block_schedule_array equals the port's and the JAX
    package's golden block_schedule, encoder and decoder, at sizes with
    partial MCUs."""
    layouts = {"h2v1": (2, 1, 1, 1, 1, 1), "h1v2": (1, 2, 1, 1, 1, 1)}
    for w, h in ((1, 1), (61, 45), (252, 34), (3996 // 9, 2160 // 27)):
        if preset in layouts:
            params = Parameters.yuv(w, h, 90, layouts[preset])
            jparams = jencoder.Parameters.yuv(w, h, 90, layouts[preset])
        else:
            params = getattr(Parameters, preset)(w, h, 90)
            jparams = getattr(jencoder.Parameters, preset)(w, h, 90)
        geom = EncoderGeometry(params, 1)
        want = np.array(jencoder.Encoder(jparams).block_schedule())
        assert np.array_equal(geom.block_schedule_array(), want)
        assert np.array_equal(geom.block_schedule_array(),
                              np.array(geom.block_schedule()))
        w_ = BitWriter()
        geom.write_headers(w_)
        hdr = Header.decode(BitReader(w_.get_buffer()))
        tdec = tdecoder.Decoder(hdr, BitReader(b"\x00"))
        assert np.array_equal(tdec._geometry.block_schedule_array(), want)


@functools.lru_cache(maxsize=None)
def _dc4k_frame():
    from chip_smoke import synth_frames

    return synth_frames(1, 1234, 3996, 2160)[0]


def test_dc4k1_frame_through_native_sessions_equals_the_jax_package():
    """One 3996x2160 4:2:0 frame (249.75 MCUs across: a partial MCU
    column), q90 ri=1: the port's CPU encoder session with
    entropy="native" gives the JAX package's bytes, and the port's decoder
    session with entropy="native" decodes them to the JAX package's
    planes; the sessions' geometry is the JAX sessions'."""
    y, u, v = _dc4k_frame()
    w, h = 3996, 2160
    jenc = jengine.JpegEncoderSession(jencoder.Parameters.c420(w, h, 90), 1,
                                      entropy="native")
    want = jenc.encode(Frame(Plane(data=y), Plane(data=u), Plane(data=v),
                             ChromaSubsampling.C420))
    enc = JpegEncoderSession(Parameters.c420(w, h, 90), 1, device="cpu",
                             entropy="native")
    assert enc.encode((y, u, v)) == want
    for a in ("n_blocks", "blocks_per_segment"):
        assert getattr(enc, a) == getattr(jenc, a)
    assert np.array_equal(enc.comp_idx, jenc.comp_idx)
    bits = BitReader(want)
    dec = JpegDecoderSession(Header.decode(bits), device="cpu",
                             entropy="native")
    jbits = JBitReader(want)
    jdec = jengine.JpegDecoderSession(jdecoder.Header.decode(jbits),
                                      entropy="native")
    payload = want[bits.bit_pos >> 3:]
    assert jbits.bit_pos == bits.bit_pos
    for a in ("n_blocks", "blocks_per_segment"):
        assert getattr(dec, a) == getattr(jdec, a)
    for (ti, tny, tnx), (ji, jny, jnx) in zip(dec.plane_geom,
                                              jdec.plane_geom):
        assert (tny, tnx) == (jny, jnx) and np.array_equal(ti, ji)
    got, ref = dec.decode(payload), jdec.decode(payload)
    for p in "yuv":
        assert np.array_equal(getattr(got, p).data, getattr(ref, p).data)
    assert got.y.data.shape == (h, w) and got.u.data.shape == (h // 2,
                                                               w // 2)


def test_a_dispatch_of_2_gib_is_refused_not_wrapped():
    """K1 and K7 take each lane's start in the dispatch's flat buffer as
    int32: a dispatch whose entropy data reach 2 GiB (~40 7680x4800 4:4:4
    q100 frames) would wrap the starts negative and the kernel would read
    outside the buffer. The flat route and the indexed route refuse it;
    one byte less still runs."""
    segb = np.full(3, 6, np.int32)
    with pytest.raises(ValueError, match="2 GiB"):
        engine._lane_plan(np.arange(3, dtype=np.int64) << 30,
                          np.full(3, 1 << 30, np.int64), segb)
    lens = np.array([(1 << 30) - 1, 1 << 30], np.int64)
    plan = engine._lane_plan(np.array([0, (1 << 30) - 1], np.int64), lens,
                             segb[:2])
    inv = plan.inv_perm
    assert list(plan.starts[inv]) == [0, (1 << 30) - 1] and \
        list(plan.lens[inv]) == list(lens)
    engine._check_flat_bytes((1 << 31) - 1)
    with pytest.raises(ValueError, match="2 GiB"):
        engine._check_flat_bytes(1 << 31)
