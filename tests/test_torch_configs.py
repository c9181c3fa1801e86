"""The configurations beyond 4:2:0 at q75-q90 that the JAX package takes,
on the CPU (every kernel through its plain version), against the JAX
sessions and the golden model: the K4/K8 packer boundary at every
sampling (libjpeg's 2x1 and 1x2 layouts of 4:2:2 and 4:4:0 too), q=1
and q=100 with the budget ladder, a monochrome stream with one MCU row
a segment through K6's plain version, and libjpeg-turbo streams made by
PIL through every decode route and the transcode. Tolerance: exact
equality of planes and bytes."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from video_coding_tpu.common.bitstream import BitReader as JBitReader
from video_coding_tpu.common.frame import ChromaSubsampling as JSub
from video_coding_tpu.common.frame import Frame as JFrame
from video_coding_tpu.common.plane import Plane as JPlane
from video_coding_tpu.entropy import tpu_encode
from video_coding_tpu.model import decoder as mdec
from video_coding_tpu.model import encoder as menc
from video_coding_tpu.runtime import engine as jengine
from video_coding_tpu_torch import state
from video_coding_tpu_torch.common.frame import ChromaSubsampling, Frame
from video_coding_tpu_torch.common.plane import Plane
from video_coding_tpu_torch.entropy import huffman_decode, pack_stuff
from video_coding_tpu_torch.model.header import Parameters
from video_coding_tpu_torch.runtime import engine
from video_coding_tpu_torch.runtime.engine import (JpegDecoderSession,
                                                   JpegEncoderSession,
                                                   JpegTranscodeSession,
                                                   decode_jpeg)

from _torch_fixtures import header_payload

sys.path.insert(0, str(Path(__file__).parent / "data" / "torch_foreign"))
import make_foreign  # noqa: E402

# sampling → (Y, Cb, Cr) factors as Parameters.yuv takes them, the frame
# class of its planes; None is monochrome
LAYOUTS = {
    "422": ((2, 2, 1, 2, 1, 2), "C422"),
    "422 h2v1": ((2, 1, 1, 1, 1, 1), "C422"),
    "440": ((2, 2, 2, 1, 2, 1), "C440"),
    "440 h1v2": ((1, 2, 1, 1, 1, 1), "C440"),
    "444": ((1, 1, 1, 1, 1, 1), "C444"),
    "420": ((2, 2, 1, 1, 1, 1), "C420"),
    "mono": (None, None),
}


def _frame(layout: str, w: int, h: int, seed: int):
    """(JAX-package picture, port picture) of the same arrays: a Frame, or
    a Plane for monochrome."""
    rng = np.random.default_rng(seed)

    def plane(pw, ph):
        yy, xx = np.mgrid[0:ph, 0:pw]
        p = 110 + 60 * np.sin(xx / 6.0) * np.cos(yy / 4.0) + 0.5 * xx
        return np.clip(p + rng.normal(0, 12, p.shape), 0, 255) \
            .astype(np.uint8)

    sub = LAYOUTS[layout][1]
    y = plane(w, h)
    if sub is None:
        return JPlane(data=y), Plane(data=y)
    cs = ChromaSubsampling[sub]
    u, v = (plane(cs.chroma_width(w), cs.chroma_height(h)) for _ in "uv")
    return (JFrame(JPlane(data=y), JPlane(data=u), JPlane(data=v),
                   JSub[sub]),
            Frame(Plane(data=y), Plane(data=u), Plane(data=v), cs))


def _params(layout: str, w: int, h: int, q: int):
    """(JAX-package Parameters, port Parameters)."""
    scales = LAYOUTS[layout][0]
    if scales is None:
        return (menc.Parameters.monochrome(w, h, q),
                Parameters.monochrome(w, h, q))
    return (menc.Parameters.yuv(w, h, q, scales),
            Parameters.yuv(w, h, q, scales))


def _mcu(layout: str) -> int:
    s = LAYOUTS[layout][0]
    return 1 if s is None else s[0] * s[1] + 2 * s[2] * s[3]


def _routes(monkeypatch):
    """Record the packers the port's encoder calls."""
    calls = []
    for mod, name in ((engine, "encode_segments"),
                      (pack_stuff, "encode_segments_split")):
        fn = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda *a, _fn=fn, _n=name, **k: (calls.append(_n),
                                                         _fn(*a, **k))[1])
    return calls


def _port_encoder(jenc, params, ri, **kw) -> JpegEncoderSession:
    """A port encoder session computing with the JAX session's arrays."""
    enc = JpegEncoderSession(params, ri, device="cpu", **kw)
    enc.load_state(state.EncoderState.from_numpy({
        "quant": jenc.quant, "comp_idx": jenc.comp_idx,
        "perm": np.asarray(jenc._perm_dev), "gather": jenc.gather,
        "tables": tpu_encode.device_encoder_tables(jenc.tables),
        "prev_same_comp": np.asarray(jenc._enc_geometry(64)[6])}, "cpu"))
    return enc


@pytest.mark.parametrize("side", ["fused", "split"])
@pytest.mark.parametrize("layout",
                         ["422", "422 h2v1", "440", "440 h1v2", "444",
                          "mono"])
def test_pack_boundary_per_sampling(layout, side, monkeypatch):
    """The last restart interval whose segments K4 takes (B <= 32) and the
    first that goes to K9 + K8 (B = 33..40), at every sampling, computing
    with the JAX session's arrays: the golden model's bytes."""
    w, h, q = 64, 48, 75
    ri = 32 // _mcu(layout) + (side == "split")
    jparams, params = _params(layout, w, h, q)
    pics = [_frame(layout, w, h, seed) for seed in (1, 2)]
    if layout == "mono":
        golden = [menc.encode_monochrome(j, q, restart_interval=ri)
                  for j, _ in pics]
    else:
        golden = [menc._encode_with_params(j, jparams, ri) for j, _ in pics]
    calls = _routes(monkeypatch)
    enc = _port_encoder(jengine.JpegEncoderSession(jparams, ri), params, ri,
                        device_pack="pallas")
    B = enc.blocks_per_segment
    assert (B <= pack_stuff.FUSED_MAX_BLOCKS) == (side == "fused")
    assert 30 <= B <= 40
    assert enc.encode_device_batch([p for _, p in pics]) == golden
    assert set(calls) == {"encode_segments" if side == "fused"
                          else "encode_segments_split"}


@pytest.mark.parametrize("q", [1, 100])
@pytest.mark.parametrize("layout", ["420", "444"])
def test_quality_extremes_and_budget_ladder(layout, q, monkeypatch):
    """q=1 (quant 255) and q=100 (quant 1) through K4 (ri=1) and K9 + K8
    (B > 32), computing with the JAX session's arrays, and the transcode:
    the golden model's bytes (the JAX transcode's too); at q=100 rung 1 of
    the budget ladder (B*24+64 bytes a segment) overflows and a later rung
    gives them."""
    w, h = 48, 32
    ri_split = {"420": 8, "444": 11}[layout]
    jparams, params = _params(layout, w, h, q)
    pics = [_frame(layout, w, h, seed) for seed in (3, 4)]
    for ri in (1, ri_split):
        golden = [menc._encode_with_params(j, jparams, ri) for j, _ in pics]
        enc = _port_encoder(jengine.JpegEncoderSession(jparams, ri), params,
                            ri, device_pack="pallas")
        rungs, pack = [], enc._pack_graph

        def recorded(qc_seg, f, msb, first=0, pack=pack, rungs=rungs):
            out = pack(qc_seg, f, msb, first)
            rungs.append((msb, bool(out[3])))
            return out
        monkeypatch.setattr(enc, "_pack_graph", recorded)
        assert enc.encode_device_batch([p for _, p in pics]) == golden
        rung1 = enc.blocks_per_segment * 24 + 64
        assert rungs[0][0] == rung1
        assert rungs[-1][1] is False
        assert rungs[0][1] is (q == 100)
    # the transcode to the extreme quality from a q90 stream
    src = menc._encode_with_params(pics[0][0], _params(layout, w, h, 90)[0],
                                   1)
    jheader, payload = header_payload(src)
    ref = menc._encode_with_params(mdec.decode_a_frame(src), jparams, 1)
    assert jengine.JpegTranscodeSession(jheader, q, 1).transcode(payload) \
        == ref
    header, _ = _split(src)
    for out in ("device", "host"):
        assert JpegTranscodeSession(header, q, 1, device="cpu",
                                    entropy_out=out).transcode(payload) == ref


def _split(stream: bytes):
    from video_coding_tpu_torch.common.bitstream import BitReader
    from video_coding_tpu_torch.model.header import Header

    bits = BitReader(stream)
    header = Header.decode(bits)
    return header, stream[bits.bit_pos >> 3:]


def _planes(pic) -> list:
    if isinstance(pic, (Frame, JFrame)):
        pic = [pic.y, pic.u, pic.v]
    if isinstance(pic, (list, tuple)):
        return [np.asarray(p.data if isinstance(p, (Plane, JPlane)) else p)
                for p in pic]
    raise TypeError(type(pic))


def _assert_planes(got, ref):
    got, ref = _planes(got), _planes(ref)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_monochrome_one_mcu_row_through_k6(monkeypatch):
    """A monochrome stream with one MCU row a segment (period 1) through
    K6's plain version, routed there as the card routes 1080p rows: the
    JAX session's planes and the golden model's."""
    w, h, ri = 64, 40, 8
    jplane, _ = _frame("mono", w, h, 5)
    stream = menc.encode_monochrome(jplane, 90, restart_interval=ri)
    jheader, payload = header_payload(stream)
    ref = jengine.JpegDecoderSession(jheader).decode_device_batch(
        [payload, payload])
    bits = JBitReader(stream)
    golden = mdec.Decoder(mdec.Header.decode(bits), bits)
    golden.decode()
    calls = []
    streamed = huffman_decode.decode_segments_streamed
    monkeypatch.setattr(huffman_decode, "decode_segments_streamed",
                        lambda *a, **k: (calls.append(k),
                                         streamed(*a, **k))[1])
    monkeypatch.setattr(huffman_decode, "auto_strategy",
                        lambda S, L, B: "streamed")
    monkeypatch.setattr(engine, "flat_words_route", lambda *a: False)
    header, _ = _split(stream)
    dec = JpegDecoderSession(header, device="cpu")
    assert dec.blocks_per_segment == w // 8
    got = dec.decode_device_batch([payload, payload])
    assert len(calls) == 1 and calls[0]["n_components"] == 1
    for g, r in zip(got, ref):
        _assert_planes([p.numpy() for p in g], [np.asarray(p) for p in r])
    _assert_planes(dec.decode_device(payload), golden.get_planes())


# (PIL subsampling, quality, optimize, restart option, width, height)
LIBJPEG = {
    # 192 blocks: the smallest restart-free frame of the indexed route
    "422 q75 optimized, no restart": ("4:2:2", 75, True, {}, 96, 64),
    "422 q50 restart every MCU": ("4:2:2", 50, False,
                                  {"restart_marker_blocks": 1}, 64, 48),
    "420 q90 optimized, a restart every row": (
        "4:2:0", 90, True, {"restart_marker_rows": 1}, 96, 64),
    "420 q10 restart every 7 MCUs": ("4:2:0", 10, False,
                                     {"restart_marker_blocks": 7}, 80, 48),
    "444 q100 optimized, restart every MCU": (
        "4:4:4", 100, True, {"restart_marker_blocks": 1}, 64, 48),
    "444 q85 a restart every row, odd size": (
        "4:4:4", 85, False, {"restart_marker_rows": 1}, 45, 29),
}


def _libjpeg(case: str) -> bytes:
    sub, q, opt, rst, w, h = LIBJPEG[case]
    return make_foreign.jpeg_bytes(make_foreign.rgb_frame(w, h, 7),
                                   subsampling=sub, quality=q, optimize=opt,
                                   **rst)


@pytest.mark.parametrize("case", list(LIBJPEG))
def test_libjpeg_stream_every_decode_route(case):
    """A libjpeg-turbo stream through decode_device (every strategy and
    gather mode), decode_device_batch, decode_device_rgb, the host
    routes, decode_jpeg and the transcode to q75 ri=1: the JAX session's
    planes and the golden model's planes and bytes."""
    stream = _libjpeg(case)
    golden = mdec.decode_a_frame(stream)
    jheader, payload = header_payload(stream)
    _assert_planes(jengine.JpegDecoderSession(jheader).decode_device(payload),
                   golden)
    header, _ = _split(stream)
    for kw in ({}, {"device_huffman": "pallas"},
               {"device_huffman": "pallas_t"}, {"device_huffman": "range"},
               {"device_huffman": "lut"}, {"decode_gather": "dma"}):
        dec = JpegDecoderSession(header, device="cpu", **kw)
        _assert_planes(dec.decode_device(payload), golden)
    dec = JpegDecoderSession(header, device="cpu")
    # a restart-free stream takes the index scan's virtual segments
    assert dec._indexable() == (not LIBJPEG[case][3])
    for planes in dec.decode_device_batch([payload, payload]):
        _assert_planes([p[:c.actual_height, :c.actual_width].numpy()
                        for c, p in zip(dec.components, planes)], golden)
    ref_rgb = dec._rgb_tail([torch.from_numpy(p) for p in _planes(golden)])
    assert torch.equal(dec.decode_device_rgb(payload), ref_rgb)
    for entropy in ("native", "python", "tpu"):
        _assert_planes(JpegDecoderSession(header, device="cpu",
                                          entropy=entropy).decode(payload),
                       golden)
    _assert_planes(decode_jpeg(stream, device="cpu"), golden)
    ref = {"4:2:0": menc.encode_420, "4:2:2": menc.encode_422,
           "4:4:4": menc.encode_444}[LIBJPEG[case][0]](
        golden, 75, restart_interval=1)
    for out in ("device", "host"):
        assert JpegTranscodeSession(header, 75, 1, device="cpu",
                                    entropy_out=out).transcode(payload) \
            == ref


@pytest.mark.parametrize("layout,w,h,encode", [
    ("422 h2v1", 64, 40, menc.encode_422),    # libjpeg's 4:2:2, 40 rows
    ("440 h1v2", 40, 48, menc.encode_440),    # libjpeg's 4:4:0, 40 columns
])
def test_transcode_of_a_shorter_mcu_than_the_preset(layout, w, h, encode):
    """A 4:2:2 stream in libjpeg's 2x1 layout whose height is not a
    multiple of 16 (a 1080p webcam frame's case), and a 4:4:0 stream in the
    1x2 layout whose width is not: the transcode's preset has a 16x16 MCU,
    so its planes are taller (wider) than the stream's decoded planes. The
    transcode gives the golden model's re-encode of the decoded frame,
    through the device and the host route (the JAX session refuses such a
    stream: "transcode geometry mismatch")."""
    jpic, pic = _frame(layout, w, h, 9)
    jparams, params = _params(layout, w, h, 90)
    for ri in (0, 2):
        stream = menc._encode_with_params(jpic, jparams, ri)
        ref = encode(mdec.decode_a_frame(stream), 75, restart_interval=1)
        header, payload = _split(stream)
        for out in ("device", "host"):
            trans = JpegTranscodeSession(header, 75, 1, device="cpu",
                                         entropy_out=out)
            assert trans.transcode_batch([payload, payload]) == [ref, ref]
    if layout == "422 h2v1":            # the same layout from libjpeg
        stream = make_foreign.jpeg_bytes(make_foreign.rgb_frame(w, h, 9),
                                         subsampling="4:2:2", quality=80)
        header, payload = _split(stream)
        assert JpegTranscodeSession(header, 75, 1, device="cpu") \
            .transcode(payload) == encode(mdec.decode_a_frame(stream), 75,
                                          restart_interval=1)
