"""Edge cases of the port on the CPU (every kernel through its plain
version, the host routes through the host entropy engine): the
counterparts of the JAX package's tests/test_fuzz.py,
test_quality_sweep.py and test_goldens.py, on synthetic frames only —
random frames, sizes, qualities, samplings and restart intervals; q10–95
on the four samplings; the sampling-factor mixes; odd geometries and
sizes ≡ 1 mod 16; q=1, 2 and 100; 16-bit DQT; truncated headers and
missing restart segments; monochrome streams on every route. Each result
is held against the JAX package's golden model (and, for the fuzz
streams, libjpeg through PIL). Tolerance: exact equality of planes and
bytes; libjpeg's luma within ±1."""

import functools
import io

import numpy as np
import pytest
import torch
from PIL import Image

from video_coding_tpu.common.bitstream import BitReader as JBitReader
from video_coding_tpu.common.bitstream import BitWriter as JBitWriter
from video_coding_tpu.common.frame import ChromaSubsampling as JSub
from video_coding_tpu.common.frame import Frame as JFrame
from video_coding_tpu.common.plane import Plane as JPlane
from video_coding_tpu.model import decoder as mdec
from video_coding_tpu.model import encoder as menc
from video_coding_tpu.model import markers as jmarkers
from video_coding_tpu_torch.common.bitstream import BitReader
from video_coding_tpu_torch.common.frame import ChromaSubsampling, Frame
from video_coding_tpu_torch.common.plane import Plane
from video_coding_tpu_torch.entropy import gather_pack, huffman_decode
from video_coding_tpu_torch.entropy import scan as tscan
from video_coding_tpu_torch.entropy.tables import (pack_decoder_tables,
                                                   pack_encoder_tables)
from video_coding_tpu_torch.model import decoder as tdec
from video_coding_tpu_torch.model.header import (DecodeError, Header,
                                                 Parameters)
from video_coding_tpu_torch.model.huffman import (AC_CHROMA, AC_LUMA,
                                                  DC_CHROMA, DC_LUMA, Lut)
from video_coding_tpu_torch.runtime.engine import (JpegDecoderSession,
                                                   JpegEncoderSession,
                                                   JpegTranscodeSession,
                                                   decode_jpeg, encode_jpeg)

ENCODERS = {"420": menc.encode_420, "422": menc.encode_422,
            "440": menc.encode_440, "444": menc.encode_444}
PRESETS = {"420": Parameters.c420, "422": Parameters.c422,
           "440": Parameters.c440, "444": Parameters.c444}
MCU_W = {"420": 16, "422": 16, "440": 16, "444": 8}


def _planes(pic) -> list:
    if hasattr(pic, "y"):
        return [pic.y.data, pic.u.data, pic.v.data]
    return [p.data for p in pic]


def _assert_planes(got, ref) -> None:
    got, ref = _planes(got), _planes(ref)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _port_frame(jframe) -> Frame:
    return Frame(Plane(data=jframe.y.data), Plane(data=jframe.u.data),
                 Plane(data=jframe.v.data),
                 ChromaSubsampling[jframe.chroma_subsampling.name])


def _split(stream: bytes):
    bits = BitReader(stream)
    header = Header.decode(bits)
    return header, stream[bits.bit_pos >> 3:]


def _golden(stream: bytes) -> list:
    """The golden model's cropped planes of a stream of any component
    count."""
    bits = JBitReader(stream)
    dec = mdec.Decoder(mdec.Header.decode(bits), bits)
    dec.decode()
    return dec.get_planes()


def _decode_routes(stream: bytes) -> None:
    """Every decode route of the port against the golden model: the
    device routes, the host-entropy routes by ``entropy`` (with resync)
    and ``decode_jpeg``."""
    golden = _golden(stream)
    header, payload = _split(stream)
    dec = JpegDecoderSession(header, device="cpu")
    _assert_planes(dec.decode_device(payload), golden)
    for got in dec.decode_device_batch([payload, payload]):
        _assert_planes(dec._to_frame(got), golden)
    chunk = next(dec.decode_device_batch_iter([payload], batch=1))
    _assert_planes(dec._to_frame([p[0] for p in chunk]), golden)
    for entropy in ("native", "python", "tpu"):
        d = JpegDecoderSession(header, device="cpu", entropy=entropy)
        _assert_planes(d.decode(payload), golden)
        _assert_planes(d.decode(payload, resync=True), golden)
        assert d.last_damaged_segments == []
    _assert_planes(decode_jpeg(stream, device="cpu"), golden)


# -- the fuzz cases (tests/test_fuzz.py) ------------------------------------
def _random_frame(rng, sub: str, w: int, h: int) -> JFrame:
    """Smooth-ish random content (pure noise stresses worst-case rates)."""
    f = JFrame.create(JSub[f"C{sub}"], w, h)
    base = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2))
    up = np.kron(base, np.ones((4, 4)))[:h, :w]
    f.y.data[...] = np.clip(up + rng.integers(-10, 10, (h, w)), 0,
                            255).astype(np.uint8)
    cw, ch = f.u.width, f.u.height
    f.u.data[...] = rng.integers(80, 180, (ch, cw), dtype=np.uint8)
    f.v.data[...] = rng.integers(80, 180, (ch, cw), dtype=np.uint8)
    return f


FUZZ = [("420", 48, 32, 75, 0), ("420", 52, 44, 30, 1),
        ("420", 160, 96, 95, 3), ("422", 64, 48, 50, 2),
        ("422", 36, 20, 85, 1), ("444", 40, 40, 60, 5),
        ("444", 24, 16, 90, 0)]


@pytest.mark.parametrize("sub,w,h,q,ri", FUZZ)
def test_fuzz_sessions_vs_model(sub, w, h, q, ri):
    rng = np.random.default_rng(w * 1000003 + h * 1009 + q * 31 + ri)
    jframe = _random_frame(rng, sub, w, h)
    model_bytes = ENCODERS[sub](jframe, q, restart_interval=ri)
    stream = encode_jpeg(_port_frame(jframe), q, ChromaSubsampling[f"C{sub}"],
                         restart_interval=ri, device="cpu")
    assert stream == model_bytes
    _decode_routes(stream)
    im = Image.open(io.BytesIO(stream))
    im.draft("YCbCr", im.size)
    luma = np.asarray(im.convert("YCbCr"))[:, :, 0]
    ours = decode_jpeg(stream, device="cpu").y.data
    assert np.abs(ours.astype(int) - luma.astype(int)).max() <= 1


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_entropy_roundtrip(seed):
    """Random quantized coefficients through the gather packer and the
    host engine, destuffed, then decoded on the device route and by the
    engine, come back exactly (segment sizes 4, 8, 16 and 48)."""
    rng = np.random.default_rng(seed)
    n = 48
    q = rng.integers(-200, 200, size=(n, 64)).astype(np.int32)
    q = np.where(rng.random((n, 64)) < rng.uniform(0.05, 0.9), q, 0)
    q[:, 0] = rng.integers(-500, 500, n)
    ci = np.tile(np.array([0, 0, 1, 2], dtype=np.int32), 12)
    enc_t = pack_encoder_tables([DC_LUMA, DC_CHROMA, DC_CHROMA],
                                [AC_LUMA, AC_CHROMA, AC_CHROMA])
    dec_t = pack_decoder_tables(
        [Lut(s.dc_code_table(), ac=False)
         for s in (DC_LUMA, DC_CHROMA, DC_CHROMA)],
        [Lut(s.ac_code_table(), ac=True)
         for s in (AC_LUMA, AC_CHROMA, AC_CHROMA)])
    bps = int(rng.choice([4, 8, 16, 48]))
    segments = gather_pack.encode_scan_tpu(q, ci, bps, enc_t, device="cpu")
    assert segments == tscan.encode_scan(q, ci, bps, enc_t)
    destuffed = [tscan.destuff_segments(s)[0] for s in segments]
    got = huffman_decode.decode_scan_tpu(destuffed, ci, bps, dec_t,
                                         device="cpu")
    np.testing.assert_array_equal(got, q)
    np.testing.assert_array_equal(tscan.decode_scan(destuffed, ci, bps,
                                                    dec_t), q)


# -- quality sweeps (tests/test_quality_sweep.py) ---------------------------
W, H = 64, 48


@functools.lru_cache(maxsize=None)
def _noise_frame(sub: str, seed: int = 7) -> JFrame:
    rng = np.random.default_rng(seed)
    s = JSub[f"C{sub}"]
    cw, ch = s.chroma_width(W), s.chroma_height(H)

    def plane(w, h):
        return JPlane(data=rng.integers(0, 256, (h, w)).astype(np.uint8))

    return JFrame(plane(W, H), plane(cw, ch), plane(cw, ch), s)


@pytest.mark.parametrize("interval", ["1", "row"])
@pytest.mark.parametrize("sub", list(ENCODERS))
def test_decode_device_quality_sweep(sub, interval):
    ri = 1 if interval == "1" else (W + MCU_W[sub] - 1) // MCU_W[sub]
    qs = (10, 30, 50, 75, 95) if interval == "1" else (10, 50, 95)
    for q in qs:
        stream = ENCODERS[sub](_noise_frame(sub), q, restart_interval=ri)
        header, payload = _split(stream)
        got = JpegDecoderSession(header, device="cpu").decode_device(payload)
        _assert_planes(got, mdec.decode_a_frame(stream))


@pytest.mark.parametrize("sub", list(ENCODERS))
def test_encode_device_quality_sweep(sub):
    for q in (30, 50, 95):
        ref = ENCODERS[sub](_noise_frame(sub), q, restart_interval=1)
        enc = JpegEncoderSession(PRESETS[sub](W, H, q), 1, device="cpu")
        assert enc.encode_device(_port_frame(_noise_frame(sub))) == ref
        assert enc.encode(_port_frame(_noise_frame(sub))) == ref


@pytest.mark.parametrize("out", ["device", "host"])
@pytest.mark.parametrize("sub", list(ENCODERS))
def test_transcode_quality_sweep(sub, out):
    stream = ENCODERS[sub](_noise_frame(sub), 50, restart_interval=2)
    header, payload = _split(stream)
    t = JpegTranscodeSession(header, quality=75, restart_interval=2,
                             device="cpu", entropy_out=out)
    assert t.transcode(payload) == ENCODERS[sub](
        mdec.decode_a_frame(stream), 75, restart_interval=2)


@pytest.mark.parametrize("scales", [(1, 2, 1, 1, 1, 1), (2, 2, 2, 1, 2, 1),
                                    (2, 1, 1, 1, 1, 1)])
def test_sampling_factor_mixes(scales):
    """The 4:4:0 foreign (Y 1x2) and preset forms and the 4:2:2 foreign
    form (Y 2x1) decode and encode exactly."""
    sub = "440" if scales[1] == 2 else "422"
    jframe = _noise_frame(sub)
    stream = menc._encode_with_params(
        jframe, menc.Parameters.yuv(W, H, 75, scales), restart_interval=1)
    _decode_routes(stream)
    enc = JpegEncoderSession(Parameters.yuv(W, H, 75, scales), 1,
                             device="cpu")
    assert enc.encode_device(_port_frame(jframe)) == stream
    assert enc.encode(_port_frame(jframe)) == stream


@pytest.mark.parametrize("sub,w,h", [("422", 250, 94), ("444", 132, 108)])
def test_indexed_foreign_geometry_sweep(sub, w, h):
    """Restart-free 4:2:2 and 4:4:4 streams of odd geometry decode through
    the indexed route (the engine's index scan, K1 with hooks)."""
    rng = np.random.default_rng(5)
    s = JSub[f"C{sub}"]
    jframe = JFrame(*(JPlane(data=rng.integers(0, 256, (ph, pw))
                             .astype(np.uint8))
                      for pw, ph in ((w, h), (s.chroma_width(w),
                                              s.chroma_height(h)),
                                     (s.chroma_width(w), s.chroma_height(h)))),
                    s)
    for q in (30, 75, 95):
        stream = ENCODERS[sub](jframe, q, restart_interval=0)
        header, payload = _split(stream)
        dec = JpegDecoderSession(header, device="cpu")
        assert dec._indexable()
        _assert_planes(dec.decode_device(payload),
                       mdec.decode_a_frame(stream))


# -- geometry and quality extremes (tests/test_goldens.py and the rest) ------
@pytest.mark.parametrize("w,h", [(17, 16), (16, 17), (33, 33)])
def test_sizes_one_mod_16(w, h):
    rng = np.random.default_rng(3)
    f = JFrame.create(JSub.C420, w, h)
    f.y.data[...] = rng.integers(0, 256, f.y.data.shape, dtype=np.uint8)
    f.u.data[...] = 128
    f.v.data[...] = 128
    data = menc.encode_420(f, 85)
    assert encode_jpeg(_port_frame(f), 85, device="cpu") == data
    dec = mdec.decode_a_frame(data)
    assert (dec.width, dec.height) == (w, h)
    _decode_routes(data)


@pytest.mark.parametrize("w,h,ri", [(1, 1, 0), (7, 200, 0), (8, 9, 0),
                                    (52, 44, 1)])
def test_odd_geometries(w, h, ri):
    rng = np.random.default_rng(w + h)
    jframe = _random_frame(rng, "420", w, h)
    stream = menc.encode_420(jframe, 70, restart_interval=ri)
    assert encode_jpeg(_port_frame(jframe), 70, restart_interval=ri,
                       device="cpu") == stream
    _decode_routes(stream)
    header, payload = _split(stream)
    t = JpegTranscodeSession(header, quality=80, restart_interval=1,
                             device="cpu")
    want = menc.encode_420(mdec.decode_a_frame(stream), 80,
                           restart_interval=1)
    assert t.transcode(payload) == want
    assert list(t.transcode_batch_iter([payload] * 3, batch=2)) == [want] * 3


@pytest.mark.parametrize("q", [1, 2, 100])
@pytest.mark.parametrize("sub", ["420", "444"])
def test_extreme_qualities_on_noise(sub, q):
    stream = ENCODERS[sub](_noise_frame(sub, seed=q), q, restart_interval=1)
    enc = JpegEncoderSession(PRESETS[sub](W, H, q), 1, device="cpu")
    frame = _port_frame(_noise_frame(sub, seed=q))
    assert enc.encode_device(frame) == stream
    for entropy in ("native", "python", "tpu"):
        assert JpegEncoderSession(PRESETS[sub](W, H, q), 1, device="cpu",
                                  entropy=entropy).encode(frame) == stream
    _decode_routes(stream)


@pytest.mark.parametrize("scale", [1, 300])
def test_16bit_dqt_stream_decodes(scale):
    """DQT segments with 16-bit elements (values up to 300 times the
    standard tables' in one case) decode as the golden model does."""
    rng = np.random.default_rng(4)
    f = JFrame.create(JSub.C420, 32, 32)
    f.y.data[...] = rng.integers(0, 256, (32, 32), dtype=np.uint8)
    f.u.data[...] = 128
    f.v.data[...] = 128
    stream = menc.encode_420(f, 75, restart_interval=1)
    out = bytearray()
    i = 0
    while i < len(stream):
        if stream[i] == 0xFF and stream[i + 1:i + 2] == b"\xdb":
            seg_len = (stream[i + 2] << 8) | stream[i + 3]
            dqt = jmarkers.Dqt.decode(JBitReader(stream[i + 2:
                                                       i + 2 + seg_len]))
            w = JBitWriter()
            jmarkers.Dqt(0, 16, dqt.table_identifier,
                         [min(65535, e * scale) for e in dqt.elements]
                         ).encode(w)
            out += b"\xff\xdb" + w.get_buffer()
            i += 2 + seg_len
        else:
            out.append(stream[i])
            i += 1
    wide = bytes(out)
    assert wide != stream
    golden = mdec.decode_a_frame(wide)
    if scale == 1:
        _assert_planes(golden, mdec.decode_a_frame(stream))
    _decode_routes(wide)


@pytest.mark.parametrize("data", [b"\xff\xd8\xff\xe0",
                                  b"\xff\xd8\xff\xc0\x00\x05\x08"])
def test_truncated_header_raises(data):
    with pytest.raises(mdec.DecodeError):
        mdec.decode_a_frame(data)
    with pytest.raises(DecodeError):
        tdec.decode_a_frame(data)
    with pytest.raises(DecodeError):
        decode_jpeg(data, device="cpu")


@pytest.mark.parametrize("use_native", [None, False])
def test_missing_restart_segments_raise(use_native):
    tables = pack_decoder_tables([Lut(DC_LUMA.dc_code_table(), ac=False)],
                                 [Lut(AC_LUMA.ac_code_table(), ac=True)])
    with pytest.raises(ValueError, match="restart segments"):
        tscan.decode_scan([b"\x00" * 4] * 2, np.zeros(8, np.int32), 2,
                          tables, use_native=use_native)


# -- monochrome on every route -----------------------------------------------
@pytest.mark.parametrize("w,h,ri", [(40, 24, 0), (40, 24, 1), (33, 17, 4),
                                    (128, 96, 0), (16, 8, 3)])
def test_monochrome_every_route(w, h, ri):
    """A one-component stream: the device routes (the indexed one at
    128x96), the host-entropy routes, the encoder's device and host
    routes; the RGB routes and the transcode refuse it."""
    rng = np.random.default_rng(w * h + ri)
    jplane = JPlane(data=rng.integers(0, 256, (h, w)).astype(np.uint8))
    stream = menc.encode_monochrome(jplane, 80, restart_interval=ri)
    _decode_routes(stream)
    header, payload = _split(stream)
    dec = JpegDecoderSession(header, device="cpu")
    assert dec._indexable() == ((w, h, ri) == (128, 96, 0))
    with pytest.raises(DecodeError):
        dec.decode_device_rgb(payload)
    with pytest.raises(DecodeError):
        JpegTranscodeSession(header, device="cpu")
    plane = Plane(data=jplane.data)
    for pack in ("xla", "pallas"):
        enc = JpegEncoderSession(Parameters.monochrome(w, h, 80), ri,
                                 device="cpu", device_pack=pack)
        assert enc.encode_device(plane) == stream
    for entropy in ("native", "python", "tpu"):
        enc = JpegEncoderSession(Parameters.monochrome(w, h, 80), ri,
                                 device="cpu", entropy=entropy)
        assert enc.encode(plane) == stream
        assert enc.encode_batch([plane, plane]) == [stream, stream]
    assert torch.equal(dec.decode_device_e2e(payload)[0],
                       dec.decode_planes_device(
                           dec.decode_entropy(payload))[0])
