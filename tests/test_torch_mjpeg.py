"""The port's ``tools/mjpeg.py`` against the JAX package's on the CPU:
split and join, the encoded stream's bytes, decode_stream with and without
resync (a damaged entropy segment, a frame whose headers do not parse) and
the streaming ``_iter`` forms. Tolerance: exact equality of bytes and
planes."""

import numpy as np
import pytest

from video_coding_tpu.tools import mjpeg as jmjpeg
from video_coding_tpu_torch.common.bitstream import BitReader
from video_coding_tpu_torch.common.frame import ChromaSubsampling, Frame
from video_coding_tpu_torch.common.plane import Plane
from video_coding_tpu_torch.model.header import DecodeError, Header
from video_coding_tpu_torch.runtime.engine import JpegDecoderSession
from video_coding_tpu_torch.tools import mjpeg

from _torch_fixtures import encode, synth_frame


def _port_frame(f) -> Frame:
    """The port's Frame of a reference Frame's arrays."""
    return Frame(*(Plane(data=getattr(f, c).data.copy()) for c in "yuv"),
                 ChromaSubsampling(f.chroma_subsampling.value))


def _arrays(frame):
    return [getattr(frame, c).data for c in "yuv"]


def _assert_frames(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(_arrays(g), _arrays(w)):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def ref_frames():
    return [synth_frame("420", 48, 32, s) for s in range(4)]


@pytest.fixture(scope="module")
def stream(ref_frames):
    return jmjpeg.encode_stream(ref_frames, 80, restart_interval=2)


def test_split_join_match_jax(stream):
    parts = mjpeg.split_stream(stream)
    assert parts == jmjpeg.split_stream(stream) and len(parts) == 4
    assert mjpeg.join_stream(parts) == stream
    # a garbage prefix, a truncated last frame and a trailer without SOI
    messy = b"junk" + stream + parts[0][:40] + b"\x00\x01"
    assert mjpeg.split_stream(messy) == jmjpeg.split_stream(messy)
    assert mjpeg.split_stream(b"") == jmjpeg.split_stream(b"") == []


def test_split_skips_marker_like_header_bytes():
    """A quant value 0xD9 after 0xFF in a DQT must not end the frame."""
    from video_coding_tpu_torch.model.encoder import (Encoder, Identified,
                                                      Parameters,
                                                      ScanComponentParams)
    from video_coding_tpu_torch.model.huffman import AC_LUMA, DC_LUMA

    qt = np.full(64, 255, dtype=np.int32)
    qt[1] = 217
    params = Parameters(16, 16, (Identified(0, qt),),
                        (Identified(0, DC_LUMA),), (Identified(0, AC_LUMA),),
                        (ScanComponentParams(0, 0, 0, 1, 1, 1),))
    enc = Encoder(params)
    enc.load_plane(Plane(data=np.full((16, 16), 255, dtype=np.uint8)))
    enc.write_headers()
    enc.encode()
    enc.complete_and_write_eoi()
    data = enc.writer.get_buffer()
    assert b"\xff\xd9" in data[:-2]
    assert mjpeg.split_stream(data + data) == [data, data] \
        == jmjpeg.split_stream(data + data)


@pytest.mark.parametrize("sub,ri", [("420", 2), ("422", 0), ("440", 1),
                                    ("444", 3)])
def test_encode_stream_bytes_match_jax(sub, ri):
    refs = [synth_frame(sub, 40, 24, s) for s in range(3)]
    want = jmjpeg.encode_stream(refs, 70, restart_interval=ri)
    got = mjpeg.encode_stream([_port_frame(f) for f in refs], 70,
                              restart_interval=ri, device="cpu")
    assert got == want
    assert mjpeg.encode_stream([], device="cpu") == b""


def test_encode_stream_with_session(ref_frames, stream):
    from video_coding_tpu_torch.model.header import Parameters
    from video_coding_tpu_torch.runtime.engine import JpegEncoderSession

    sess = JpegEncoderSession(Parameters.c420(48, 32, 80), 2, device="cpu")
    frames = [_port_frame(f) for f in ref_frames]
    assert mjpeg.encode_stream(frames, session=sess) == stream


def test_decode_stream_matches_jax(stream):
    got = mjpeg.decode_stream(stream, device="cpu")
    _assert_frames(got, jmjpeg.decode_stream(stream))
    sess = JpegDecoderSession(Header.decode(BitReader(stream)), device="cpu")
    _assert_frames(mjpeg.decode_stream(stream, session=sess), got)
    assert mjpeg.decode_stream(b"junk", device="cpu") == []


@pytest.fixture(scope="module")
def damaged(stream):
    """Frame 1 with a damaged entropy segment, and a last frame whose
    headers do not parse (an unsupported SOF2 marker)."""
    parts = jmjpeg.split_stream(stream)
    bad1 = bytearray(parts[1])
    mid = len(bad1) // 2
    bad1[mid:mid + 6] = b"\xff\x00" * 3
    bad_hdr = parts[3][:2] + b"\xff\xc2\x00\x04\x00\x00" + parts[3][2:]
    return jmjpeg.join_stream([parts[0], bytes(bad1), parts[2], bad_hdr])


def test_decode_stream_resync_matches_jax(stream, damaged):
    want = jmjpeg.decode_stream(damaged, resync=True)
    got = mjpeg.decode_stream(damaged, resync=True, device="cpu")
    assert len(got) == 4
    _assert_frames(got, want)
    clean = mjpeg.decode_stream(stream, device="cpu")
    _assert_frames([got[0], got[2]], [clean[0], clean[2]])
    assert (got[3].y.data == 128).all() and got[3].u.data.shape == (16, 24)
    with pytest.raises(DecodeError):
        mjpeg.decode_stream(damaged, device="cpu")


def test_decode_stream_iter_matches_jax(stream):
    got = list(mjpeg.decode_stream_iter(stream, depth=3, device="cpu"))
    _assert_frames(got, list(jmjpeg.decode_stream_iter(stream, depth=3)))
    assert list(mjpeg.decode_stream_iter(b"", device="cpu")) == []


def test_encode_stream_iter_matches_jax(ref_frames, stream):
    frames = [_port_frame(f) for f in ref_frames]
    parts = list(mjpeg.encode_stream_iter(iter(frames), 80,
                                          restart_interval=2, depth=3,
                                          device="cpu"))
    assert parts == list(jmjpeg.encode_stream_iter(ref_frames, 80,
                                                   restart_interval=2,
                                                   depth=3))
    assert mjpeg.join_stream(parts) == stream
    assert list(mjpeg.encode_stream_iter([], device="cpu")) == []


def test_stream_roundtrip_equals_golden_decode(stream):
    """Every frame of decode_stream equals the golden decoder's."""
    from video_coding_tpu_torch.model.decoder import decode_a_frame

    got = mjpeg.decode_stream(stream, device="cpu")
    _assert_frames(got, [decode_a_frame(p) for p in
                         mjpeg.split_stream(stream)])
    assert encode("420", synth_frame("420", 48, 32, 0), 80, 2) \
        == mjpeg.split_stream(stream)[0]
