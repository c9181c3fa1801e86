"""The port's golden model (``model/encoder.py``, ``model/decoder.py``'s
``Decoder``, ``model/util.py``) against the JAX package's, in numpy on
seeded synthetic frames: encoded bytes for every preset, quality and
restart interval, decoded planes with and without resync, the sequenced
per-block API and the debug strings. Tolerance: exact equality."""

import numpy as np
import pytest

from video_coding_tpu.common.bitstream import BitReader as RefBitReader
from video_coding_tpu.model import decoder as jdec
from video_coding_tpu.model import encoder as jenc
from video_coding_tpu.model import util as jutil
from video_coding_tpu_torch.common.bitstream import BitReader
from video_coding_tpu_torch.common.frame import ChromaSubsampling, Frame
from video_coding_tpu_torch.common.plane import Plane
from video_coding_tpu_torch.model import decoder, encoder, header, util

from _torch_fixtures import synth_frame, synth_plane

PORT_ENCODERS = {"420": encoder.encode_420, "422": encoder.encode_422,
                 "440": encoder.encode_440, "444": encoder.encode_444}
REF_ENCODERS = {"420": jenc.encode_420, "422": jenc.encode_422,
                "440": jenc.encode_440, "444": jenc.encode_444}


def _port_frame(f) -> Frame:
    return Frame(*(Plane(data=getattr(f, c).data.copy()) for c in "yuv"),
                 ChromaSubsampling(f.chroma_subsampling.value))


def _arrays(frame):
    return [getattr(frame, c).data for c in "yuv"]


@pytest.mark.parametrize("ri", [0, 1, 3])
@pytest.mark.parametrize("q", [10, 50, 75, 95])
@pytest.mark.parametrize("sub", ["420", "422", "440", "444", "mono"])
def test_golden_encoder_bytes_match_jax(sub, q, ri):
    if sub == "mono":
        plane = synth_plane(37, 21, q + ri)
        want = jenc.encode_monochrome(plane, q, restart_interval=ri)
        got = encoder.encode_monochrome(Plane(data=plane.data.copy()), q,
                                        restart_interval=ri)
    else:
        f = synth_frame(sub, 40, 24, q + ri)
        want = REF_ENCODERS[sub](f, q, restart_interval=ri)
        got = PORT_ENCODERS[sub](_port_frame(f), q, restart_interval=ri)
    assert got == want


@pytest.mark.parametrize("sub", ["420", "444"])
def test_noninterleaved_and_reconstruction_error_match_jax(sub):
    f = synth_frame(sub, 45, 29, 7)
    want = REF_ENCODERS[sub](f, 60, restart_interval=2, interleaved=False)
    got = PORT_ENCODERS[sub](_port_frame(f), 60, restart_interval=2,
                             interleaved=False)
    assert got == want
    maker = {"420": "c420", "444": "c444"}[sub]
    ref = jenc.Encoder(getattr(jenc.Parameters, maker)(45, 29, 60),
                       compute_reconstruction_error=True)
    port = encoder.Encoder(getattr(encoder.Parameters, maker)(45, 29, 60),
                           compute_reconstruction_error=True)
    ref.load_frame(f)
    port.load_frame(_port_frame(f))
    for e in (ref, port):
        e.write_headers()
        e.encode()
        e.complete_and_write_eoi()
    assert port.writer.get_buffer() == ref.writer.get_buffer()
    assert port.last_error_sum == ref.last_error_sum > 0
    assert (port.macroblocks_wide, port.macroblocks_high) \
        == (ref.macroblocks_wide, ref.macroblocks_high)
    np.testing.assert_array_equal(port.quantized_blocks(),
                                  ref.quantized_blocks())


def test_encoder_shares_the_header_parameters():
    assert encoder.Parameters is header.Parameters
    assert encoder.Scan is header.Scan
    assert encoder.Identified is header.Identified
    assert encoder.ScanComponentParams is header.ScanComponentParams
    for v in (0, 1, -1, 2047, -2047, 5, -6):
        s = encoder.size_category(v)
        assert s == jenc.size_category(v)
        assert encoder.magnitude_bits(s, v) == jenc.magnitude_bits(s, v)
    rng = np.random.default_rng(3)
    fdct = rng.integers(-40000, 40000, (50, 64))
    qnt = rng.integers(1, 256, (50, 64))
    np.testing.assert_array_equal(encoder.quant_and_scale(fdct, qnt),
                                  jenc.quant_and_scale(fdct, qnt))


def _streams():
    out = []
    for sub, ri in (("420", 1), ("422", 0), ("440", 2), ("444", 3)):
        f = synth_frame(sub, 45, 29, ri)
        out.append(REF_ENCODERS[sub](f, 80, restart_interval=ri))
    out.append(jenc.encode_monochrome(synth_plane(33, 17, 4), 70,
                                      restart_interval=2))
    return out


@pytest.mark.parametrize("k", range(5))
def test_decode_a_frame_matches_jax(k):
    """Four 3-component streams and a monochrome one (which
    ``decode_a_frame`` cannot return as a Frame: the Decoder's planes)."""
    stream = _streams()[k]
    if k < 4:
        for a, b in zip(_arrays(decoder.decode_a_frame(stream)),
                        _arrays(jdec.decode_a_frame(stream))):
            np.testing.assert_array_equal(a, b)
    bits, rbits = BitReader(stream), RefBitReader(stream)
    port = decoder.Decoder(decoder.Header.decode(bits), bits)
    ref = jdec.Decoder(jdec.Header.decode(rbits), rbits)
    port.decode()
    ref.decode()
    for pp, rp in zip(port.get_planes(), ref.get_planes()):
        np.testing.assert_array_equal(pp.data, rp.data)
    for pp, rp in zip(port.get_decoded_planes(), ref.get_decoded_planes()):
        np.testing.assert_array_equal(pp.data, rp.data)
    assert port.block_schedule() == ref.block_schedule()
    assert (port.macroblocks_wide, port.macroblocks_high) \
        == (ref.macroblocks_wide, ref.macroblocks_high)


def _damage(stream: bytes) -> bytes:
    """The stream with 8 bytes at its middle set to stuffed 0xFF bytes
    (0xFF 0x00 pairs) and its last 30 bytes cut (EOI restored)."""
    b = bytearray(stream[:-30])
    n = len(b)
    b[n // 2:n // 2 + 8] = b"\xff\x00" * 4
    return bytes(b) + b"\xff\xd9"


@pytest.mark.parametrize("k", [0, 1, 3])
def test_decoder_resync_matches_jax(k):
    stream = _damage(_streams()[k])
    bits, rbits = BitReader(stream), RefBitReader(stream)
    port = decoder.Decoder(decoder.Header.decode(bits), bits)
    ref = jdec.Decoder(jdec.Header.decode(rbits), rbits)
    port.decode(resync=True)
    ref.decode(resync=True)
    assert port.damaged_segments == ref.damaged_segments
    assert port.damaged_segments
    for pp, rp in zip(port.get_planes(), ref.get_planes()):
        np.testing.assert_array_equal(pp.data, rp.data)
    bits, rbits = BitReader(stream), RefBitReader(stream)
    with pytest.raises(header.DecodeError):
        decoder.Decoder(decoder.Header.decode(bits), bits).decode()
    with pytest.raises(jdec.DecodeError):
        jdec.Decoder(jdec.Header.decode(rbits), rbits).decode()


def test_sequenced_block_api_matches_jax():
    stream = _streams()[0]
    bits, rbits = BitReader(stream), RefBitReader(stream)
    port = decoder.Decoder(decoder.Header.decode(bits), bits)
    ref = jdec.Decoder(jdec.Header.decode(rbits), rbits)
    n = 0
    for pc, rc in zip(port.decode_blocks_seq(), ref.decode_blocks_seq(),
                      strict=True):
        assert (pc.x, pc.y, pc.dc_pred) == (rc.x, rc.y, rc.dc_pred)
        for name in ("coefs", "dequant", "idct", "recon"):
            np.testing.assert_array_equal(getattr(pc, name),
                                          getattr(rc, name))
        n += 1
    assert n == len(ref.block_schedule())
    for pp, rp in zip(port.get_planes(), ref.get_planes()):
        np.testing.assert_array_equal(pp.data, rp.data)


def test_decode_frame_bytes_from_file(tmp_path):
    stream = _streams()[2]
    path = tmp_path / "frame.jpg"
    path.write_bytes(stream)
    got = decoder.decode_frame_bytes(str(path))
    want = jdec.decode_frame_bytes(str(path))
    for a, b in zip(_arrays(got), _arrays(want)):
        np.testing.assert_array_equal(a, b)
    # a non-interleaved file goes to the multi-scan decoder
    f = synth_frame("420", 32, 16, 9)
    multi = jenc.encode_420(f, 75, interleaved=False)
    path.write_bytes(multi)
    for a, b in zip(_arrays(decoder.decode_frame_bytes(str(path))),
                    _arrays(jdec.decode_a_frame(multi))):
        np.testing.assert_array_equal(a, b)


def test_util_strings_match_jax():
    rng = np.random.default_rng(11)
    coefs = rng.integers(-2048, 2048, 64)
    pixels = rng.integers(0, 256, 64)
    assert util.coef_block_to_string(coefs) \
        == jutil.coef_block_to_string(coefs)
    assert util.pixel_block_to_string(pixels) \
        == jutil.pixel_block_to_string(pixels)
    assert util.coef_block_to_string([-1] + [0] * 63).startswith("fff 000")
    assert util.pixel_block_to_string(range(64)).splitlines()[1] \
        == "08 09 0a 0b 0c 0d 0e 0f"
