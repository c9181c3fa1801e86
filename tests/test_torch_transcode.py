"""The port's transcode main path on the CPU (plain K1-K4) as a whole:
byte-identical to the reference model's decode + encode across
subsamplings, qualities and restart intervals, and to the reference
JAX session's fused transcode_batch (XLA forms of K1-K4 on the CPU); the
host route (``entropy_out="host"``: K3, download, host coder) and
``transcode_iter`` likewise. Tolerance: exact byte equality."""

import pytest

from video_coding_tpu.runtime import engine
from video_coding_tpu_torch.common.bitstream import BitReader
from video_coding_tpu_torch.model.header import Header, Parameters
from video_coding_tpu_torch.runtime.engine import (JpegEncoderSession,
                                                   JpegTranscodeSession)

from _torch_fixtures import encode, golden_transcode, header_payload, \
    synth_frame

# odd sizes: the pad region past the frame edge must be zeroed
SIZES = {"420": (200, 120), "422": (176, 96), "444": (120, 72)}


def _session(stream: bytes, q: int, ri: int, **kw):
    bits = BitReader(stream)
    header = Header.decode(bits)
    return (JpegTranscodeSession(header, quality=q, restart_interval=ri,
                                 device="cpu", **kw),
            stream[bits.bit_pos >> 3:])


@pytest.mark.parametrize("ri", [1, 2])
@pytest.mark.parametrize("q", [50, 75])
@pytest.mark.parametrize("sub", ["420", "422", "444"])
def test_transcode_batch_matches_golden_model(sub, q, ri):
    w, h = SIZES[sub]
    streams = [encode(sub, synth_frame(sub, w, h, seed), 85, ri)
               for seed in (q + ri, q + ri + 100)]
    t, _ = _session(streams[0], q, ri)
    payloads = [_session(s, q, ri)[1] for s in streams]
    outs = t.transcode_batch(payloads)
    assert outs == [golden_transcode(sub, s, q, ri) for s in streams]


@pytest.mark.parametrize("sub,q,ri", [("420", 75, 1), ("422", 50, 2),
                                      ("444", 75, 2)])
def test_transcode_batch_matches_reference_session(sub, q, ri):
    w, h = SIZES[sub]
    streams = [encode(sub, synth_frame(sub, w, h, seed), 80, ri)
               for seed in (7, 8)]
    jheader, _ = header_payload(streams[0])
    jt = engine.JpegTranscodeSession(jheader, quality=q, restart_interval=ri,
                                     entropy_out="device")
    payloads = [header_payload(s)[1] for s in streams]
    ref = jt.transcode_batch(payloads)
    t, _ = _session(streams[0], q, ri)
    assert t.transcode_batch(payloads) == ref


def test_transcode_batch_iter_ragged_tail_and_steady_state():
    """Pipelined batches keep order and byte identity with a ragged last
    chunk, also after the encode budget has locked."""
    w, h = SIZES["420"]
    streams = [encode("420", synth_frame("420", w, h, seed), 85, 1)
               for seed in range(3)]
    t, _ = _session(streams[0], 75, 1)
    payloads = [_session(s, 75, 1)[1] for s in streams]
    refs = [golden_transcode("420", s, 75, 1) for s in streams]
    assert t.transcode(payloads[0]) == refs[0]
    order = [0, 1, 2, 1, 0, 2, 2]
    outs = list(t.transcode_batch_iter([payloads[i] for i in order],
                                       batch=3, depth=2))
    assert outs == [refs[i] for i in order]


@pytest.mark.parametrize("sub,w,h,ri", [("420", 72, 40, 1),
                                        ("444", 32, 16, 0)])
def test_encode_device_batch_matches_golden_model(sub, w, h, ri):
    """The device encode the smoke run makes its sources with: planes →
    JPEG bytes equal to the reference model's encode (odd sizes pad)."""
    maker = {"420": Parameters.c420, "444": Parameters.c444}[sub]
    frames = [synth_frame(sub, w, h, seed) for seed in (3, 4)]
    enc = JpegEncoderSession(maker(w, h, 70), ri, device="cpu",
                             device_pack="pallas")       # K4: B <= 32
    outs = enc.encode_device_batch(
        [(f.y.data, f.u.data, f.v.data) for f in frames])
    assert outs == [encode(sub, f, 70, ri) for f in frames]
    f = frames[0]
    assert enc.encode_planes_device((f.y.data, f.u.data, f.v.data)) == \
        outs[0]


@pytest.mark.parametrize("sub,q,ri", [("420", 75, 1), ("422", 50, 2),
                                      ("444", 75, 0)])
def test_transcode_host_route_matches_device_route_and_reference(sub, q, ri):
    """``entropy_out="host"`` (K3, the coefficient download, the host
    coder) gives the device route's bytes, the JAX session's host route's
    and the golden model's."""
    w, h = SIZES[sub]
    streams = [encode(sub, synth_frame(sub, w, h, seed), 85, 1)
               for seed in (11, 12)]
    payloads = [header_payload(s)[1] for s in streams]
    jheader, _ = header_payload(streams[0])
    ref = engine.JpegTranscodeSession(jheader, quality=q, restart_interval=ri,
                                      entropy_out="host") \
        .transcode_batch(payloads)
    host, _ = _session(streams[0], q, ri, entropy_out="host")
    assert host.entropy_out == "host"
    got = host.transcode_batch(payloads)
    assert got == ref
    device, _ = _session(streams[0], q, ri)
    assert device.entropy_out == "device"       # "auto" is "device"
    assert device.transcode_batch(payloads) == got
    assert got == [golden_transcode(sub, s, q, ri) for s in streams]
    with pytest.raises(ValueError, match="entropy_out"):
        _session(streams[0], q, ri, entropy_out="tpu")


@pytest.mark.parametrize("entropy_out", ["host", "device"])
def test_transcode_iter_matches_transcode_batch(entropy_out):
    w, h = SIZES["420"]
    streams = [encode("420", synth_frame("420", w, h, seed), 85, 1)
               for seed in range(3)]
    payloads = [header_payload(s)[1] for s in streams]
    t, _ = _session(streams[0], 75, 2, entropy_out=entropy_out)
    refs = t.transcode_batch(payloads)
    order = [1, 0, 2, 2]
    assert list(t.transcode_iter([payloads[i] for i in order], depth=2)) \
        == [refs[i] for i in order]
