"""The port's device decode service on the CPU (plain versions of K1, K5,
K6, K7 and K2) as a whole: ``decode_device``, ``decode_device_batch``,
``decode_device_batch_iter`` and the restart-free ``transcode`` against
the reference JAX sessions and the golden model, over restart-segmented,
long-segment and restart-free streams, every strategy and both gather
modes, with the port's state built from the reference session's arrays.
Tolerance: exact equality of planes and bytes."""

import logging

import numpy as np
import pytest
import torch

from video_coding_tpu.common.frame import Frame as RefFrame
from video_coding_tpu.entropy import tpu_decode
from video_coding_tpu.model import decoder as mdec
from video_coding_tpu.runtime import engine
from video_coding_tpu_torch import state as tstate
from video_coding_tpu_torch.common.bitstream import BitReader
from video_coding_tpu_torch.common.frame import Frame
from video_coding_tpu_torch.common.plane import Plane
from video_coding_tpu_torch.entropy import huffman_decode
from video_coding_tpu_torch.model.header import Header
from video_coding_tpu_torch.runtime import engine as tengine
from video_coding_tpu_torch.runtime import trace
from video_coding_tpu_torch.runtime.engine import (JpegDecoderSession,
                                                   JpegTranscodeSession)

from _torch_fixtures import encode, golden_transcode, header_payload, \
    synth_frame


def _stream(sub, w, h, q, ri, seed=1):
    return encode(sub, synth_frame(sub, w, h, seed), q, ri)


def _port(stream, **kw):
    bits = BitReader(stream)
    header = Header.decode(bits)
    return (JpegDecoderSession(header, device="cpu", **kw),
            stream[bits.bit_pos >> 3:])


def _golden(stream):
    g = mdec.decode_a_frame(stream)
    return [g.y.data, g.u.data, g.v.data]


def _planes(frame):
    """The arrays of a decoded picture: a ``Frame``'s y, u, v, or those of
    a list of ``Plane``s; a tuple of plane tensors passes as it is."""
    if isinstance(frame, (Frame, RefFrame)):
        return [frame.y.data, frame.u.data, frame.v.data]
    if isinstance(frame, list):
        return [p.data for p in frame]
    return frame


def _assert_planes(got, ref):
    got, ref = _planes(got), _planes(ref)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _count_calls(monkeypatch, *names):
    """Count the calls of huffman_decode's wrappers by name."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(huffman_decode, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(huffman_decode, name, counted)
    return calls


# odd sizes crop; 128x64 4:2:0, 250x94 4:2:2 and 132x108 4:4:4 restart-free
# streams are large enough for the indexed route
@pytest.mark.parametrize("sub,w,h,q,ri", [
    ("420", 64, 48, 50, 1), ("444", 40, 24, 90, 2), ("420", 128, 64, 90, 0),
    ("422", 250, 94, 50, 0), ("444", 132, 108, 90, 0)])
def test_decode_device_matches_reference_session_and_golden(sub, w, h, q,
                                                            ri):
    stream = _stream(sub, w, h, q, ri)
    jheader, payload = header_payload(stream)
    jdec = engine.JpegDecoderSession(jheader)
    ref = jdec.decode_device(payload)
    dec, _ = _port(stream)
    # compute with the reference session's arrays
    dec.load_state(tstate.DecoderState.from_numpy(
        {"quant": jdec.quant, "comp_idx": jdec.comp_idx,
         "plane_geom": jdec.plane_geom,
         "range_tables": tpu_decode.range_tables(jdec.tables),
         "luts": tpu_decode.expand_luts(jdec.tables)}, "cpu"))
    got = dec.decode_device(payload)
    assert isinstance(ref, RefFrame) and isinstance(got, Frame)
    assert got.chroma_subsampling.name == ref.chroma_subsampling.name
    _assert_planes(got, ref)
    _assert_planes(got, _golden(stream))
    assert dec.entropy_segments_per_frame == jdec.entropy_segments_per_frame
    assert dec.device_entropy_parallel == jdec.device_entropy_parallel
    assert dec._indexable() == (ri == 0)


@pytest.mark.parametrize("sub,w,h,ri", [("420", 64, 48, 1),
                                        ("420", 128, 64, 0)])
def test_decode_device_batch_matches_reference_session(sub, w, h, ri):
    streams = [_stream(sub, w, h, 75, ri, seed) for seed in (1, 2, 3)]
    jheader, _ = header_payload(streams[0])
    payloads = [header_payload(s)[1] for s in streams]
    jdec = engine.JpegDecoderSession(jheader)
    ref = jdec.decode_device_batch(payloads)
    dec, _ = _port(streams[0])
    got = dec.decode_device_batch(payloads)
    assert len(got) == 3
    for g, r, s in zip(got, ref, streams):
        _assert_planes(g, r)                       # MCU-padded planes
        _assert_planes(dec._to_frame(g), _golden(s))
    stacked = dec.decode_batch_stacked(payloads)   # the earlier name
    assert torch.equal(stacked[0][1], got[1][0])
    chunks = list(dec.decode_device_batch_iter(
        [payloads[i] for i in (2, 0, 1, 1, 2)], batch=2, depth=2))
    assert [c[0].shape[0] for c in chunks] == [2, 2, 1]
    flat_y = torch.cat([c[0] for c in chunks])
    for k, i in enumerate((2, 0, 1, 1, 2)):
        assert torch.equal(flat_y[k], got[i][0])


@pytest.mark.parametrize("n_comp", [1, 2])
def test_to_frame_gives_planes_below_three_components(monkeypatch, n_comp):
    """Fewer than three components come back as a list of ``Plane``s, as
    the reference session gives them (its ``_to_frame`` on the same
    MCU-padded planes), cropped to each component's size."""
    stream = _stream("420", 40, 24, 75, 1, seed=4)
    jheader, payload = header_payload(stream)
    jdec = engine.JpegDecoderSession(jheader)
    dec, _ = _port(stream)
    padded = dec.decode_device_e2e(payload)
    for sess in (jdec, dec):
        monkeypatch.setattr(sess, "components", sess.components[:n_comp])
    got = dec._to_frame(padded)
    ref = jdec._to_frame([p.numpy() for p in padded])
    assert isinstance(got, list) and isinstance(ref, list)
    assert all(isinstance(p, Plane) for p in got)
    assert len(got) == n_comp
    _assert_planes(got, ref)
    _assert_planes(got, _golden(stream)[:n_comp])
    assert got[0].data.shape == (24, 40)


def test_runtime_exports_encode_jpeg():
    from video_coding_tpu_torch import runtime

    assert runtime.encode_jpeg is tengine.encode_jpeg
    assert "encode_jpeg" in runtime.__all__


STRATEGY_CALLS = {
    "auto": "decode_segments", "pallas": "decode_segments",
    "pallas_t": "decode_flat", "range": None,   # no wrapper: the plain loop
    "streamed": "decode_segments_streamed"}
# the wrapper each route on ``decode.launch`` runs (K1 also under pallas_t)
ROUTE_CALLS = {"flat": "decode_flat", "pallas_t": "decode_flat",
               "pallas": "decode_segments", "range": None,
               "streamed": "decode_segments_streamed"}


def _huffman_routes(rec):
    return [s.attrs["route"] for s in rec.spans
            if s.name == "decode.launch" and s.attrs["stage"] == "huffman"]


@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("how", list(STRATEGY_CALLS))
def test_every_strategy_decodes_the_golden_planes(monkeypatch, how, batch):
    """Single frames upload the padded matrix, batches the flat buffer
    (pallas_t then reads it directly, the others gather the matrix on the
    device); ``streamed`` is ``auto`` on a shape it routes to K6, forced
    here because such a shape is too large for a CPU test."""
    stream = _stream("420", 64, 48, 75, 5, seed=5)   # last segment short
    if how == "streamed":
        monkeypatch.setattr(huffman_decode, "auto_strategy",
                            lambda S, L, B: "streamed")
        dec, payload = _port(stream)
    else:
        dec, payload = _port(stream, device_huffman=how)
    calls = _count_calls(monkeypatch, "decode_flat", "decode_segments",
                         "decode_segments_streamed")
    with trace.recording() as rec:
        if batch:
            got = dec._to_frame(
                dec.decode_device_batch([payload, payload])[1])
        else:
            got = dec.decode_device(payload)
    _assert_planes(got, _golden(stream))
    assert calls == {name: int(name == STRATEGY_CALLS[how])
                     for name in calls}
    (route,) = _huffman_routes(rec)
    assert calls == {name: int(name == ROUTE_CALLS[route]) for name in calls}


@pytest.mark.parametrize("ri,hooks", [(1, False), (0, True)])
def test_dma_gather_mode_takes_the_staged_kernel(monkeypatch, ri, hooks):
    stream = _stream("420", 128, 64, 75, ri, seed=6)
    monkeypatch.setenv("VCT_DECODE_GATHER", "dma")
    dec, payload = _port(stream, device_huffman="pallas_t")
    assert dec.decode_gather == "dma"
    monkeypatch.delenv("VCT_DECODE_GATHER")
    assert _port(stream)[0].decode_gather == "gather"
    seen = []
    staged = huffman_decode.decode_flat_staged

    def spy(*a, **k):
        seen.append(k["init_bitpos"] is not None)
        return staged(*a, **k)

    monkeypatch.setattr(huffman_decode, "decode_flat_staged", spy)
    with trace.recording() as rec:
        got = dec.decode_device_batch([payload, payload])
    assert seen == [hooks] and _huffman_routes(rec) == ["staged"]
    for g in got:
        _assert_planes(dec._to_frame(g), _golden(stream))


def test_malformed_index_scan_falls_to_the_serial_lane(monkeypatch):
    stream = _stream("420", 128, 64, 75, 0, seed=7)
    dec, payload = _port(stream)

    def boom(*a, **k):
        raise ValueError("index scan failed at block 0")

    monkeypatch.setattr(tengine, "index_scan", boom)
    calls = _count_calls(monkeypatch, "decode_flat", "decode_segments")
    _assert_planes(dec.decode_device(payload), _golden(stream))
    assert calls == {"decode_flat": 0, "decode_segments": 1}


def test_small_restart_free_stream_warns_once(caplog):
    stream = _stream("420", 64, 48, 75, 0, seed=8)
    dec, payload = _port(stream)
    assert not dec.device_entropy_parallel and not dec._indexable()
    with caplog.at_level(logging.WARNING, logger="video_coding_tpu_torch"):
        first = dec.decode_device(payload)
        dec.decode_device(payload)
    assert [r.message for r in caplog.records].count(
        caplog.records[0].message) == 1
    assert "serial" in caplog.records[0].message
    _assert_planes(first, _golden(stream))


def test_session_rejects_unknown_strategies():
    stream = _stream("420", 64, 48, 75, 1)
    # "lut" (the expanded-table loop) is a strategy now, unknown names
    # still raise
    assert _port(stream, device_huffman="lut")[0].device_huffman == "lut"
    with pytest.raises(ValueError, match="device_huffman"):
        _port(stream, device_huffman="fastest")
    with pytest.raises(ValueError):
        _port(stream, decode_gather="tma")


@pytest.mark.parametrize("sub,w,h,q,ri_out", [("420", 200, 120, 75, 2),
                                              ("444", 132, 108, 50, 1)])
def test_restart_free_transcode_matches_reference_and_golden(sub, w, h, q,
                                                             ri_out):
    """A restart-free stream in, a restart-segmented stream out: the
    indexed decode feeding the device encode, byte for byte."""
    stream = _stream(sub, w, h, 85, 0, seed=9)
    jheader, payload = header_payload(stream)
    ref = engine.JpegTranscodeSession(
        jheader, quality=q, restart_interval=ri_out,
        entropy_out="device").transcode(payload)
    bits = BitReader(stream)
    t = JpegTranscodeSession(Header.decode(bits), quality=q,
                             restart_interval=ri_out, device="cpu")
    assert t.decoder._indexable()
    out = t.transcode(payload)
    assert out == ref
    assert out == golden_transcode(sub, stream, q, ri_out)
    assert t.transcode_batch([payload, payload]) == [ref, ref]


# a restart interval longer than the frame: one segment, shorter than the
# interval's B = ri · (blocks an MCU) blocks
LONG_RI = [("420", 16, 16, 2), ("420", 16, 16, 5), ("420", 8, 9, 2),
           ("420", 32, 16, 3), ("444", 8, 8, 2)]


@pytest.mark.parametrize("sub,w,h,ri", LONG_RI)
def test_restart_interval_longer_than_the_frame(sub, w, h, ri):
    """Every device decode route, the host-entropy routes, the RGB routes
    and both transcode routes give the JAX sessions' planes and bytes
    (every schedule is built at length B, repeating with the MCU)."""
    stream = _stream(sub, w, h, 75, ri)
    jheader, payload = header_payload(stream)
    jdec = engine.JpegDecoderSession(jheader)
    ref = jdec.decode_device(payload)
    _assert_planes(ref, _golden(stream))
    dec, _ = _port(stream)
    assert dec.blocks_per_segment > dec.n_blocks and dec.n_segments == 1
    _assert_planes(dec.decode_device(payload), ref)
    padded = dec.decode_device_e2e(payload)
    _assert_planes(dec._to_frame(padded), ref)
    for got in dec.decode_device_batch([payload, payload]):
        _assert_planes(got, padded)
    stacked = dec.decode_device_batch_stacked([payload] * 3)
    chunks = list(dec.decode_device_batch_iter([payload] * 3, batch=2))
    for p, plane in enumerate(padded):
        assert all(torch.equal(s, plane) for s in stacked[p])
        assert torch.equal(torch.cat([c[p] for c in chunks]), stacked[p])
    for entropy in ("tpu", "native", "python"):
        d, _ = _port(stream, entropy=entropy)
        _assert_planes(d.decode(payload), ref)
        _assert_planes(d.decode_batch([payload])[0], ref)
        _assert_planes(d.decode(payload, resync=True), ref)
        assert d.last_damaged_segments == []
    if sub == "444" or (w % 2 == 0 and h % 2 == 0):
        # (the JAX package's RGB tail raises where luma is odd in a
        # subsampled direction; test_torch_rgb covers those sizes)
        rgb = jdec.decode_device_rgb(payload)
        np.testing.assert_array_equal(dec.decode_device_rgb(payload), rgb)
        np.testing.assert_array_equal(
            dec.decode_device_rgb_batch([payload, payload])[1], rgb)
    want = golden_transcode(sub, stream, 60, ri)
    assert engine.JpegTranscodeSession(
        jheader, quality=60, restart_interval=ri,
        entropy_out="device").transcode(payload) == want
    for out in ("device", "host"):
        t = JpegTranscodeSession(dec.header, quality=60, restart_interval=ri,
                                 device="cpu", entropy_out=out)
        assert t.transcode(payload) == want
        assert t.transcode_batch([payload, payload]) == [want, want]
