"""The port's own derivations of every session array equal the reference
session's: header parse, comp_idx, quant, plane_geom, perm, range tables,
device encoder tables, header bytes and destuffing. Also: state built
from the reference's arrays (state.from_numpy) round-trips and transcodes
identically. Tolerance: exact equality."""

import numpy as np
import pytest

from video_coding_tpu.entropy import scan as jscan
from video_coding_tpu.entropy import tpu_decode, tpu_encode
from video_coding_tpu.runtime import engine
from video_coding_tpu_torch import state
from video_coding_tpu_torch.common.bitstream import BitReader
from video_coding_tpu_torch.entropy.scan import destuff_flat
from video_coding_tpu_torch.model.header import Header, Parameters
from video_coding_tpu_torch.runtime.engine import (JpegDecoderSession,
                                                   JpegEncoderSession,
                                                   JpegTranscodeSession,
                                                   _lane_plan)

from _torch_fixtures import ENCODERS, encode, header_payload, synth_frame


def _reference_arrays(jdec, jenc):
    dec = {"quant": jdec.quant, "comp_idx": jdec.comp_idx,
           "plane_geom": jdec.plane_geom,
           "range_tables": tpu_decode.range_tables(jdec.tables),
           "luts": tpu_decode.expand_luts(jdec.tables)}
    enc = {"quant": jenc.quant, "comp_idx": jenc.comp_idx,
           "perm": np.asarray(jenc._perm_dev), "gather": jenc.gather,
           "tables": tpu_encode.device_encoder_tables(jenc.tables),
           "prev_same_comp": np.asarray(jenc._enc_geometry(64)[6])}
    return dec, enc


def _assert_arrays_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_arrays_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_arrays_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("sub,w,h,ri", [("420", 72, 40, 1),
                                        ("422", 48, 32, 2),
                                        ("444", 40, 24, 0)])
def test_session_arrays_match_reference(sub, w, h, ri):
    stream = encode(sub, synth_frame(sub, w, h, 1), 60, ri)
    jheader, _ = header_payload(stream)
    bits = BitReader(stream)
    header = Header.decode(bits)
    # header parse: the same records field by field
    assert header.frame.width == jheader.frame.width
    assert header.frame.height == jheader.frame.height
    assert [vars(c) for c in header.frame.components] == \
        [vars(c) for c in jheader.frame.components]
    assert [vars(q) for q in header.quant_tables] == \
        [vars(q) for q in jheader.quant_tables]
    assert [vars(t) for t in header.huffman_tables] == \
        [vars(t) for t in jheader.huffman_tables]
    assert [vars(c) for c in header.scan.scan_components] == \
        [vars(c) for c in jheader.scan.scan_components]
    assert (header.restart_interval is None) == \
        (jheader.restart_interval is None)

    jdec = engine.JpegDecoderSession(jheader)
    params_j = ENCODERS[sub][2](w, h, 60)
    jenc = engine.JpegEncoderSession(params_j, restart_interval=ri)
    dec = JpegDecoderSession(header, device="cpu")
    maker = {"420": Parameters.c420, "422": Parameters.c422,
             "444": Parameters.c444}[sub]
    enc = JpegEncoderSession(maker(w, h, 60), restart_interval=ri,
                             device="cpu")
    ref_dec, ref_enc = _reference_arrays(jdec, jenc)
    _assert_arrays_equal(dec.numpy_state(), ref_dec)
    _assert_arrays_equal(enc.numpy_state(), ref_enc)
    assert dec.blocks_per_segment == jdec.blocks_per_segment
    assert enc.blocks_per_segment == jenc.blocks_per_segment
    assert enc._header_bytes == jenc._header_bytes
    # the lane prep of the flat-buffer decode
    flat, lens64 = destuff_flat(stream[bits.bit_pos >> 3:])
    segb = dec._expected_seg_blocks(len(lens64))
    np.testing.assert_array_equal(segb, jdec._expected_seg_blocks(len(lens64)))
    starts64 = np.zeros_like(lens64)
    np.cumsum(lens64[:-1], out=starts64[1:])
    plan = _lane_plan(starts64, lens64, segb)
    ref = jdec._flat_lane_inputs(flat, lens64, segb)
    for a, b in zip((plan.starts, plan.lens, plan.blocks, plan.inv_perm),
                    ref[1:5]):
        np.testing.assert_array_equal(a, b)
    assert plan.L == ref[5]


def _stuffed_streams():
    rng = np.random.default_rng(4)
    out = []
    for n in (0, 1, 50, 4000):
        body = rng.integers(0, 256, n).astype(np.uint8)
        # sprinkle 0xFF followed by stuffing, fill bytes and RSTn markers
        for i in rng.integers(0, max(n - 1, 1), n // 20):
            body[i] = 0xFF
            body[i + 1] = (0x00, 0xFF, 0xD0 + rng.integers(0, 8))[
                rng.integers(0, 3)]
        out.append(body.tobytes())
    out += [b"\xff", b"\x12\xff\x00\xff", b"\xff\xd0\xff\xd1",
            b"\x01\xff\xff\xd3\x02\xff\xd9\x03\x04", b"\x05\xff\xc4\x06"]
    return out


@pytest.mark.parametrize("i", range(9))
def test_destuff_flat_matches_reference(i):
    data = _stuffed_streams()[i]
    flat, lens = destuff_flat(data)
    ref_flat, ref_lens = jscan.destuff_flat(data)
    np.testing.assert_array_equal(flat, ref_flat)
    np.testing.assert_array_equal(lens, ref_lens)
    py_flat, py_lens = jscan.destuff_flat(data, use_native=False)
    np.testing.assert_array_equal(flat, py_flat)
    np.testing.assert_array_equal(lens, py_lens)


def test_from_numpy_round_trip_and_reference_state_transcode():
    """State carried across from the reference session's arrays gives
    the same arrays back and the same transcoded bytes."""
    stream = encode("420", synth_frame("420", 64, 32, 2), 50, 1)
    jheader, payload = header_payload(stream)
    header = Header.decode(BitReader(stream))
    t = JpegTranscodeSession(header, quality=70, restart_interval=2,
                             device="cpu")
    own = t.transcode(payload)
    jt = engine.JpegTranscodeSession(jheader, quality=70,
                                     restart_interval=2)
    ref_dec, ref_enc = _reference_arrays(jt.decoder, jt.encoder)
    dstate, estate = state.from_numpy(ref_dec, ref_enc, device="cpu")
    _assert_arrays_equal(dstate.to_numpy(), ref_dec)
    _assert_arrays_equal(estate.to_numpy(), ref_enc)
    t.decoder.load_state(dstate)
    t.encoder.load_state(estate)
    assert t.transcode(payload) == own
