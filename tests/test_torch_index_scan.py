"""The port's host-side pieces of the device decode service against the
reference package: ``index_scan`` vs ``_index_scan_py`` (records and
errors), ``pack_lanes_sorted``, the lane prep of the padded route, and the
strategy routing rules vs ``max_lanes_t`` / ``max_win_bs`` /
``max_lane_chunk`` as the reference's ``auto`` strategy composes them.
Tolerance: exact equality."""

import numpy as np
import pytest

from video_coding_tpu.entropy import pallas_decode
from video_coding_tpu.entropy import scan as jscan
from video_coding_tpu.runtime import engine
from video_coding_tpu_torch.common.bitstream import BitReader
from video_coding_tpu_torch.entropy import decode_tables, scan
from video_coding_tpu_torch.model.header import Header
from video_coding_tpu_torch.runtime.engine import (JpegDecoderSession,
                                                   _lane_plan)

from _torch_fixtures import encode, header_payload, synth_frame


def _sessions(sub, w, h, q, seed=2):
    stream = encode(sub, synth_frame(sub, w, h, seed), q, 0)
    jheader, payload = header_payload(stream)
    jdec = engine.JpegDecoderSession(jheader)
    dec = JpegDecoderSession(Header.decode(BitReader(stream)), device="cpu")
    flat, lens64 = jscan.destuff_flat(payload)
    assert len(lens64) == 1
    return jdec, dec, flat


@pytest.mark.parametrize("sub,w,h", [("420", 64, 48), ("422", 48, 32),
                                     ("444", 48, 32)])
@pytest.mark.parametrize("q", [50, 90])
def test_index_scan_matches_reference(sub, w, h, q):
    jdec, dec, flat = _sessions(sub, w, h, q)
    stride = dec._index_stride()
    assert stride == jdec._index_stride()
    for st in (stride, dec.mcu_size, 7):
        bo, dp = scan.index_scan(flat, dec.comp_idx, st, dec.tables)
        rbo, rdp = jscan._index_scan_py(flat, jdec.comp_idx, st, jdec.tables)
        assert bo.dtype == rbo.dtype and dp.dtype == rdp.dtype
        np.testing.assert_array_equal(bo, rbo)
        np.testing.assert_array_equal(dp, rdp)
        assert bo[-1] > 0 and dp.any()


@pytest.mark.parametrize("kind", ["random", "ones", "truncated"])
def test_index_scan_malformed(kind):
    """A symbol stream the reference walk rejects raises ValueError here
    too; one it walks to the end (bytes past the end read as zero) gives
    the same records."""
    jdec, dec, flat = _sessions("420", 64, 48, 75)
    rng = np.random.default_rng(1)
    bad = {"random": rng.integers(0, 255, flat.size).astype(np.uint8),
           "ones": np.full(flat.size, 0xFF, np.uint8),
           "truncated": flat[:flat.size // 3].copy()}[kind]
    stride = dec._index_stride()
    try:
        ref = jscan._index_scan_py(bad, jdec.comp_idx, stride, jdec.tables)
    except ValueError as err:
        with pytest.raises(ValueError, match=str(err)):
            scan.index_scan(bad, dec.comp_idx, stride, dec.tables)
    else:
        got = scan.index_scan(bad, dec.comp_idx, stride, dec.tables)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert kind != "ones"       # sixteen 1 bits match no code
    bad_comp = dec.comp_idx.copy()
    bad_comp[3] = 9
    with pytest.raises(ValueError):
        scan.index_scan(flat, bad_comp, stride, dec.tables)


@pytest.mark.parametrize("sub,ri", [("420", 1), ("444", 2)])
def test_padded_lane_prep_matches_reference(sub, ri):
    stream = encode(sub, synth_frame(sub, 64, 48, 4), 75, ri)
    jheader, payload = header_payload(stream)
    jdec = engine.JpegDecoderSession(jheader)
    dec = JpegDecoderSession(Header.decode(BitReader(stream)), device="cpu")
    flat, lens64 = jscan.destuff_flat(payload)
    segb = jdec._expected_seg_blocks(len(lens64))
    rbuf, _st, rlens, rsegb, rinv, rL, _M = jdec._padded_lane_inputs(
        flat, lens64, segb)
    starts64 = np.zeros_like(lens64)
    np.cumsum(lens64[:-1], out=starts64[1:])
    plan = _lane_plan(starts64, lens64, dec._expected_seg_blocks(len(lens64)),
                      matrix=True)
    lens, segb2, inv, L = plan.lens, plan.blocks, plan.inv_perm, plan.L
    lanebuf = scan.pack_lanes_sorted(flat, lens64, plan.order, L,
                                     starts=starts64)
    assert L == rL and lanebuf.shape == (len(lens64), L)
    np.testing.assert_array_equal(lanebuf.ravel(), rbuf)
    for a, b in ((lens, rlens), (segb2, rsegb), (inv, rinv)):
        np.testing.assert_array_equal(a, b)
    order = np.argsort(-lens64, kind="stable")
    np.testing.assert_array_equal(
        scan.pack_lanes_sorted(flat, lens64, order, L + 3),
        jscan.pack_lanes_sorted(flat, lens64, order, L + 3))


SHAPES = [(S, L, B) for S in (1, 63, 64, 1088, 130560)
          for L in (32, 64, 512, 8192, 16384, 32768)
          for B in (6, 24, 30, 126, 132, 720, 48960)]


def _reference_auto(S, L, B):
    """The reference's ``auto`` choice (engine._device_decode_fn) with its
    backend test taken as passed."""
    def eligible(ch):
        return ch >= 128 and S >= 64

    lanes = pallas_decode.max_lanes_t(L, B)
    if eligible(lanes):
        return "pallas_t"
    if lanes == 0 and pallas_decode.max_win_bs(L) \
            and eligible(pallas_decode.BS_LANES):
        return "streamed"
    # its padded-matrix kernel where eligible, else a compiler-generated
    # loop — the port stays on the padded-matrix kernel for both
    return "pallas"


def test_routing_rules_match_reference():
    for S, L, B in SHAPES:
        assert decode_tables.max_lanes_t(L, B) == \
            pallas_decode.max_lanes_t(L, B)
        assert decode_tables.max_lane_chunk(L, B) == \
            pallas_decode.max_lane_chunk(L, B)
        assert decode_tables.max_win_bs(L) == pallas_decode.max_win_bs(L)
        assert decode_tables.auto_strategy(S, L, B) == \
            _reference_auto(S, L, B), (S, L, B)
        words = pallas_decode.max_lanes_t(L + 48, B)
        assert decode_tables.flat_words_route(S, L, B, "pallas_t") == \
            (words != 0)
        assert decode_tables.flat_words_route(S, L, B, "auto") == \
            (words >= 128 and S >= 64)
        assert not decode_tables.flat_words_route(S, L, B, "pallas")
    assert decode_tables.BS_WIN == pallas_decode.BS_WIN
    # the full-width shapes of the four decode paths
    assert decode_tables.auto_strategy(1088, 8192, 720) == "streamed"
    assert decode_tables.auto_strategy(1088, 16384, 720) == "streamed"
    assert decode_tables.auto_strategy(130560, 64, 6) == "pallas_t"
    assert decode_tables.flat_words_route(32640, 512, 24, "auto")
