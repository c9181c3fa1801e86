"""The modules of the port's split entropy encode path (plain torch and
numpy on the CPU, K8 and K9 through their plain versions) against their
counterparts in the reference package: symbol construction, the gather
packer, the split packer route, the exact rate, the device and host scan
coders, the sparse coefficient transfer and the routing rule. Tolerance:
exact equality everywhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_coding_tpu.entropy import pallas_encode, tpu_encode
from video_coding_tpu.entropy import scan as jscan
from video_coding_tpu.entropy.tables import pack_encoder_tables
from video_coding_tpu.model.huffman import (AC_CHROMA, AC_LUMA, DC_CHROMA,
                                            DC_LUMA)
from video_coding_tpu.ops import sparse as jsparse
from video_coding_tpu_torch.entropy import (gather_pack, huffman_encode,
                                            pack_stuff, symbols)
from video_coding_tpu_torch.entropy import scan as tscan
from video_coding_tpu_torch.entropy.tables import EncoderTables
from video_coding_tpu_torch.ops import sparse

# (blocks a segment, block schedule period): 4:2:0 ri=6, 4:4:4 ri=11 and
# a one-component scan
SHAPES = {"420 B=36": (36, [0, 0, 0, 0, 1, 2]), "444 B=33": (33, [0, 1, 2]),
          "gray B=5": (5, [0])}


def _tables(n_comp: int):
    dc = [DC_LUMA, DC_CHROMA, DC_CHROMA][:n_comp]
    ac = [AC_LUMA, AC_CHROMA, AC_CHROMA][:n_comp]
    return pack_encoder_tables(dc, ac)


def _coefs(n: int, density: float, seed: int, amp: int = 1000):
    rng = np.random.default_rng(seed)
    q = rng.integers(-amp, amp + 1, size=(n, 64)).astype(np.int32)
    q[rng.random((n, 64)) > density] = 0
    q[1] = 0                       # an empty block: DC diff + EOB only
    q[2, 1:63] = 0
    q[2, 63] = -1                  # three ZRLs, no EOB
    return q


def _case(shape: str, density: float, n_seg: int = 3):
    B, period = SHAPES[shape]
    tabs = _tables(len(set(period)))
    sched = np.resize(np.array(period, np.int32), B)
    prev = np.array(symbols.prev_same_component(sched), np.int32)
    N = B * n_seg
    q = _coefs(N, density, seed=B + int(density * 100))
    comp = np.tile(sched, n_seg)
    T = tpu_encode.device_encoder_tables(tabs)
    jargs = (jnp.asarray(q), jnp.asarray(comp), jnp.asarray(prev),
             *map(jnp.asarray, T))
    dcf, acf = huffman_encode.packed_tables(*T)
    targs = tuple(torch.from_numpy(a) for a in (q, comp, prev, dcf, acf))
    return B, N, tabs, q, comp, jargs, targs


def _np_i32(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


@pytest.mark.parametrize("density", [0.05, 0.4, 0.9])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_symbol_parts_match_reference(shape, density):
    B, _N, _t, _q, _c, jargs, targs = _case(shape, density)
    ref = tpu_encode._symbol_parts(*jargs, B)
    got = symbols._symbol_parts(*targs, B)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), _np_i32(r))


def test_prev_same_component_matches_reference_session():
    from video_coding_tpu.model.encoder import Parameters
    from video_coding_tpu.runtime import engine

    for maker, ri in ((Parameters.c420, 6), (Parameters.c444, 11),
                      (Parameters.c422, 2)):
        jenc = engine.JpegEncoderSession(maker(64, 64, 75),
                                         restart_interval=ri)
        geom = jenc._enc_geometry(64)
        np.testing.assert_array_equal(
            symbols.prev_same_component(np.asarray(geom[5])),
            np.asarray(geom[6]))


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("density", [0.05, 0.4, 0.9])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_gather_and_split_packers_match_reference(shape, density, with_valid):
    """encode_segments_device against the reference's XLA gather packer and
    encode_segments_split (K9 + K8, plain) against its Pallas split form in
    interpret mode, on the whole output array, fitting and overflowing."""
    B, N, _t, _q, _c, jargs, targs = _case(shape, density)
    valid = (np.arange(N) < N - 2) if with_valid else None
    jvalid = None if valid is None else jnp.asarray(valid)
    tvalid = None if valid is None else torch.from_numpy(valid)
    for msb in (B * 512 + 64, 40):
        kw = dict(blocks_per_segment=B, max_seg_bytes=msb)
        ref_x = tpu_encode.encode_segments_device(*jargs, **kw, valid=jvalid)
        got_x = gather_pack.encode_segments_device(*targs, **kw, valid=tvalid)
        # the reference takes its split form only for B > 32; the short
        # gray segments are held against its gather packer instead (the
        # two are byte-identical wherever the budget fits; past it the
        # split form's cursor counts on while the gather packer's stops)
        got_s = pack_stuff.encode_segments_split(*targs, **kw, valid=tvalid)
        split_ref = B > pallas_encode.FUSED_MAX_BLOCKS
        ref_s = (pallas_encode.encode_segments_pallas(
            *jargs, **kw, valid=jvalid, interpret=True)
            if split_ref else ref_x)
        for got, ref in ((got_x, ref_x), (got_s, ref_s)):
            assert bool(got[2]) == bool(ref[2]) == (msb == 40)
            if msb != 40 or ref is not ref_x or got is got_x:
                np.testing.assert_array_equal(got[1].numpy(),
                                              np.asarray(ref[1]))
            if msb != 40:
                np.testing.assert_array_equal(got[0].numpy(),
                                              np.asarray(ref[0]))
        # and the port's three packers agree with each other and with K4
        if msb != 40:
            assert torch.equal(got_x[0], got_s[0])
            S = N // B
            v = torch.ones(N, dtype=torch.uint8) if valid is None \
                else torch.from_numpy(valid.astype(np.uint8))
            k4 = huffman_encode.encode_segments(
                targs[0].reshape(S, B * 64), v.reshape(S, B),
                targs[1][:B].contiguous(), targs[3], targs[4],
                m_out=huffman_encode.m_out_for(msb))
            assert torch.equal(k4[0], got_s[0])
            assert torch.equal(k4[1], got_s[1])


@pytest.mark.parametrize("shape", list(SHAPES))
def test_segment_coded_bits_match_reference(shape):
    B, N, tabs, q, comp, jargs, targs = _case(shape, 0.3)
    valid = np.arange(N) < N - 1
    for v in (None, valid):
        ref = tpu_encode.segment_coded_bits(
            *jargs, blocks_per_segment=B,
            valid=None if v is None else jnp.asarray(v))
        got = gather_pack.segment_coded_bits(
            *targs, blocks_per_segment=B,
            valid=None if v is None else torch.from_numpy(v))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the rate is the host coder's: 8 x bytes minus the flush padding
    segs = tscan.encode_scan(q, comp, B, _port_tables(tabs))
    bits = gather_pack.segment_coded_bits(*targs, blocks_per_segment=B)
    for s, seg in enumerate(segs):
        raw = seg.replace(b"\xff\x00", b"\xff")
        assert 0 <= 8 * len(raw) - int(bits[s]) < 8


def _port_tables(tabs) -> EncoderTables:
    return EncoderTables(tabs.dc_bits, tabs.dc_len, tabs.ac_bits, tabs.ac_len)


@pytest.mark.parametrize("bps", [96, 6, 36, 30])
def test_scan_coders_match_reference(bps):
    """encode_scan (host, pure Python) and encode_scan_tpu (gather packer)
    against the reference's host coder and device coder; bps=30 leaves a
    short last segment (whole MCUs, as every real segment holds)."""
    tabs = _tables(3)
    q = _coefs(96, 0.3, seed=bps, amp=40)
    q[:, 20:60] = 0
    ci = np.tile(np.array([0, 0, 0, 0, 1, 2], np.int32), 16)
    ref = jscan.encode_scan(q, ci, bps, tabs, use_native=False)
    assert tpu_encode.encode_scan_tpu(q, ci, bps, tabs) == ref
    ptabs = _port_tables(tabs)
    assert tscan.encode_scan(q, ci, bps, ptabs) == ref
    assert gather_pack.encode_scan_tpu(q, ci, bps, ptabs,
                                          device="cpu") == ref
    body = tscan.encode_scan_stream(q.astype(np.int16), ci, bps, ptabs)
    assert body == jscan.encode_scan_stream(q, ci, bps, tabs)


def test_scan_coders_dense_worst_case_and_range_check():
    tabs = _tables(1)
    rng = np.random.default_rng(1)
    q = rng.integers(-1000, 1000, size=(24, 64)).astype(np.int32)
    ci = np.zeros(24, np.int32)
    ptabs = _port_tables(tabs)
    for bps in (24, 5):
        ref = jscan.encode_scan(q, ci, bps, tabs, use_native=False)
        assert tscan.encode_scan(q, ci, bps, ptabs) == ref
        assert gather_pack.encode_scan_tpu(q, ci, bps, ptabs,
                                          device="cpu") == ref
    q[3, 7] = 2048
    with pytest.raises(ValueError, match="12-bit"):
        tscan.encode_scan(q, ci, 24, ptabs)
    with pytest.raises(ValueError, match="12-bit"):
        jscan.encode_scan(q, ci, 24, tabs, use_native=False)


@pytest.mark.parametrize("density", [0.0, 0.1, 0.7])
def test_sparse_transfer_matches_reference(density):
    q = _coefs(40, density, seed=9, amp=3000)     # saturates past 12 bits
    if density == 0.0:
        q[:] = 0
    nnz_true = int((q != 0).sum())
    for cap in (nnz_true + 5, max(nnz_true // 2, 1)):
        rm, rv, rn = jsparse.pack_device(jnp.asarray(q), cap)
        m, v, n = sparse.pack_device(torch.from_numpy(q), cap)
        assert int(n) == int(rn) == nnz_true
        np.testing.assert_array_equal(m.numpy(), np.asarray(rm))
        assert m.dtype == torch.uint8 and v.dtype == torch.int16
        if nnz_true <= cap:
            np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
            back = sparse.unpack_device(m, v, 40)
            np.testing.assert_array_equal(
                back.numpy(), np.asarray(jsparse.unpack_device(rm, rv, 40)))
            np.testing.assert_array_equal(back.numpy(),
                                          np.clip(q, -2048, 2047))
            np.testing.assert_array_equal(
                sparse.unpack_host(m.numpy(), v.numpy(), int(n), 40),
                jsparse.unpack_host(np.asarray(rm), np.asarray(rv),
                                    int(rn), 40))
        else:
            # overflow: the values that fit are the first cap nonzeros
            np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    hm, hv, hn = sparse.pack_host(q)
    jm, jv, jn = jsparse.pack_host(q)
    np.testing.assert_array_equal(hm, jm)
    np.testing.assert_array_equal(hv, jv)
    assert hn == jn


@pytest.mark.parametrize("B", [1, 6, 12, 32, 33, 36, 48, 720, 48960])
def test_max_lane_chunk_matches_reference(B):
    assert pack_stuff.FUSED_MAX_BLOCKS == pallas_encode.FUSED_MAX_BLOCKS
    for msb in (B * 24 + 64, B * 128 + 64, B * 512 + 64, 64, 2048):
        assert pack_stuff.max_lane_chunk(B, msb) == \
            pallas_encode.max_lane_chunk(B, msb)
