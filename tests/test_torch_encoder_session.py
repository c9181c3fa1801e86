"""The port's JpegEncoderSession as a whole on the CPU (every kernel
through its plain version): the fused device encode by ``device_pack``
against the reference session's Pallas route (interpret mode) and the
golden model, and the host-entropy entry points by ``entropy`` and
``coef_transfer`` against the reference session. Tolerance: exact byte
equality."""

import functools

import numpy as np
import pytest

from video_coding_tpu.runtime import engine as jengine
from video_coding_tpu.entropy import tpu_encode
from video_coding_tpu_torch import state
from video_coding_tpu_torch.common.frame import ChromaSubsampling, Frame
from video_coding_tpu_torch.common.plane import Plane
from video_coding_tpu_torch.entropy import (gather_pack, huffman_encode,
                                            pack_stuff)
from video_coding_tpu_torch.model.header import Parameters
from video_coding_tpu_torch.ops import lookup
from video_coding_tpu_torch.runtime import engine
from video_coding_tpu_torch.runtime.engine import (JpegEncoderSession,
                                                   encode_jpeg)

from _torch_fixtures import ENCODERS, encode, synth_frame

W = H = 64
Q = 75
# subsampling → restart interval: 4:2:0 ri=6 is B = 36 with a short last
# segment (16 MCUs), 4:4:4 ri=11 is B = 33, 4:2:2 ri=9 is B = 36
CASES = {"420": 6, "444": 11, "422": 9}
MAKERS = {"420": Parameters.c420, "422": Parameters.c422,
          "444": Parameters.c444}
SUBSAMPLING = {"420": ChromaSubsampling.C420, "422": ChromaSubsampling.C422,
               "444": ChromaSubsampling.C444}


def _port_frame(jframe) -> Frame:
    """The port's Frame of a reference-package Frame (same arrays)."""
    return Frame(Plane(data=jframe.y.data), Plane(data=jframe.u.data),
                 Plane(data=jframe.v.data),
                 ChromaSubsampling[jframe.chroma_subsampling.name])


@functools.lru_cache(maxsize=None)
def _frames(sub: str):
    return tuple(synth_frame(sub, W, H, seed) for seed in (11, 12))


@functools.lru_cache(maxsize=None)
def _golden(sub: str):
    return [encode(sub, f, Q, CASES[sub]) for f in _frames(sub)]


@functools.lru_cache(maxsize=None)
def _reference_device(sub: str):
    """The reference session's fused encode through its Pallas route
    (interpret mode on the CPU; B > 32, so its split form)."""
    jenc = jengine.JpegEncoderSession(ENCODERS[sub][2](W, H, Q), CASES[sub],
                                      device_pack="pallas")
    return jenc.encode_device_batch(list(_frames(sub)))


@pytest.mark.parametrize("pack", ["pallas", "xla", "auto"])
@pytest.mark.parametrize("sub", list(CASES))
def test_encode_device_batch_by_device_pack(sub, pack, monkeypatch):
    """Every packer route gives the reference's and the golden model's
    bytes, and takes the packer its name says."""
    calls = []
    for mod, name in ((pack_stuff, "encode_segments_split"),
                      (gather_pack, "encode_segments_device"),
                      (engine, "encode_segments")):
        fn = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda *a, _fn=fn, _n=name, **k: (calls.append(_n),
                                                         _fn(*a, **k))[1])
    enc = JpegEncoderSession(MAKERS[sub](W, H, Q), CASES[sub], device="cpu",
                             device_pack=pack)
    assert enc.blocks_per_segment > pack_stuff.FUSED_MAX_BLOCKS
    outs = enc.encode_device_batch([_port_frame(f) for f in _frames(sub)])
    assert outs == _reference_device(sub)
    assert outs == _golden(sub)
    # 64x64 frames give far fewer than 64 segments: auto takes the gather
    # packer, as the reference's rule does
    want = "encode_segments_split" if pack == "pallas" \
        else "encode_segments_device"
    assert set(calls) == {want}
    # a second dispatch runs at the locked budget
    assert enc.encode_device(_port_frame(_frames(sub)[1])) == outs[1]


def test_fused_route_for_short_segments_and_frame_inputs():
    """B <= 32 with device_pack="pallas" stays on K4; Frame objects, bare
    arrays and padded planes are the same input."""
    jf = _frames("420")[0]
    f = _port_frame(jf)
    enc = JpegEncoderSession(Parameters.c420(W, H, Q), 2, device="cpu",
                             device_pack="pallas")
    assert enc._pack_route(8, 512) == "fused"
    ref = encode("420", jf, Q, 2)
    assert enc.encode_device(f) == ref
    assert enc.encode_planes_device((f.y.data, f.u.data, f.v.data)) == ref
    assert enc.encode_device_batch([enc.load_planes(f)]) == [ref]
    gray = JpegEncoderSession(Parameters.c420(W, H, Q), 2, device="cpu")
    assert len(gray.load_planes(f.y)) == 1


@pytest.mark.parametrize("B,msb,S,pack,route", [
    (6, 208, 130560, "auto", "fused"),     # 1080p 4:2:0 ri=1, 16 frames
    (48, 1216, 16320, "auto", "split"),    # 1080p 4:2:0 ri=8, 16 frames
    (48, 1216, 63, "auto", "gather"),      # too few segments
    (720, 17344, 1088, "auto", "gather"),  # one MCU row: lane chunk < 128
    (48960, 1175104, 16, "auto", "gather"),
    (32, 832, 8, "pallas", "fused"),
    (33, 856, 8, "pallas", "split"),
    (6, 208, 130560, "xla", "gather"),
])
def test_pack_route_rule(B, msb, S, pack, route):
    """The route is the reference's integer rule on (B, budget, S)."""
    from video_coding_tpu.entropy import pallas_encode

    enc = JpegEncoderSession(Parameters.c420(16, 16, Q), 1, device="cpu",
                             device_pack=pack)
    enc.blocks_per_segment = B
    assert enc._pack_route(S, msb) == route
    if pack == "auto":
        wide = pallas_encode.max_lane_chunk(B, msb) >= 128 and S >= 64
        assert (route != "gather") == wide


@pytest.mark.parametrize("transfer", ["dense", "sparse", "auto"])
@pytest.mark.parametrize("entropy", ["python", "tpu", "native"])
def test_host_entropy_entry_points(entropy, transfer):
    """encode, encode_planes, encode_batch and encode_iter by entropy and
    coef_transfer against the reference session with the same options."""
    sub, ri = "420", 6
    jframes = list(_frames(sub))
    jenc = jengine.JpegEncoderSession(ENCODERS[sub][2](W, H, Q), ri,
                                      entropy=entropy,
                                      coef_transfer=transfer)
    ref = [jenc.encode(f) for f in jframes]
    assert ref == _golden(sub)
    assert jenc.encode_batch(jframes) == ref
    enc = JpegEncoderSession(MAKERS[sub](W, H, Q), ri, device="cpu",
                             entropy=entropy, coef_transfer=transfer)
    frames = [_port_frame(f) for f in jframes]
    assert enc._sparse == (transfer == "sparse")
    assert [enc.encode(f) for f in frames] == ref
    assert enc.encode_planes(enc.load_planes(frames[0])) == ref[0]
    assert enc.encode_batch(frames) == ref
    order = [0, 1, 1, 0, 1]
    assert list(enc.encode_iter((frames[i] for i in order), depth=2)) == \
        [ref[i] for i in order]


def test_quantize_device_transfers_and_cap_adaptation():
    """Dense and sparse downloads carry the same coefficients, equal to
    the reference session's; the sparse budget shrinks once to the
    content's density, and a budget that proves too small falls back to
    dense for that call and doubles."""
    sub, ri = "420", 6
    jf = _frames(sub)[0]
    jenc = jengine.JpegEncoderSession(ENCODERS[sub][2](W, H, Q), ri,
                                      coef_transfer="dense")
    ref = np.asarray(jenc.quantize_device(jenc.load_planes(jf)))
    dense = JpegEncoderSession(MAKERS[sub](W, H, Q), ri, device="cpu",
                               coef_transfer="dense")
    sparse = JpegEncoderSession(MAKERS[sub](W, H, Q), ri, device="cpu",
                                coef_transfer="sparse")
    planes = dense.load_planes(_port_frame(jf))
    qd = dense.quantize_device(planes)
    assert qd.dtype == np.int16
    np.testing.assert_array_equal(qd, ref)
    qs = sparse.quantize_device(planes)
    np.testing.assert_array_equal(qs, ref)
    nnz = int((ref != 0).sum())
    per_block = max(2, -(-2 * nnz // ref.shape[0]))
    assert sparse._cap_locked
    assert sparse._cap_per_block == min(16, 1 << (per_block - 1).bit_length())
    sparse._cap_per_block = 1          # far below the content's density
    np.testing.assert_array_equal(sparse.quantize_device(planes), ref)
    assert sparse._cap_per_block == 2


@pytest.mark.parametrize("sub", ["420", "422", "444"])
def test_encode_jpeg_matches_reference(sub):
    jf = _frames(sub)[0]
    ref = jengine.encode_jpeg(jf, 60, ENCODERS[sub][0], restart_interval=3)
    assert ref == encode(sub, jf, 60, 3)
    assert encode_jpeg(_port_frame(jf), 60, SUBSAMPLING[sub],
                       restart_interval=3, device="cpu") == ref


@pytest.mark.parametrize("sub", list(CASES))
def test_session_from_reference_state(sub):
    """A port session loaded through state.from_numpy from the reference
    session's arrays computes the same bytes on every packer route."""
    ri = CASES[sub]
    jenc = jengine.JpegEncoderSession(ENCODERS[sub][2](W, H, Q), ri)
    arrays = {"quant": jenc.quant, "comp_idx": jenc.comp_idx,
              "perm": np.asarray(jenc._perm_dev), "gather": jenc.gather,
              "tables": tpu_encode.device_encoder_tables(jenc.tables),
              "prev_same_comp": np.asarray(jenc._enc_geometry(64)[6])}
    frames = [_port_frame(f) for f in _frames(sub)]
    for pack in ("pallas", "xla"):
        enc = JpegEncoderSession(MAKERS[sub](W, H, Q), ri, device="cpu",
                                 device_pack=pack)
        enc.load_state(state.EncoderState.from_numpy(arrays, "cpu"))
        assert enc.encode_device_batch(frames) == _golden(sub)
    bad = dict(arrays, prev_same_comp=arrays["prev_same_comp"][:-1])
    with pytest.raises(ValueError, match="prev_same_comp"):
        enc.load_state(state.EncoderState.from_numpy(bad, "cpu"))


@pytest.mark.parametrize("sub", ["C420", "C422", "C440", "C444"])
def test_common_copies_match_reference(sub):
    """The port's own Frame, Plane, Size, Range, Offset and standard sizes
    behave as the reference package's."""
    import io

    from video_coding_tpu.common import frame as jframe
    from video_coding_tpu.common import plane as jplane
    from video_coding_tpu.common import size as jsize
    from video_coding_tpu.common import stdsizes as jstd
    from video_coding_tpu_torch.common import size, stdsizes

    assert stdsizes.SIZES == jstd.SIZES
    for text in ("1080p", "cif", "33x17", "7", "-9", "3-8", "4,5", "x", ""):
        for name in ("Size", "Range", "Offset"):
            try:
                want = vars(getattr(jsize, name).of_string(text))
            except ValueError as exc:
                with pytest.raises(ValueError, match=str(exc)[:20]):
                    getattr(size, name).of_string(text)
            else:
                assert vars(getattr(size, name).of_string(text)) == want
    c, jc = ChromaSubsampling[sub], jframe.ChromaSubsampling[sub]
    assert c.value == jc.value
    for w, h in ((64, 48), (33, 17)):
        assert (c.chroma_width(w), c.chroma_height(h)) == \
            (jc.chroma_width(w), jc.chroma_height(h))
    rng = np.random.default_rng(5)
    f, jf = Frame.create(c, 34, 18), jframe.Frame.create(jc, 34, 18)
    raw = rng.integers(0, 256, 34 * 18 * 3, dtype=np.uint8).tobytes()
    f.input(io.BytesIO(raw))
    jf.input(io.BytesIO(raw))
    for p, jp in zip((f.y, f.u, f.v), (jf.y, jf.u, jf.v)):
        np.testing.assert_array_equal(p.data, jp.data)
        assert (p.width, p.height, p[3, 2]) == (jp.width, jp.height, jp[3, 2])
    assert Frame.of_planes(f.y, f.u, f.v).chroma_subsampling.name == \
        jframe.Frame.of_planes(jf.y, jf.u, jf.v).chroma_subsampling.name
    out, jout = io.BytesIO(), io.BytesIO()
    f.copy().output(out)
    jf.copy().output(jout)
    assert out.getvalue() == jout.getvalue()
    small, jsmall = Plane(width=5, height=4), jplane.Plane(width=5, height=4)
    f.y.blit_available(small)
    jf.y.blit_available(jsmall)
    np.testing.assert_array_equal(small.data, jsmall.data)
    with pytest.raises(ValueError):
        f.y.blit(small)
    with pytest.raises(ValueError):
        Plane(data=np.zeros((2, 2), np.int32))


def test_session_rejects_unknown_options():
    for kw in ({"entropy": "lut"}, {"coef_transfer": "packed"},
               {"device_pack": "triton"}):
        with pytest.raises(ValueError, match=next(iter(kw))):
            JpegEncoderSession(Parameters.c420(16, 16, Q), 1, device="cpu",
                               **kw)


def test_wrappers_count_no_launch_on_the_cpu():
    """On CPU tensors the wrappers run their plain versions and count no
    kernel launch."""
    before = (lookup.table_lookup.launches, pack_stuff.pack_stuff.launches,
              huffman_encode.encode_segments.launches)
    enc = JpegEncoderSession(Parameters.c420(W, H, Q), 6, device="cpu",
                             device_pack="pallas")
    enc.encode_device(_port_frame(_frames("420")[0]))
    assert before == (lookup.table_lookup.launches,
                      pack_stuff.pack_stuff.launches,
                      huffman_encode.encode_segments.launches)


# a restart interval longer than the frame: one segment, shorter than B
LONG_RI = [("420", 16, 16, 2), ("420", 16, 16, 5), ("420", 8, 9, 2),
           ("420", 32, 16, 3), ("444", 8, 8, 2)]


@pytest.mark.parametrize("pack", ["xla", "auto", "pallas"])
@pytest.mark.parametrize("sub,w,h,ri", LONG_RI)
def test_restart_interval_longer_than_the_frame(sub, w, h, ri, pack):
    """encode_device and encode_device_batch under every device_pack, and
    the host-entropy routes, give the JAX session's and the golden
    model's bytes: the segment's schedule and its DC predictor gather are
    built at length B."""
    jframe = synth_frame(sub, w, h, 3)
    golden = encode(sub, jframe, Q, ri)
    jenc = jengine.JpegEncoderSession(ENCODERS[sub][2](w, h, Q), ri,
                                      device_pack=pack)
    assert jenc.encode_device_batch([jframe, jframe]) == [golden, golden]
    enc = JpegEncoderSession(MAKERS[sub](w, h, Q), ri, device="cpu",
                             device_pack=pack)
    assert enc.blocks_per_segment > enc.n_blocks
    f = _port_frame(jframe)
    assert enc.encode_device(f) == golden
    assert enc.encode_device_batch([f, f]) == [golden, golden]
    for entropy in ("native", "python", "tpu"):
        host = JpegEncoderSession(MAKERS[sub](w, h, Q), ri, device="cpu",
                                  entropy=entropy)
        assert host.encode(f) == golden
        assert host.encode_batch([f, f]) == [golden, golden]
