"""The decoder session's host-entropy half on the CPU against the JAX
package: the host decoder (``decode_scan``) and its errors, resync
(``decode_scan_resync``, ``plan_segment_alignment``) on payload damage,
dropped, doubled and corrupted RST markers, truncation and a seeded random
sweep, the session's ``decode`` for every ``entropy`` × ``coef_transfer``
and every ``device_huffman`` of ``entropy="tpu"``, ``decode_batch``,
``decode_iter``, ``decode_jpeg`` on interleaved and multi-scan streams
(with resync and a missing scan), ``expand_luts``, the ``"lut"`` loop,
``chen_inverse_8x8`` and a reference session's arrays carried across.
Frames come from ``_torch_fixtures.synth_frame``. Tolerance: exact
equality of coefficients, damaged lists and planes."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_coding_tpu.common.bitstream import BitReader as RefBitReader
from video_coding_tpu.entropy import scan as jscan
from video_coding_tpu.entropy import tpu_decode
from video_coding_tpu.model import decoder as mdec
from video_coding_tpu.model import dct as jdct
from video_coding_tpu.model import encoder as menc
from video_coding_tpu.runtime import engine
from video_coding_tpu_torch import state as tstate
from video_coding_tpu_torch.common.bitstream import BitReader
from video_coding_tpu_torch.entropy import decode_tables, huffman_decode
from video_coding_tpu_torch.entropy import scan as tscan
from video_coding_tpu_torch.model import dct as tdct
from video_coding_tpu_torch.model import decoder as tdec
from video_coding_tpu_torch.model.header import DecodeError, Header
from video_coding_tpu_torch.runtime import decode_jpeg
from video_coding_tpu_torch.runtime.engine import JpegDecoderSession

from _torch_fixtures import encode, header_payload, synth_frame

# (subsampling, width, height, restart interval): small sizes, one odd
STREAMS = [("420", 64, 48, 1), ("420", 50, 34, 3), ("422", 48, 32, 0),
           ("444", 40, 24, 1)]


@functools.lru_cache(maxsize=None)
def _stream(sub, w, h, ri, q=80, seed=1):
    return encode(sub, synth_frame(sub, w, h, seed), q, ri)


@functools.lru_cache(maxsize=None)
def _reference_session(sub, w, h, ri, **kw):
    jh, _ = header_payload(_stream(sub, w, h, ri))
    return engine.JpegDecoderSession(jh, impl="jnp", **kw)


def _port(stream, **kw):
    bits = BitReader(stream)
    return (JpegDecoderSession(Header.decode(bits), device="cpu", **kw),
            stream[bits.bit_pos >> 3:])


def _planes(frame):
    return [frame.y.data, frame.u.data, frame.v.data]


def _assert_frames(got, ref):
    for g, r in zip(_planes(got), _planes(ref)):
        np.testing.assert_array_equal(g, r)


def _restuff(original: bytes, segments: list, terminators=None) -> bytes:
    """A whole JPEG from (possibly damaged) destuffed segments: re-stuffed,
    joined with RSTn (``terminators[i]`` overrides segment i's index; None
    drops the marker, merging it with the next segment), closed by EOI."""
    bits = BitReader(original)
    Header.decode(bits)
    out = bytearray(original[:bits.bit_pos >> 3])
    for i, seg in enumerate(segments):
        out += seg.replace(b"\xff", b"\xff\x00")
        if i < len(segments) - 1:
            t = terminators[i] if terminators is not None else i & 7
            if t is not None:
                out += bytes([0xFF, 0xD0 + t])
    return bytes(out + b"\xff\xd9")


def _corrupt(segments, k, keep=0):
    """Segment k past its first ``keep`` bytes as 0xFF fill (the all-ones
    code is reserved, so the damage is always detected)."""
    segs = list(segments)
    segs[k] = segs[k][:keep] + b"\xff" * (len(segs[k]) - keep)
    return segs


# --- host decoder ------------------------------------------------------------

@pytest.mark.parametrize("sub,w,h,ri", STREAMS)
def test_decode_scan_matches_reference(sub, w, h, ri):
    _jh, payload = header_payload(_stream(sub, w, h, ri))
    jd = _reference_session(sub, w, h, ri)
    segments = tscan.destuff_segments(payload)
    assert segments == jscan.destuff_segments(payload, use_native=False)
    assert tscan.rst_marker_indices(payload) == \
        jscan.rst_marker_indices(payload)
    args = (jd.comp_idx, jd.blocks_per_segment, jd.tables)
    got = tscan.decode_scan(segments, *args)
    ref = jscan.decode_scan(segments, *args, use_native=False)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("k,keep", [(0, 0), (2, 3), (5, 1)])
def test_decode_scan_errors_match_reference(k, keep):
    _jh, payload = header_payload(_stream("420", 64, 48, 1))
    jd = _reference_session("420", 64, 48, 1)
    args = (jd.comp_idx, jd.blocks_per_segment, jd.tables)
    bad = _corrupt(tscan.destuff_segments(payload), k, keep)
    with pytest.raises(tscan.SegmentDecodeError) as got:
        tscan.decode_scan(bad, *args)
    with pytest.raises(jscan.SegmentDecodeError) as ref:
        jscan.decode_scan(bad, *args, use_native=False)
    assert got.value.block == ref.value.block
    assert str(got.value) == str(ref.value)
    assert k * jd.blocks_per_segment <= got.value.block
    for segs in (bad[:-1], bad + [b""]):
        with pytest.raises(ValueError) as got_n:
            tscan.decode_scan(segs, *args)
        with pytest.raises(ValueError) as ref_n:
            jscan.decode_scan(segs, *args, use_native=False)
        assert str(got_n.value) == str(ref_n.value)


# --- resync ------------------------------------------------------------------

def _resync_cases(segments):
    """(name, damaged destuffed segments, RSTn terminators) after the
    cases of the reference's resync tests."""
    n = len(segments)
    term = [i & 7 for i in range(n - 1)]

    def with_term(i, v, t=None):
        t = list(term if t is None else t)
        t[i] = v
        return t

    return [
        ("payload", _corrupt(segments, n // 2), None),
        ("valid prefix", _corrupt(segments, 1, len(segments[1]) // 2),
         None),
        ("truncated", segments[:n - 3], None),
        ("dropped marker", segments, with_term(5, None)),
        ("two dropped", segments, with_term(4, None, with_term(3, None))),
        ("corrupted index", segments, with_term(5, (term[5] + 3) % 8)),
        ("marker and payload", _corrupt(segments, 6), with_term(2, None)),
        ("doubled marker", segments[:4] + [b""] + segments[4:], None),
    ]


@pytest.mark.parametrize("case", range(8))
def test_decode_scan_resync_matches_reference(case):
    stream = _stream("420", 64, 48, 1)
    _jh, payload = header_payload(stream)
    jd = _reference_session("420", 64, 48, 1)
    name, segs, term = _resync_cases(tscan.destuff_segments(payload))[case]
    bad = _restuff(stream, segs, term)
    _jh, bad_payload = header_payload(bad)
    got_segs, got_marks = tscan.destuff_segments_with_markers(bad_payload)
    ref_segs, ref_marks = jscan.destuff_segments_with_markers(
        bad_payload, use_native=False)
    assert (got_segs, got_marks) == (ref_segs, ref_marks)
    args = (jd.comp_idx, jd.blocks_per_segment, jd.tables)
    for marks in (got_marks, None):
        coefs, damaged = tscan.decode_scan_resync(got_segs, *args,
                                                  marker_indices=marks)
        ref_c, ref_d = jscan.decode_scan_resync(
            ref_segs, *args, use_native=False, marker_indices=marks)
        np.testing.assert_array_equal(coefs, ref_c)
        assert damaged == ref_d, name
    # the session's resync decode against the reference session's
    port, _ = _port(stream)
    got = port.decode(bad_payload, resync=True)
    ref = jd.decode(bad_payload, resync=True)
    _assert_frames(got, ref)
    assert port.last_damaged_segments == jd.last_damaged_segments
    if name in ("dropped marker", "two dropped", "corrupted index"):
        assert port.last_damaged_segments == []


def test_plan_segment_alignment_matches_reference():
    rng = np.random.default_rng(3)
    cases = [([0, 1, 2, 3], 5, 5), ([0, 2, 3], 4, 6), ([0, 1, 5, 3], 5, 5),
             ([1, 2, 3], 4, 4), ([7, 0, 1], 4, 12), ([0, 4], 3, 6),
             ([], 1, 3), ([0, 1, 2], 4, 2)]
    for _ in range(40):
        n = int(rng.integers(1, 20))
        cases.append((rng.integers(0, 8, n - 1).tolist(), n,
                      int(rng.integers(1, 24))))
    for marks, n_received, expected in cases:
        assert tdec.plan_segment_alignment(marks, n_received, expected) == \
            mdec.plan_segment_alignment(marks, n_received, expected)


def test_resync_random_corruption_matches_reference():
    """Seeded byte corruption of the entropy region: the session never
    raises under resync, and planes and damaged lists equal the
    reference session's."""
    stream = _stream("420", 64, 48, 1)
    jd = _reference_session("420", 64, 48, 1)
    port, _ = _port(stream)
    bits = BitReader(stream)
    Header.decode(bits)
    off = bits.bit_pos >> 3
    rng = np.random.default_rng(42)
    for _trial in range(20):
        bad = bytearray(stream)
        for _ in range(int(rng.integers(1, 6))):
            bad[int(rng.integers(off, len(stream) - 2))] = \
                int(rng.integers(0, 256))
        payload = bytes(bad[off:])
        _assert_frames(port.decode(payload, resync=True),
                       jd.decode(payload, resync=True))
        assert port.last_damaged_segments == jd.last_damaged_segments


# --- the session's routes ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_coefs(sub, w, h, ri, mode):
    """The JAX session's decode_entropy: the host decoder, or the device
    loop of ``mode``."""
    _jh, payload = header_payload(_stream(sub, w, h, ri))
    if mode == "python":
        return _reference_session(sub, w, h, ri, entropy="python") \
            .decode_entropy(payload)
    return _reference_session(sub, w, h, ri, entropy="tpu",
                              device_huffman=mode).decode_entropy(payload)


@pytest.mark.parametrize("sub,w,h,ri", STREAMS)
def test_session_decode_matches_reference(sub, w, h, ri):
    stream = _stream(sub, w, h, ri)
    jh, payload = header_payload(stream)
    ref = _reference_session(sub, w, h, ri, entropy="python",
                             coef_transfer="dense").decode(payload)
    ref_coefs = _reference_coefs(sub, w, h, ri, "python")
    for entropy in ("native", "python"):
        for transfer in ("dense", "sparse", "auto"):
            port, _ = _port(stream, entropy=entropy, coef_transfer=transfer)
            np.testing.assert_array_equal(port.decode_entropy(payload),
                                          ref_coefs)
            _assert_frames(port.decode(payload), ref)
            assert port.last_damaged_segments == []
    # the sparse upload equals the reference session's
    jsp = engine.JpegDecoderSession(jh, impl="jnp", coef_transfer="sparse")
    _assert_frames(jsp.decode(payload), ref)


@pytest.mark.parametrize("how", ["auto", "pallas", "pallas_t", "range",
                                 "lut"])
@pytest.mark.parametrize("sub,w,h,ri", STREAMS[:3])
def test_session_tpu_entropy_matches_reference(sub, w, h, ri, how):
    """``entropy="tpu"`` by every strategy equals the JAX session's device
    decode (its ``range`` loop for ``"range"``, its flat-table loop for
    the others) and the host decoder."""
    stream = _stream(sub, w, h, ri)
    _jh, payload = header_payload(stream)
    port, _ = _port(stream, entropy="tpu", device_huffman=how,
                    coef_transfer="sparse")
    got = port.decode_entropy(payload)
    mode = "range" if how == "range" else "lut"
    np.testing.assert_array_equal(got, _reference_coefs(sub, w, h, ri, mode))
    np.testing.assert_array_equal(got,
                                  _reference_coefs(sub, w, h, ri, "python"))
    ref = _reference_session(sub, w, h, ri, entropy="python").decode(payload)
    _assert_frames(port.decode(payload), ref)


def test_session_rejects_wrong_segment_count_and_options():
    stream = _stream("420", 64, 48, 1)
    _jh, payload = header_payload(stream)
    segs = tscan.destuff_segments(payload)
    short = _restuff(stream, segs[:-1])
    _jh, short_payload = header_payload(short)
    with pytest.raises(ValueError, match="restart segments"):
        _port(stream)[0].decode(short_payload)
    with pytest.raises(DecodeError, match="restart segments"):
        _port(stream, entropy="tpu")[0].decode(short_payload)
    for kw in ({"entropy": "c++"}, {"coef_transfer": "int8"},
               {"device_huffman": "table"}):
        with pytest.raises(ValueError):
            _port(stream, **kw)


def test_decode_batch_and_iter_match_reference():
    streams = [_stream("420", 64, 48, 1, seed=s) for s in (1, 2, 3)]
    payloads = [header_payload(s)[1] for s in streams]
    jd = _reference_session("420", 64, 48, 1)
    refs = jd.decode_batch(payloads)
    for kw in ({"entropy": "native", "coef_transfer": "sparse"},
               {"entropy": "tpu", "coef_transfer": "dense"}):
        port, _ = _port(streams[0], **kw)
        for got, ref in zip(port.decode_batch(payloads), refs):
            _assert_frames(got, ref)
    order = [2, 0, 1, 1, 2]
    got = list(port.decode_iter([payloads[i] for i in order], depth=2))
    assert len(got) == len(order)
    for g, i in zip(got, order):
        _assert_frames(g, refs[i])


# --- decode_jpeg and the multi-scan decoder ----------------------------------

@pytest.mark.parametrize("sub,w,h,ri", STREAMS)
def test_decode_jpeg_interleaved_matches_reference(sub, w, h, ri):
    stream = _stream(sub, w, h, ri)
    _assert_frames(decode_jpeg(stream, device="cpu"),
                   engine.decode_jpeg(stream, impl="jnp"))


@pytest.mark.parametrize("sub,w,h,ri", [("420", 64, 48, 0),
                                        ("420", 50, 34, 2),
                                        ("422", 48, 32, 1),
                                        ("444", 40, 24, 3)])
def test_decode_jpeg_multi_scan_matches_reference(sub, w, h, ri):
    fn = {"420": menc.encode_420, "422": menc.encode_422,
          "444": menc.encode_444}[sub]
    frame = synth_frame(sub, w, h, 5)
    noni = fn(frame, 75, restart_interval=ri, interleaved=False)
    assert noni.count(b"\xff\xda") == 3
    got = decode_jpeg(noni, device="cpu")
    _assert_frames(got, engine.decode_jpeg(noni, impl="jnp"))
    # the same pictures as the interleaved stream of the frame
    _assert_frames(got, mdec.decode_a_frame(fn(frame, 75)))


def _both_multi_scan(data: bytes, resync: bool):
    out = []
    for dec_mod, reader in ((tdec, BitReader), (mdec, RefBitReader)):
        bits = reader(data)
        header = (Header if dec_mod is tdec else mdec.Header).decode(bits)
        d = dec_mod.MultiScanDecoder(header, bits)
        d.decode(resync=resync)
        out.append(d)
    return out


def test_multi_scan_resync_conceals_damage_as_reference():
    frame = synth_frame("420", 64, 48, 6)
    noni = menc.encode_420(frame, 75, restart_interval=2, interleaved=False)
    second = noni.index(b"\xff\xda", noni.index(b"\xff\xda") + 2)
    bad = bytearray(noni)
    bad[second + 20:second + 24] = b"\xff\x00" * 2
    bad = bytes(bad)
    with pytest.raises(DecodeError):
        decode_jpeg(bad, device="cpu")
    got, ref = _both_multi_scan(bad, resync=True)
    assert got.damaged_segments == ref.damaged_segments
    assert got.damaged_segments and all(s == 1 for s, _ in
                                         got.damaged_segments)
    _assert_frames(got.get_yuv_frame(), ref.get_yuv_frame())
    _assert_frames(decode_jpeg(bad, resync=True, device="cpu"),
                   ref.get_yuv_frame())


def test_multi_scan_missing_scan_fills_gray_as_reference():
    frame = synth_frame("420", 64, 48, 7)
    noni = menc.encode_420(frame, 75, interleaved=False)
    first = noni.index(b"\xff\xda")
    third = noni.index(b"\xff\xda", noni.index(b"\xff\xda", first + 2) + 2)
    bad = noni[:third]
    with pytest.raises(DecodeError):
        decode_jpeg(bad, device="cpu")
    got, ref = _both_multi_scan(bad, resync=True)
    assert got.missing_components == ref.missing_components == [3]
    assert got.damaged_segments == ref.damaged_segments
    frame_got = got.get_yuv_frame()
    _assert_frames(frame_got, ref.get_yuv_frame())
    assert (frame_got.v.data == 128).all()


# --- tables, transforms, state -----------------------------------------------

@pytest.mark.parametrize("sub,w,h,ri", STREAMS)
def test_expand_luts_and_pack_segments_match_reference(sub, w, h, ri):
    jd = _reference_session(sub, w, h, ri)
    for a, b in zip(decode_tables.expand_luts(jd.tables),
                    tpu_decode.expand_luts(jd.tables)):
        assert a.dtype == np.int32 and a.shape == (len(jd.components),
                                                   1 << 16)
        np.testing.assert_array_equal(a, b)
    _jh, payload = header_payload(_stream(sub, w, h, ri))
    segs = tscan.destuff_segments(payload)
    for a, b in zip(decode_tables.pack_segments(segs),
                    tpu_decode.pack_segments(segs)):
        np.testing.assert_array_equal(a, b)


def test_lut_loop_matches_reference_device_loop():
    """The ``"lut"`` plain loop equals the reference's flat-table loop on
    its own (S, L) matrix: valid rows, random rows (malformed data), a
    row cut short and zero-block lanes."""
    jd = _reference_session("420", 64, 48, 1)
    _jh, payload = header_payload(_stream("420", 64, 48, 1))
    rng = np.random.default_rng(11)
    segs = tscan.destuff_segments(payload)
    segs += [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
             for n in (5, 40, 200)] + [segs[0][:7], b""]
    segbytes, _lens = decode_tables.pack_segments(segs)
    B = jd.blocks_per_segment
    seg_blocks = np.full(len(segs), B, np.int32)
    seg_blocks[-1] = 0
    seg_blocks[-2] = 3
    sched = jd.comp_idx[:B].astype(np.int32)
    dc, ac = decode_tables.expand_luts(jd.tables)
    got = huffman_decode.decode_segments_lut_plain(
        torch.from_numpy(segbytes), torch.from_numpy(seg_blocks),
        torch.from_numpy(sched), torch.from_numpy(np.concatenate([dc, ac])),
        blocks_per_segment=B, n_components=3)
    ref = tpu_decode.decode_segments_device(
        jnp.asarray(segbytes), jnp.asarray(seg_blocks), jnp.asarray(sched),
        jnp.asarray(dc), jnp.asarray(ac), blocks_per_segment=B)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_chen_inverse_matches_reference():
    rng = np.random.default_rng(9)
    blocks = rng.integers(-2048, 2048, (200, 8, 8))
    blocks[0] = 2047
    blocks[1] = -2048
    blocks[2, ::2, 1::2] = 2047
    np.testing.assert_array_equal(tdct.chen_inverse_8x8(blocks),
                                  jdct.chen_inverse_8x8(blocks))
    np.testing.assert_array_equal(tdct.chen_inverse_8x8(blocks[3]),
                                  jdct.chen_inverse_8x8(blocks[3]))
    np.testing.assert_array_equal(tdct.chen_forward_8x8(blocks[:50] % 256),
                                  jdct.chen_forward_8x8(blocks[:50] % 256))


def test_reference_arrays_carry_across_to_the_lut_route():
    """State built from the reference session's arrays (the expanded
    tables included) round-trips and decodes as the session's own."""
    stream = _stream("422", 48, 32, 0)
    _jh, payload = header_payload(stream)
    jd = _reference_session("422", 48, 32, 0)
    ref_arrays = {"quant": jd.quant, "comp_idx": jd.comp_idx,
                  "plane_geom": jd.plane_geom,
                  "range_tables": tpu_decode.range_tables(jd.tables),
                  "luts": tpu_decode.expand_luts(jd.tables)}
    st = tstate.DecoderState.from_numpy(ref_arrays, "cpu")
    back = st.to_numpy()
    for a, b in zip(back["luts"], ref_arrays["luts"]):
        np.testing.assert_array_equal(a, b)
    port, _ = _port(stream, entropy="tpu", device_huffman="lut")
    own = port.decode_entropy(payload)
    port.load_state(st)
    np.testing.assert_array_equal(port.decode_entropy(payload), own)
    np.testing.assert_array_equal(own, _reference_coefs("422", 48, 32, 0,
                                                        "lut"))
