"""The port's host entropy engine (``entropy/native.py``, the C++ library
built from ``csrc/host_entropy.cpp``) on the CPU: the build and its
failures, then every entry point of the scan tier (``entropy/scan.py``)
held against both the JAX package's engine (its own library, through
``video_coding_tpu.entropy.scan`` with ``use_native=True``) and the port's
pure Python / numpy tier (``use_native=False``), on inputs made from a
seed with numpy; last, the sessions' ``entropy="native"`` decode, resync
and encode against the JAX sessions. Tolerance: exact equality of bytes,
segment lists, records, coefficients, damaged lists, errors and planes."""

import functools
import pathlib

import numpy as np
import pytest

from video_coding_tpu.entropy import native as jnative
from video_coding_tpu.entropy import scan as jscan
from video_coding_tpu.runtime import engine as jengine
from video_coding_tpu_torch.common.bitstream import BitReader
from video_coding_tpu_torch.entropy import native
from video_coding_tpu_torch.entropy import scan as tscan
from video_coding_tpu_torch.model.header import Header, Parameters
from video_coding_tpu_torch.runtime.engine import (JpegDecoderSession,
                                                   JpegEncoderSession)

from _torch_fixtures import (ENCODERS, encode, encode_monochrome,
                             header_payload, synth_frame, synth_plane)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SAMPLINGS = ["420", "422", "440", "444", "mono"]


@functools.lru_cache(maxsize=None)
def _stream(sub: str, ri: int, w: int = 40, h: int = 24, q: int = 80,
            seed: int = 2) -> bytes:
    if sub == "mono":
        return encode_monochrome(synth_plane(w, h, seed), q, ri)
    return encode(sub, synth_frame(sub, w, h, seed), q, ri)


@functools.lru_cache(maxsize=None)
def _session(sub: str, ri: int) -> tuple:
    bits = BitReader(_stream(sub, ri))
    dec = JpegDecoderSession(Header.decode(bits), device="cpu")
    return dec, _stream(sub, ri)[bits.bit_pos >> 3:]


def _tiers(fn, *args, **kw):
    """fn's results by the port's engine, the JAX package's engine and the
    port's Python tier (the JAX function is fn's namesake in jscan)."""
    return (getattr(tscan, fn)(*args, **kw),
            getattr(jscan, fn)(*args, use_native=True, **kw),
            getattr(tscan, fn)(*args, use_native=False, **kw))


# -- the library -------------------------------------------------------------
def test_library_builds_under_build_dir_and_reports_abi_7():
    lib = native.load()
    path = native.library_path()
    assert path.parent == ROOT / "build" / "torch_kernels"
    assert path.name.startswith("libvct_host_entropy_") and path.exists()
    assert lib._name == str(path) and "native" not in path.parts
    assert lib.vct_version() == native.ABI_VERSION == 7
    assert native.available() and tscan.native_available()
    assert jnative.available()       # the JAX package's own library


@pytest.mark.parametrize("case", ["compile_error", "abi_mismatch"])
def test_failed_build_or_abi_mismatch_raises(monkeypatch, tmp_path, case):
    """No silent fallback: use_native=None/True raises with the compiler's
    output or the version, and only use_native=False runs Python."""
    src = tmp_path / "host_entropy.cpp"
    src.write_text("this is not C++\n" if case == "compile_error" else
                   'extern "C" int vct_version() { return 6; }\n')
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    match = "g\\+\\+ failed" if case == "compile_error" else "ABI version 6"
    with pytest.raises(RuntimeError, match=match):
        native.load()
    assert not native.available()
    data = bytes([1, 2, 0xFF, 0, 3])
    for use_native in (None, True):
        with pytest.raises(RuntimeError, match=match):
            tscan.destuff_flat(data, use_native=use_native)
    flat, lens = tscan.destuff_flat(data, use_native=False)
    assert flat.tobytes() == bytes([1, 2, 0xFF, 3]) and lens.tolist() == [4]


# -- destuff -----------------------------------------------------------------
def _stuffed_bytes(seed: int) -> bytes:
    """Random entropy-like bytes with 0xFF00 stuffing, RSTn markers, 0xFF
    fill runs, and (for some seeds) an ending marker and trailing bytes."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    for _ in range(int(rng.integers(1, 60))):
        kind = rng.integers(0, 6)
        if kind == 0:
            out += b"\xff\x00"
        elif kind == 1:
            out += bytes((0xFF, 0xD0 + int(rng.integers(0, 8))))
        elif kind == 2:
            out += b"\xff" * int(rng.integers(1, 4))
        else:
            out += rng.integers(0, 255, int(rng.integers(0, 40)),
                                dtype=np.uint8).tobytes()
    if seed % 3 == 0:
        out += bytes((0xFF, int(rng.choice([0xD9, 0xC4, 0xDA]))))
        out += rng.integers(0, 256, 10, dtype=np.uint8).tobytes()
    if seed % 5 == 0:
        out += b"\xff"                 # a lone 0xFF at the very end
    return bytes(out)


@pytest.mark.parametrize("seed", range(12))
def test_destuff_matches_both(seed):
    data = _stuffed_bytes(seed)
    got, ref, py = _tiers("destuff_segments_with_markers", data)
    assert got == ref == py
    got, ref, py = _tiers("destuff_flat", data)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, py):
        np.testing.assert_array_equal(a, b)
    assert tscan.destuff_segments(data) == got_segments(got)
    assert tscan.rst_marker_indices(data) == jscan.rst_marker_indices(data)


def got_segments(flat_lens) -> list[bytes]:
    flat, lens = flat_lens
    ends = np.cumsum(lens)
    return [flat[e - n:e].tobytes() for e, n in zip(ends, lens)]


@pytest.mark.parametrize("data", [b"", b"\xff", b"\xff\xd9", b"\xff\xd0",
                                  b"\x12\xff\xff\xff\x00\x34"])
def test_destuff_edges_match_both(data):
    got, ref, py = _tiers("destuff_segments_with_markers", data)
    assert got == ref == py


# -- lane pack ---------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_pack_lanes_sorted_matches_both(seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 50, int(rng.integers(1, 40))).astype(np.int64)
    lens[rng.integers(0, len(lens))] = 0          # an empty segment
    flat = rng.integers(0, 256, int(lens.sum()), dtype=np.uint8)
    order = np.argsort(-lens, kind="stable")
    L = int(lens.max()) + 4 + int(rng.integers(0, 9))
    got = tscan.pack_lanes_sorted(flat, lens, order, L)
    ref = jscan.pack_lanes_sorted(flat, lens, order, L)   # its engine
    py = tscan.pack_lanes_sorted(flat, lens, order, L, use_native=False)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, py)
    with pytest.raises(ValueError, match="shorter than a segment"):
        tscan.pack_lanes_sorted(flat, lens, order, int(lens.max()) - 1)


# -- decode, resync, index scan ----------------------------------------------
@pytest.mark.parametrize("ri", [0, 1, 2])
@pytest.mark.parametrize("sub", SAMPLINGS)
def test_decode_scan_matches_both(sub, ri):
    dec, payload = _session(sub, ri)
    segments = tscan.destuff_segments(payload)
    args = (segments, dec.comp_idx, dec.blocks_per_segment, dec.tables)
    got, ref, py = _tiers("decode_scan", *args)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, py)
    np.testing.assert_array_equal(got, tscan.decode_scan(*args, n_threads=1))
    fused = tscan.destuff_and_decode_scan(payload, *args[1:])
    np.testing.assert_array_equal(fused, got)
    np.testing.assert_array_equal(
        fused, jscan.destuff_and_decode_scan(payload, *args[1:]))


@pytest.mark.parametrize("ri", [0, 1, 2])
@pytest.mark.parametrize("sub", SAMPLINGS)
def test_decode_errors_match_both(sub, ri):
    """A segment of 0xFF bytes fails at the same block in every tier, and
    a wrong segment count raises in every tier."""
    dec, payload = _session(sub, ri)
    segs = tscan.destuff_segments(payload)
    k = len(segs) // 2
    bad = segs[:k] + [b"\xff" * max(4, len(segs[k]))] + segs[k + 1:]
    args = (dec.comp_idx, dec.blocks_per_segment, dec.tables)
    errors = []
    for call in (lambda: tscan.decode_scan(bad, *args),
                 lambda: jscan.decode_scan(bad, *args, use_native=True),
                 lambda: tscan.decode_scan(bad, *args, use_native=False)):
        with pytest.raises(ValueError) as e:
            call()
        errors.append(str(e.value))
    assert errors[0] == errors[1] == errors[2]
    with pytest.raises(tscan.SegmentDecodeError):
        tscan.decode_scan(bad, *args)
    for use_native in (None, False):
        with pytest.raises(ValueError, match="restart segments"):
            tscan.decode_scan(segs + [b"\x00"], *args,
                              use_native=use_native)


def _damaged(segs: list, how: str):
    """(segments, marker indices) of a damaged copy: one segment of 0xFF,
    one RSTn lost (two segments merged), a truncation, or a corrupted
    marker index."""
    n = len(segs)
    marks = [i & 7 for i in range(n - 1)]
    k = n // 2
    if how == "bad_segment":
        return segs[:k] + [b"\xff" * max(4, len(segs[k]))] + segs[k + 1:], \
            marks
    if how == "lost_marker" and n > 2:
        return segs[:k] + [segs[k] + segs[k + 1]] + segs[k + 2:], \
            marks[:k] + marks[k + 1:]
    if how == "truncated":
        return segs[:max(1, k)], marks[:max(1, k) - 1]
    if how == "bad_index" and n > 2:
        marks[k] = (marks[k] + 3) & 7
    return segs, marks


@pytest.mark.parametrize("how", ["bad_segment", "lost_marker", "truncated",
                                 "bad_index"])
@pytest.mark.parametrize("ri", [0, 1, 2])
@pytest.mark.parametrize("sub", SAMPLINGS)
def test_decode_scan_resync_matches_both(sub, ri, how):
    dec, payload = _session(sub, ri)
    segs, marks = _damaged(tscan.destuff_segments(payload), how)
    args = (segs, dec.comp_idx, dec.blocks_per_segment, dec.tables)
    for markers in (marks, None):
        got, ref, py = _tiers("decode_scan_resync", *args,
                              marker_indices=markers)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[0], py[0])
        assert got[1] == ref[1] == py[1]


def _index_case(sub: str, ri: int):
    """(flat bytes of the first segment, its block schedule, stride)."""
    dec, payload = _session(sub, ri)
    flat, lens = tscan.destuff_flat(payload)
    n = min(dec.blocks_per_segment, dec.n_blocks)
    return dec, flat[:int(lens[0])], dec.comp_idx[:n], dec.mcu_size


@pytest.mark.parametrize("ri", [0, 1, 2])
@pytest.mark.parametrize("sub", SAMPLINGS)
def test_index_scan_matches_both(sub, ri):
    dec, flat, comp, mcu = _index_case(sub, ri)
    for stride in (mcu, 2 * mcu, 7):
        got = tscan.index_scan(flat, comp, stride, dec.tables)
        ref = jscan.index_scan(flat, comp, stride, dec.tables)
        py = tscan.index_scan(flat, comp, stride, dec.tables,
                              use_native=False)
        for a, b, c in zip(got, ref, py):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("seed", range(6))
def test_index_scan_errors_match_both(seed):
    """Random bytes: the engine, the JAX package's engine and the Python
    tier give the same records or fail at the same block."""
    dec, flat, comp, mcu = _index_case("420", 0)
    rng = np.random.default_rng(seed)
    bad = flat.copy()
    at = rng.integers(0, len(bad), 1 + seed)
    bad[at] = rng.integers(0, 256, len(at), dtype=np.uint8)
    outs = []
    for call in (lambda: tscan.index_scan(bad, comp, mcu, dec.tables),
                 lambda: jscan.index_scan(bad, comp, mcu, dec.tables),
                 lambda: tscan.index_scan(bad, comp, mcu, dec.tables,
                                          use_native=False)):
        try:
            outs.append([a.tolist() for a in call()])
        except ValueError as e:
            outs.append(str(e))
    assert outs[0] == outs[1] == outs[2]


# -- encode, assembly --------------------------------------------------------
def _encode_case(seed: int, sub: str):
    """Random zigzag coefficients (sparse, long zero runs, the extremes of
    each category) on a stream's schedule and tables."""
    rng = np.random.default_rng(seed)
    params = {"420": Parameters.c420, "444": Parameters.c444,
              "mono": Parameters.monochrome}[sub](32, 16, 70)
    enc = JpegEncoderSession(params, 1 + seed % 3, device="cpu")
    n = enc.n_blocks
    q = rng.integers(-1023, 1024, (n, 64))
    q = np.where(rng.random((n, 64)) < rng.uniform(0.02, 0.6), q, 0)
    q[:, 0] = rng.integers(-1023, 1024, n)
    q[0, 1], q[-1, 63] = 1023, -1023
    return enc, q.astype(np.int32)


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
@pytest.mark.parametrize("sub", ["420", "444", "mono"])
@pytest.mark.parametrize("seed", range(3))
def test_encode_scan_matches_both(seed, sub, dtype):
    enc, q = _encode_case(seed, sub)
    q = q.astype(dtype)
    args = (q, enc.comp_idx, enc.blocks_per_segment, enc.tables)
    got, ref, py = _tiers("encode_scan", *args)
    assert got == ref == py
    assert tscan.encode_scan(*args, n_threads=1) == got
    stream = tscan.encode_scan_stream(*args)
    assert stream == jscan.encode_scan_stream(*args)
    assert stream == tscan.encode_scan_stream(*args, use_native=False)
    assert stream == tscan.join_segments(got)


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
def test_encode_range_errors_match(dtype):
    enc, q = _encode_case(0, "420")
    q[3, 5] = 2048
    args = (q.astype(dtype), enc.comp_idx, enc.blocks_per_segment,
            enc.tables)
    for fn in (tscan.encode_scan, tscan.encode_scan_stream):
        for use_native in (None, False):
            with pytest.raises(ValueError, match="12-bit"):
                fn(*args, use_native=use_native)
    q[3, 5] = 0
    bad_comp = enc.comp_idx.copy()
    bad_comp[2] = 7
    with pytest.raises(ValueError, match="comp_idx"):
        tscan.encode_scan(q, bad_comp, enc.blocks_per_segment, enc.tables)


# -- the sessions ------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_decoder(sub: str, ri: int, entropy: str):
    jh, _ = header_payload(_stream(sub, ri))
    return jengine.JpegDecoderSession(jh, impl="jnp", entropy=entropy)


def _planes(frame) -> list:
    if hasattr(frame, "y"):
        return [frame.y.data, frame.u.data, frame.v.data]
    return [p.data for p in frame]


@pytest.mark.parametrize("ri", [0, 1, 2])
@pytest.mark.parametrize("sub", SAMPLINGS)
def test_session_native_decode_matches_jax_session(sub, ri):
    dec, payload = _session(sub, ri)
    assert dec.entropy == "native"
    ref = _jax_decoder(sub, ri, "native")
    np.testing.assert_array_equal(dec.decode_entropy(payload),
                                  ref.decode_entropy(payload))
    for a, b in zip(_planes(dec.decode(payload)),
                    _planes(ref.decode(payload))):
        np.testing.assert_array_equal(a, b)
    got = dec.decode_batch([payload, payload])
    for a, b in zip(_planes(got[1]), _planes(ref.decode(payload))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("how", ["bad_segment", "lost_marker", "truncated"])
@pytest.mark.parametrize("sub", ["420", "444", "mono"])
def test_session_native_resync_matches_jax_session(sub, how):
    dec, payload = _session(sub, 1)
    segs, marks = _damaged(tscan.destuff_segments(payload), how)
    data = b""
    for i, s in enumerate(segs):
        data += s.replace(b"\xff", b"\xff\x00")
        if i < len(segs) - 1:
            data += bytes((0xFF, 0xD0 + marks[i]))
    data += b"\xff\xd9"
    ref = _jax_decoder(sub, 1, "native")
    want = ref.decode(data, resync=True)
    for entropy in ("native", "python"):
        d = JpegDecoderSession(dec.header, device="cpu", entropy=entropy)
        got = d.decode(data, resync=True)
        assert d.last_damaged_segments == ref.last_damaged_segments
        for a, b in zip(_planes(got), _planes(want)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ri", [0, 1, 3])
@pytest.mark.parametrize("sub", ["420", "422", "440", "444"])
def test_session_native_encode_matches_jax_session(sub, ri):
    frame = synth_frame(sub, 40, 24, 5)
    jenc = jengine.JpegEncoderSession(ENCODERS[sub][2](40, 24, 85), ri,
                                      entropy="native")
    enc = JpegEncoderSession(ENCODERS[sub][2](40, 24, 85), ri, device="cpu")
    assert enc.entropy == "native"
    planes = (frame.y.data, frame.u.data, frame.v.data)
    want = jenc.encode(frame)
    assert want == encode(sub, frame, 85, ri)
    assert enc.encode(planes) == want
    assert enc.encode_batch([planes, planes]) == [want, want]


@pytest.mark.parametrize("case", ["stride_0", "short_coefficients"])
def test_engine_refuses_sizes_it_would_read_past(case):
    """Sizes are checked in Python before a pointer reaches the engine."""
    if case == "stride_0":
        dec, flat, comp, _mcu = _index_case("420", 0)
        with pytest.raises(ValueError, match="stride"):
            tscan.index_scan(flat, comp, 0, dec.tables)
        return
    enc, q = _encode_case(1, "420")
    for fn in (tscan.encode_scan, tscan.encode_scan_stream):
        with pytest.raises(ValueError, match="coefficient blocks"):
            fn(q[:-1], enc.comp_idx, enc.blocks_per_segment, enc.tables)
