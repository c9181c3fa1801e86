"""The port's YUV tools (``tools/``) against the JAX package's, on the
CPU: the 4:4:4 ↔ 4:2:2 / 4:2:0 conversion goldens, the packed formats,
the comparison metrics and their mismatch error, format parsing, crop and
dump, the converter on a temporary file, and the player's transforms, its
headless PNG run and its dummy-SDL run. Tolerance: exact equality (PSNR
to the float's last bit)."""

import os

import numpy as np
import pytest

from video_coding_tpu.common.plane import Plane as RefPlane
from video_coding_tpu.common.size import Offset as RefOffset
from video_coding_tpu.common.size import Range as RefRange
from video_coding_tpu.common.size import Size as RefSize
from video_coding_tpu.tools import compare as jcompare
from video_coding_tpu.tools import convert as jconvert
from video_coding_tpu.tools import packed_422 as jpacked
from video_coding_tpu.tools import planar_444 as jplanar
from video_coding_tpu.tools import play as jplay
from video_coding_tpu.tools.yuv import Yuv as RefYuv
from video_coding_tpu.tools.yuv_format import YuvFormat as RefYuvFormat
from video_coding_tpu_torch import tools
from video_coding_tpu_torch.common.plane import Plane
from video_coding_tpu_torch.common.size import Offset, Range, Size
from video_coding_tpu_torch.tools import (compare, convert, packed_422,
                                          planar_444, play)
from video_coding_tpu_torch.tools.yuv import Yuv
from video_coding_tpu_torch.tools.yuv_format import (PackedFormat,
                                                     PlanarFormat, YuvFormat)


def _ramp(cls, plane_cls):
    """The 4x4 ramp of the conversion goldens."""
    f = cls(plane_cls(4, 4), plane_cls(4, 4), plane_cls(4, 4))
    for row in range(4):
        for col in range(4):
            f.y[col, row] = row + col * 10
            f.u[col, row] = 50 + row + col * 10
            f.v[col, row] = 100 + row + col * 10
    return f


def _rand_yuv(w, h, cw, ch, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.integers(0, 256, (h, w), dtype=np.uint8),
            rng.integers(0, 256, (ch, cw), dtype=np.uint8),
            rng.integers(0, 256, (ch, cw), dtype=np.uint8)]
    return (Yuv(*(Plane(data=a.copy()) for a in arrs)),
            RefYuv(*(RefPlane(data=a.copy()) for a in arrs)))


def _same(a, b):
    for c in "yuv":
        np.testing.assert_array_equal(getattr(a, c).data, getattr(b, c).data)


def test_conversion_goldens_match_jax():
    port, ref = _ramp(Yuv, Plane), _ramp(RefYuv, RefPlane)
    p422, r422 = planar_444.to_422(port), jplanar.to_422(ref)
    _same(p422, r422)
    assert p422.u.data[:, 0].tolist() == [55, 56, 57, 58]
    p420 = planar_444.to_420(port)
    _same(p420, jplanar.to_420(ref))
    assert p420.u.data.tolist() == [[56, 76], [58, 78]]
    back420 = planar_444.of_420(p420)
    _same(back420, jplanar.of_420(jplanar.to_420(ref)))
    assert back420.u.data[0].tolist() == [56, 66, 76, 76]
    back422 = planar_444.of_422(p422)
    _same(back422, jplanar.of_422(r422))
    assert back422.v.data[3].tolist() == [108, 118, 128, 128]


@pytest.mark.parametrize("w,h", [(16, 8), (10, 6), (2, 2), (34, 18)])
def test_resampling_matches_jax_on_random_planes(w, h):
    for conv in ("to_422", "to_420"):
        port, ref = _rand_yuv(w, h, w, h, w * h)
        _same(getattr(planar_444, conv)(port), getattr(jplanar, conv)(ref))
    port, ref = _rand_yuv(w, h, w // 2, h // 2, w + h)
    _same(planar_444.of_420(port), jplanar.of_420(ref))
    port, ref = _rand_yuv(w, h, w // 2, h, w - h)
    _same(planar_444.of_422(port), jplanar.of_422(ref))
    with pytest.raises(AssertionError):
        planar_444.of_420(port)


@pytest.mark.parametrize("fmt", ["YUY2", "UYVY", "YVYU"])
def test_packed_formats_match_jax(fmt):
    port, ref = _rand_yuv(8, 3, 4, 3, 2)
    offs = getattr(packed_422, fmt)
    assert offs == getattr(jpacked, fmt) == PackedFormat[fmt].offsets
    packed = packed_422.of_planar(offs, port)
    np.testing.assert_array_equal(packed.data,
                                  jpacked.of_planar(offs, ref).data)
    _same(packed_422.to_planar(offs, packed), port)
    _same(packed_422.to_planar(offs, packed),
          jpacked.to_planar(offs, RefPlane(data=packed.data.copy())))
    one = Yuv.create_422(2, 1)
    one.y.data[...] = [[10, 20]]
    one.u.data[...] = [[30]]
    one.v.data[...] = [[40]]
    layout = {"YUY2": [10, 30, 20, 40], "UYVY": [30, 10, 40, 20],
              "YVYU": [10, 40, 20, 30]}[fmt]
    assert packed_422.of_planar(offs, one).data[0].tolist() == layout


def test_compare_metrics_match_jax():
    rng = np.random.default_rng(4)
    a, b = (rng.integers(0, 256, (9, 13), dtype=np.uint8) for _ in range(2))
    pa, pb = Plane(data=a), Plane(data=b)
    ra, rb = RefPlane(data=a), RefPlane(data=b)
    assert compare.METRICS.keys() == jcompare.METRICS.keys()
    for name, fn in compare.METRICS.items():
        assert fn(pa, pb) == jcompare.METRICS[name](ra, rb)
    assert compare.psnr(pa, pa) == float("inf")
    small = (Plane(data=np.array([[0, 10], [20, 30]], np.uint8)),
             Plane(data=np.array([[1, 10], [18, 30]], np.uint8)))
    assert [compare.max_difference(*small), compare.total_difference(*small),
            compare.square_error(*small)] == [2, 3, 5]
    port, ref = _rand_yuv(8, 4, 4, 2, 6)
    port2, ref2 = _rand_yuv(8, 4, 4, 2, 7)
    for metric in compare.METRICS:
        for which in ("y", "u", "v", "yuv"):
            assert compare.compare_yuv(metric, which, port, port2) \
                == jcompare.compare_yuv(metric, which, ref, ref2)


def test_compare_mismatch_raises():
    with pytest.raises(ValueError, match="identical dimensions"):
        compare.max_difference(Plane(2, 2), Plane(4, 4))
    with pytest.raises(ValueError):
        compare.psnr(Plane(2, 3), Plane(3, 2))


def test_format_parsing_and_sizes_match_jax():
    for s in ("420", "c422", "yuv444", "yuv420p", "YUY2", "uyvy", "yvyu"):
        fmt, ref = YuvFormat.of_string(s), RefYuvFormat.of_string(s)
        assert (fmt.packed and fmt.packed.value) == (ref.packed
                                                     and ref.packed.value)
        assert (fmt.planar and fmt.planar.value) == (ref.planar
                                                     and ref.planar.value)
        assert fmt.frame_bytes(Size(6, 4)) == ref.frame_bytes(RefSize(6, 4))
    assert YuvFormat.of_string("yuv422p").planar is PlanarFormat.C422
    with pytest.raises(ValueError, match="Unknown YUV format"):
        YuvFormat.of_string("rgb24")


def test_crop_and_dump_match_jax():
    port, ref = _ramp(Yuv, Plane), _ramp(RefYuv, RefPlane)
    _same(port.crop(1, 1, 2, 2), ref.crop(1, 1, 2, 2))
    assert port.crop(1, 1, 2, 2).y.data.tolist() == [[11, 21], [12, 22]]
    p420 = planar_444.to_420(port)
    _same(p420.crop(2, 2, 2, 2), jplanar.to_420(ref).crop(2, 2, 2, 2))
    assert p420.crop(2, 2, 2, 2).u.data.shape == (1, 1)
    assert port.dump() == ref.dump()
    assert port.is_444() and not port.is_420() and p420.is_420()
    assert Yuv.create_422(8, 2).is_422()


@pytest.mark.parametrize("in_fmt,out_fmt", [("420", "yuy2"),
                                            ("uyvy", "444"),
                                            ("444", "420")])
def test_convert_file_matches_jax(tmp_path, in_fmt, out_fmt):
    """Five frames: the frame range 1-3, an offset crop to 4x4."""
    size = Size(8, 6)
    fin = YuvFormat.of_string(in_fmt)
    raw = np.random.default_rng(8).integers(
        0, 256, 5 * fin.frame_bytes(size), dtype=np.uint8).tobytes()
    src = tmp_path / "in.yuv"
    src.write_bytes(raw)
    outs = []
    for mod, Sz, Rg, Of, Fmt in (
            (convert, Size, Range, Offset, YuvFormat),
            (jconvert, RefSize, RefRange, RefOffset, RefYuvFormat)):
        dst = tmp_path / f"out_{mod.__name__.split('.')[0]}.yuv"
        with mod.open_in(str(src)) as fi, mod.open_out(str(dst)) as fo:
            n = mod.convert_stream(fi, fo, Sz(8, 6), Fmt.of_string(in_fmt),
                                   Fmt.of_string(out_fmt), Rg(1, 3),
                                   Of(2, 2), Sz(4, 4))
        outs.append((n, dst.read_bytes()))
    assert outs[0] == outs[1] and outs[0][0] == 3
    assert len(outs[0][1]) == 3 * YuvFormat.of_string(out_fmt).frame_bytes(
        Size(4, 4))


def test_play_transforms_match_jax():
    port, ref = _rand_yuv(16, 16, 16, 16, 9)
    port2, ref2 = _rand_yuv(16, 16, 16, 16, 10)
    for which in "yuv":
        _same(play.isolate_plane(port, which), jplay.isolate_plane(ref, which))
    _same(play.diff_frames(port, port2, 3), jplay.diff_frames(ref, ref2, 3))
    _same(play.highlight_exact_diff(port, port2),
          jplay.highlight_exact_diff(ref, ref2))
    _same(play.grid_overlay(port, 4), jplay.grid_overlay(ref, 4))
    np.testing.assert_array_equal(play.yuv444_to_rgb(port),
                                  jplay.yuv444_to_rgb(ref))


def _clip(tmp_path, n=3):
    """A raw 4:2:0 file of n 16x16 frames."""
    raw = np.random.default_rng(12).integers(
        0, 256, n * 384, dtype=np.uint8).tobytes()
    path = tmp_path / "clip.yuv"
    path.write_bytes(raw)
    return path


def test_play_iter_and_headless_match_jax(tmp_path):
    pytest.importorskip("PIL")
    path = _clip(tmp_path)
    with open(path, "rb") as f, open(path, "rb") as g:
        frames = list(play.iter_frames(f, Size(16, 16),
                                       YuvFormat.of_string("420")))
        refs = list(jplay.iter_frames(g, RefSize(16, 16),
                                      RefYuvFormat.of_string("420")))
    assert len(frames) == len(refs) == 3
    for a, b in zip(frames, refs):
        _same(a, b)
    n = play.play_headless(str(path), Size(16, 16),
                           YuvFormat.of_string("420"),
                           str(tmp_path / "port"), max_frames=2,
                           transform=play.grid_overlay)
    m = jplay.play_headless(str(path), RefSize(16, 16),
                            RefYuvFormat.of_string("420"),
                            str(tmp_path / "ref"), max_frames=2,
                            transform=jplay.grid_overlay)
    assert n == m == 2
    for name in sorted(os.listdir(tmp_path / "ref")):
        assert (tmp_path / "port" / name).read_bytes() \
            == (tmp_path / "ref" / name).read_bytes()


def test_play_sdl_dummy_driver(tmp_path, monkeypatch):
    pytest.importorskip("pygame")
    path = _clip(tmp_path)
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    n = play.play_sdl(str(path), Size(16, 16), YuvFormat.of_string("420"),
                      fps=1000.0, transform=play.grid_overlay, stop_after=5)
    assert n == 5


def test_tools_package_exports():
    assert tools.__all__ == ["Yuv", "yuv_format", "packed_422",
                             "planar_444", "compare", "convert"]
    assert tools.Yuv is Yuv
