"""The port's ``ops/color.py`` (plain torch, CPU) against the JAX
package's ``ops/color.py``: the resamplers on even and odd sizes, 1-row
and 1-column planes and a leading batch axis, and the color conversion
against the *jitted* JAX function (XLA fuses its multiply-adds, so the
eager JAX function is not the reference) on all 2^24 (y, u, v) triples.
Tolerance: exact equality."""

import jax
import numpy as np
import pytest
import torch

from video_coding_tpu.ops import color as jcolor
from video_coding_tpu_torch.ops import color

UPSAMPLERS = ["upsample_h2", "upsample_hv2", "upsample_v2"]
DOWNSAMPLERS = ["downsample_h2", "downsample_hv2"]
SHAPES = [(12, 10), (13, 11), (1, 7), (9, 1), (1, 1), (2, 2), (3, 5),
          (16, 3)]


def _plane(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", UPSAMPLERS)
def test_upsampler_matches_jax(name, shape):
    p = _plane(shape, sum(shape))
    want = np.asarray(getattr(jcolor, name)(p))
    got = getattr(color, name)(torch.from_numpy(p))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES + [(4, 6), (10, 2)])
@pytest.mark.parametrize("name", DOWNSAMPLERS)
def test_downsampler_matches_jax(name, shape):
    """Where JAX's strided halves broadcast (even sizes, or a half of
    size 1) the port gives the same array; where they do not, both
    raise."""
    p = _plane(shape, sum(shape) + 1)
    try:
        want = np.asarray(getattr(jcolor, name)(p))
    except (TypeError, ValueError):
        with pytest.raises(RuntimeError):
            getattr(color, name)(torch.from_numpy(p))
        return
    got = getattr(color, name)(torch.from_numpy(p))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", UPSAMPLERS + DOWNSAMPLERS)
def test_resampler_batch_axis(name):
    """A (F, h, w) stack gives each frame's own result."""
    stack = np.stack([_plane((6, 8), s) for s in range(3)])
    got = getattr(color, name)(torch.from_numpy(stack)).numpy()
    for f in range(3):
        np.testing.assert_array_equal(
            got[f], np.asarray(getattr(jcolor, name)(stack[f])))


@pytest.fixture(scope="module")
def jit_rgb():
    return jax.jit(jcolor.yuv444_to_rgb)


@pytest.mark.parametrize("y_hi", range(16))
def test_yuv444_to_rgb_exhaustive_against_jit(jit_rgb, y_hi):
    """All 2^24 (y, u, v) triples, 2^20 a case (y >> 4 == y_hi)."""
    y = np.repeat(np.arange(16 * y_hi, 16 * y_hi + 16, dtype=np.uint8),
                  65536).reshape(16, 256, 256)
    u = np.broadcast_to(np.arange(256, dtype=np.uint8)[None, :, None],
                        y.shape).copy()
    v = np.broadcast_to(np.arange(256, dtype=np.uint8)[None, None, :],
                        y.shape).copy()
    want = np.asarray(jit_rgb(y, u, v))
    got = color.yuv444_to_rgb(*(torch.from_numpy(a) for a in (y, u, v)))
    assert got.dtype == torch.uint8 and got.shape == (16, 256, 256, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_yuv444_to_rgb_int32_inputs_and_dtype(jit_rgb):
    """The upsamplers' int32 planes go in as they are; ``dtype`` sets the
    output type."""
    rng = np.random.default_rng(5)
    y, u, v = (rng.integers(0, 256, (7, 9)).astype(np.int32)
               for _ in range(3))
    want = np.asarray(jit_rgb(y, u, v))
    got = color.yuv444_to_rgb(*(torch.from_numpy(a) for a in (y, u, v)))
    np.testing.assert_array_equal(got.numpy(), want)
    wide = color.yuv444_to_rgb(*(torch.from_numpy(a) for a in (y, u, v)),
                               dtype=torch.int32)
    assert wide.dtype == torch.int32
    np.testing.assert_array_equal(wide.numpy(), want.astype(np.int32))


@pytest.mark.parametrize("shape", [(270, 480), (45, 61), (1, 1), (3, 2)])
@pytest.mark.parametrize("sub", ["420", "422"])
def test_yuv420_422_to_rgb_match_jit(sub, shape):
    """yuv420_to_rgb / yuv422_to_rgb (jitted in JAX) on random planes, one
    frame and a stack of three (JAX: jit of vmap)."""
    h, w = shape  # chroma size
    rng = np.random.default_rng(h * w)
    ys = rng.integers(0, 256, (3, 2 * h if sub == "420" else h, 2 * w),
                      dtype=np.uint8)
    us = rng.integers(0, 256, (3, h, w), dtype=np.uint8)
    vs = rng.integers(0, 256, (3, h, w), dtype=np.uint8)
    jfn = jcolor.yuv420_to_rgb if sub == "420" else jcolor.yuv422_to_rgb
    fn = color.yuv420_to_rgb if sub == "420" else color.yuv422_to_rgb
    want = np.asarray(jax.jit(jax.vmap(jfn))(ys, us, vs))
    got = fn(*(torch.from_numpy(a) for a in (ys, us, vs))).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        fn(*(torch.from_numpy(a[0]) for a in (ys, us, vs))).numpy(),
        np.asarray(jfn(ys[0], us[0], vs[0])))
