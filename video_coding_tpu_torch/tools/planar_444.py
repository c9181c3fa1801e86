"""Chroma resampling: 4:4:4 ↔ 4:2:2 and 4:4:4 ↔ 4:2:0.

Co-located pixel model, avg2/avg4 kernels with round-to-nearest (+1>>1,
+2>>2), edge replication at the right and bottom borders, vectorized with
numpy (``ops/color.py`` is the same arithmetic on device tensors).
"""

from __future__ import annotations

import numpy as np

from ..common.plane import Plane
from .yuv import Yuv


def _avg2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return ((a.astype(np.uint16) + b + 1) >> 1).astype(np.uint8)


def _avg4(a, b, c, d) -> np.ndarray:
    return ((a.astype(np.uint16) + b + c + d + 2) >> 2).astype(np.uint8)


def _subsample_h2(src: np.ndarray) -> np.ndarray:
    """(h, w) → (h, w/2) by horizontal pair average."""
    return _avg2(src[:, 0::2], src[:, 1::2])


def _supersample_h2(src: np.ndarray) -> np.ndarray:
    """(h, w) → (h, 2w): even cols copy, odd cols average with the right
    neighbor (replicated at the edge)."""
    h, w = src.shape
    right = np.pad(src, ((0, 0), (0, 1)), mode="edge")[:, 1:]
    out = np.empty((h, 2 * w), dtype=np.uint8)
    out[:, 0::2] = src
    out[:, 1::2] = _avg2(src, right)
    return out


def _subsample_hv2(src: np.ndarray) -> np.ndarray:
    """(h, w) → (h/2, w/2) by 2x2 average."""
    return _avg4(src[0::2, 0::2], src[0::2, 1::2],
                 src[1::2, 0::2], src[1::2, 1::2])


def _supersample_hv2(src: np.ndarray) -> np.ndarray:
    """(h, w) → (2h, 2w) with bilinear-style interpolation and edge
    replication (planar_444.ml:84-106)."""
    h, w = src.shape
    b = np.pad(src, ((0, 0), (0, 1)), mode="edge")[:, 1:]    # right
    c = np.pad(src, ((0, 1), (0, 0)), mode="edge")[1:, :]    # below
    d = np.pad(src, ((0, 1), (0, 1)), mode="edge")[1:, 1:]   # below-right
    out = np.empty((2 * h, 2 * w), dtype=np.uint8)
    out[0::2, 0::2] = src
    out[0::2, 1::2] = _avg2(src, b)
    out[1::2, 0::2] = _avg2(src, c)
    out[1::2, 1::2] = _avg4(src, b, c, d)
    return out


def to_422(src: Yuv) -> Yuv:
    src.assert_is_444()
    return Yuv(Plane(data=src.y.data.copy()),
               Plane(data=_subsample_h2(src.u.data)),
               Plane(data=_subsample_h2(src.v.data)))


def of_422(src: Yuv) -> Yuv:
    src.assert_is_422()
    return Yuv(Plane(data=src.y.data.copy()),
               Plane(data=_supersample_h2(src.u.data)),
               Plane(data=_supersample_h2(src.v.data)))


def to_420(src: Yuv) -> Yuv:
    src.assert_is_444()
    return Yuv(Plane(data=src.y.data.copy()),
               Plane(data=_subsample_hv2(src.u.data)),
               Plane(data=_subsample_hv2(src.v.data)))


def of_420(src: Yuv) -> Yuv:
    src.assert_is_420()
    return Yuv(Plane(data=src.y.data.copy()),
               Plane(data=_supersample_hv2(src.u.data)),
               Plane(data=_supersample_hv2(src.v.data)))
