"""Plane/YUV comparison metrics: max/total/mean absolute difference,
SSE/MSE and PSNR (r=255), over the y, u, v or all planes.
"""

from __future__ import annotations

import math

import numpy as np

from ..common.plane import Plane
from .yuv import Yuv


def _check(a: Plane, b: Plane) -> None:
    if a.data.shape != b.data.shape:
        raise ValueError("planes must have identical dimensions")


def max_difference(a: Plane, b: Plane) -> int:
    _check(a, b)
    return int(np.abs(a.data.astype(np.int32) - b.data.astype(np.int32)).max())


def total_difference(a: Plane, b: Plane) -> int:
    _check(a, b)
    return int(np.abs(a.data.astype(np.int64) - b.data.astype(np.int64)).sum())


def mean_difference(a: Plane, b: Plane) -> float:
    return total_difference(a, b) / (a.width * a.height)


def square_error(a: Plane, b: Plane) -> int:
    _check(a, b)
    d = a.data.astype(np.int64) - b.data.astype(np.int64)
    return int((d * d).sum())


def mean_square_error(a: Plane, b: Plane) -> float:
    return square_error(a, b) / (a.width * a.height)


def psnr(a: Plane, b: Plane, r: float = 255.0) -> float:
    mse = mean_square_error(a, b)
    if mse == 0:
        return math.inf
    return 10.0 * math.log10(r * r / mse)


METRICS = {
    "max-difference": max_difference,
    "total-difference": total_difference,
    "mean-difference": mean_difference,
    "square-error": square_error,
    "mse": mean_square_error,
    "psnr": psnr,
}


def compare_yuv(metric: str, which: str, a: Yuv, b: Yuv):
    """Apply a metric to y, u, v or all planes ('yuv').

    Returns a scalar for single planes or a dict for 'yuv'."""
    fn = METRICS[metric]
    if which in ("y", "u", "v"):
        return fn(getattr(a, which), getattr(b, which))
    return {p: fn(getattr(a, p), getattr(b, p)) for p in "yuv"}
