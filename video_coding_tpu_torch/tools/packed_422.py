"""Packed ↔ planar 4:2:2 conversion driven by byte-offset descriptors:
a format is the (y, u, v) byte positions within each 4-byte group;
yuy2 = (0,1,3), uyvy = (1,0,2), yvyu = (0,3,1).
"""

from __future__ import annotations

from ..common.plane import Plane
from .yuv import Yuv

YUY2 = (0, 1, 3)
UYVY = (1, 0, 2)
YVYU = (0, 3, 1)


def to_planar(fmt: tuple[int, int, int], src: Plane) -> Yuv:
    """Packed (h, 2w) plane → planar 4:2:2 Yuv."""
    yo, uo, vo = fmt
    data = src.data
    h = src.height
    w = src.width // 2
    dst = Yuv.create_422(w, h)
    dst.y.data[:, 0::2] = data[:, yo::4]
    dst.y.data[:, 1::2] = data[:, yo + 2::4]
    dst.u.data[...] = data[:, uo::4]
    dst.v.data[...] = data[:, vo::4]
    return dst


def of_planar(fmt: tuple[int, int, int], src: Yuv) -> Plane:
    """Planar 4:2:2 Yuv → packed (h, 2w) plane."""
    src.assert_is_422()
    yo, uo, vo = fmt
    w = src.y.width
    h = src.y.height
    out = Plane(w * 2, h)
    out.data[:, yo::4] = src.y.data[:, 0::2]
    out.data[:, yo + 2::4] = src.y.data[:, 1::2]
    out.data[:, uo::4] = src.u.data
    out.data[:, vo::4] = src.v.data
    return out
