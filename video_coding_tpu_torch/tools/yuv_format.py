"""YUV format taxonomy and per-format file I/O: Packed {YUY2, UYVY,
YVYU} and Planar {420, 422, 444}; create/input/output per format; CLI
string parsing.
"""

from __future__ import annotations

import dataclasses
import enum

from ..common.plane import Plane
from ..common.size import Size
from . import packed_422
from .yuv import Yuv


class PackedFormat(enum.Enum):
    YUY2 = "yuy2"
    UYVY = "uyvy"
    YVYU = "yvyu"

    @property
    def offsets(self) -> tuple[int, int, int]:
        return {PackedFormat.YUY2: packed_422.YUY2,
                PackedFormat.UYVY: packed_422.UYVY,
                PackedFormat.YVYU: packed_422.YVYU}[self]


class PlanarFormat(enum.Enum):
    C420 = "420"
    C422 = "422"
    C444 = "444"


@dataclasses.dataclass(frozen=True)
class YuvFormat:
    """Either packed or planar."""

    packed: PackedFormat | None = None
    planar: PlanarFormat | None = None

    @classmethod
    def of_string(cls, s: str) -> "YuvFormat":
        s = s.lower()
        for p in PackedFormat:
            if s == p.value:
                return cls(packed=p)
        for p in PlanarFormat:
            if s in (p.value, "c" + p.value, "yuv" + p.value,
                     "yuv" + p.value + "p"):
                return cls(planar=p)
        raise ValueError(f"Unknown YUV format: {s!r}")

    # -- buffers ----------------------------------------------------------
    def create(self, size: Size):
        if self.packed is not None:
            return Plane(size.width * 2, size.height)
        fmt = self.planar
        if fmt is PlanarFormat.C420:
            return Yuv.create_420(size.width, size.height)
        if fmt is PlanarFormat.C422:
            return Yuv.create_422(size.width, size.height)
        return Yuv.create_444(size.width, size.height)

    def input(self, f, buf) -> None:
        if self.packed is not None:
            buf.input(f)
        else:
            buf.y.input(f)
            buf.u.input(f)
            buf.v.input(f)

    def output(self, f, buf) -> None:
        if self.packed is not None:
            buf.output(f)
        else:
            buf.y.output(f)
            buf.u.output(f)
            buf.v.output(f)

    def frame_bytes(self, size: Size) -> int:
        if self.packed is not None:
            return size.width * size.height * 2
        w, h = size.width, size.height
        if self.planar is PlanarFormat.C420:
            return w * h + 2 * (w // 2) * (h // 2)
        if self.planar is PlanarFormat.C422:
            return w * h + 2 * (w // 2) * h
        return 3 * w * h

    # -- to/from the 4:4:4 intermediate -----------------------------------
    def to_444(self, buf) -> Yuv:
        from . import planar_444

        if self.packed is not None:
            return planar_444.of_422(
                packed_422.to_planar(self.packed.offsets, buf))
        if self.planar is PlanarFormat.C420:
            return planar_444.of_420(buf)
        if self.planar is PlanarFormat.C422:
            return planar_444.of_422(buf)
        return buf

    def from_444(self, yuv: Yuv):
        from . import planar_444

        if self.packed is not None:
            return packed_422.of_planar(self.packed.offsets,
                                        planar_444.to_422(yuv))
        if self.planar is PlanarFormat.C420:
            return planar_444.to_420(yuv)
        if self.planar is PlanarFormat.C422:
            return planar_444.to_422(yuv)
        return yuv
