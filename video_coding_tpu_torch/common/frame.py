"""YUV frame container: three planes + chroma subsampling tag.

Capability parity with reference common/src/frame.ml (C420/C422/C444
dimension rules, subsampling inference from plane dims, planar file I/O).
"""

from __future__ import annotations

import enum

from .plane import Plane


class ChromaSubsampling(enum.Enum):
    C420 = "420"
    C422 = "422"
    C440 = "440"   # vertical-only chroma subsampling (beyond the
                   # reference's C420/C422/C444 set — frame.ml:9-21)
    C444 = "444"

    def chroma_width(self, w: int) -> int:
        # frame.ml:9-14 — 420/422 halve width (truncating); 440/444 keep it.
        return w // 2 if self in (ChromaSubsampling.C420, ChromaSubsampling.C422) else w

    def chroma_height(self, h: int) -> int:
        # frame.ml:16-21 — 420 halves height; 440 (vertical-only) too.
        return h // 2 if self in (ChromaSubsampling.C420,
                                  ChromaSubsampling.C440) else h


class Frame:
    __slots__ = ("y", "u", "v", "chroma_subsampling")

    def __init__(self, y: Plane, u: Plane, v: Plane,
                 chroma_subsampling: ChromaSubsampling):
        self.y = y
        self.u = u
        self.v = v
        self.chroma_subsampling = chroma_subsampling

    @classmethod
    def create(cls, chroma_subsampling: ChromaSubsampling, width: int,
               height: int) -> "Frame":
        cw = chroma_subsampling.chroma_width(width)
        ch = chroma_subsampling.chroma_height(height)
        return cls(
            Plane(width, height), Plane(cw, ch), Plane(cw, ch),
            chroma_subsampling)

    @staticmethod
    def infer_chroma_subsampling(y: Plane, u: Plane, v: Plane) -> ChromaSubsampling:
        """frame.ml:42-56 — infer tag from plane dims, 420 tried first."""
        if (u.width, u.height) != (v.width, v.height):
            raise ValueError("Chroma planes must be same width and height")
        for c in (ChromaSubsampling.C420, ChromaSubsampling.C422,
                  ChromaSubsampling.C440, ChromaSubsampling.C444):
            if (c.chroma_width(y.width) == u.width
                    and c.chroma_height(y.height) == u.height):
                return c
        raise ValueError("Could not infer chroma subsampling")

    @classmethod
    def of_planes(cls, y: Plane, u: Plane, v: Plane) -> "Frame":
        return cls(y, u, v, cls.infer_chroma_subsampling(y, u, v))

    @property
    def width(self) -> int:
        return self.y.width

    @property
    def height(self) -> int:
        return self.y.height

    def output(self, f) -> None:
        self.y.output(f)
        self.u.output(f)
        self.v.output(f)

    def input(self, f) -> None:
        self.y.input(f)
        self.u.input(f)
        self.v.input(f)

    def copy(self) -> "Frame":
        return Frame(self.y.copy(), self.u.copy(), self.v.copy(),
                     self.chroma_subsampling)
