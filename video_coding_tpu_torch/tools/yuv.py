"""Three-plane YUV container without a subsampling tag (dims define it):
create_444/422/420, crop, format predicates and asserts, debug dump.
"""

from __future__ import annotations

import dataclasses

from ..common.plane import Plane


@dataclasses.dataclass
class Yuv:
    y: Plane
    u: Plane
    v: Plane

    # -- constructors -----------------------------------------------------
    @classmethod
    def create_444(cls, width: int, height: int) -> "Yuv":
        return cls(Plane(width, height), Plane(width, height),
                   Plane(width, height))

    @classmethod
    def create_422(cls, width: int, height: int) -> "Yuv":
        return cls(Plane(width, height), Plane(width // 2, height),
                   Plane(width // 2, height))

    @classmethod
    def create_420(cls, width: int, height: int) -> "Yuv":
        return cls(Plane(width, height), Plane(width // 2, height // 2),
                   Plane(width // 2, height // 2))

    # -- predicates -------------------------------------------------------
    def _chroma_matches(self, wdiv: int, hdiv: int) -> bool:
        return (self.u.width == self.y.width // wdiv
                and self.v.width == self.y.width // wdiv
                and self.u.height == self.y.height // hdiv
                and self.v.height == self.y.height // hdiv)

    def is_444(self) -> bool:
        return self._chroma_matches(1, 1)

    def is_422(self) -> bool:
        return self._chroma_matches(2, 1)

    def is_420(self) -> bool:
        return self._chroma_matches(2, 2)

    def assert_is_444(self) -> None:
        assert self.is_444(), "expected 4:4:4"

    def assert_is_422(self) -> None:
        assert self.is_422(), "expected 4:2:2"

    def assert_is_420(self) -> None:
        assert self.is_420(), "expected 4:2:0"

    # -- ops ----------------------------------------------------------------
    def crop(self, x_off: int, y_off: int, width: int, height: int) -> "Yuv":
        """Crop to (width, height) at luma offset (x_off, y_off); offsets
        and dims scale with each plane's subsampling."""
        def crop_plane(p: Plane, xs: int, ys: int) -> Plane:
            x0, y0 = x_off // xs, y_off // ys
            w, h = width // xs, height // ys
            return Plane(data=p.data[y0:y0 + h, x0:x0 + w].copy())

        xs = self.y.width // self.u.width if self.u.width else 1
        ys = self.y.height // self.u.height if self.u.height else 1
        return Yuv(crop_plane(self.y, 1, 1), crop_plane(self.u, xs, ys),
                   crop_plane(self.v, xs, ys))

    def dump(self) -> str:
        """Debug dump like Yuv.For_testing.dump_yuv."""
        parts = []
        for p in (self.y, self.u, self.v):
            for row in p.data:
                parts.append(" ".join(f"{int(v):3d}" for v in row))
        return "\n".join(parts)
