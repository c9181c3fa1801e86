"""Single 8-bit image plane backed by a numpy array.

Capability parity with reference common/src/plane.ml (create, 2-D accessors,
blit, blit_available, raw binary file I/O, EndOfImage on short reads).
Array-first: the backing store is a (height, width) uint8 ndarray, so planes
move to a torch device as one upload.
"""

from __future__ import annotations

import numpy as np


class EndOfImage(Exception):
    """Raised when a raw file read cannot fill a whole plane.

    Mirrors Plane.End_of_image (plane.ml:63-69)."""


class Plane:
    """A (height, width) uint8 image plane.

    Indexing follows the reference convention ``p[x, y]`` (column, row) for
    scalar access; the underlying ``data`` array is (rows=height, cols=width).
    """

    __slots__ = ("data",)

    def __init__(self, width: int | None = None, height: int | None = None,
                 data: np.ndarray | None = None):
        if data is not None:
            if data.dtype != np.uint8 or data.ndim != 2:
                raise ValueError("Plane data must be a 2-D uint8 array")
            self.data = data
        else:
            if width is None or height is None:
                raise ValueError("must give width/height or data")
            self.data = np.zeros((height, width), dtype=np.uint8)

    # -- geometry ---------------------------------------------------------
    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]

    # -- accessors --------------------------------------------------------
    def __getitem__(self, xy) -> int:
        x, y = xy
        return int(self.data[y, x])

    def __setitem__(self, xy, value: int) -> None:
        x, y = xy
        self.data[y, x] = value

    # -- copies -----------------------------------------------------------
    def copy(self) -> "Plane":
        return Plane(data=self.data.copy())

    def blit(self, dst: "Plane") -> None:
        """Exact-size copy (plane.ml blit). Raises if shapes differ."""
        if dst.data.shape != self.data.shape:
            raise ValueError("blit requires identical plane shapes")
        np.copyto(dst.data, self.data)

    def blit_available(self, dst: "Plane") -> None:
        """Copy the overlapping top-left region row-wise.

        Mirrors plane.ml blit_available: min(width), min(height) overlap."""
        h = min(self.height, dst.height)
        w = min(self.width, dst.width)
        dst.data[:h, :w] = self.data[:h, :w]

    # -- file I/O ---------------------------------------------------------
    def output(self, f) -> None:
        """Write raw bytes row-major (plane.ml output)."""
        f.write(self.data.tobytes())

    def input(self, f) -> None:
        """Read raw bytes; raise EndOfImage on short read (plane.ml input)."""
        n = self.width * self.height
        buf = f.read(n)
        if len(buf) < n:
            raise EndOfImage()
        self.data[...] = np.frombuffer(buf, dtype=np.uint8).reshape(
            self.height, self.width)

    @classmethod
    def from_file(cls, f, width: int, height: int) -> "Plane":
        p = cls(width=width, height=height)
        p.input(f)
        return p

    def __repr__(self) -> str:
        return f"Plane({self.width}x{self.height})"
