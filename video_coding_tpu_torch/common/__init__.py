"""Common runtime pieces: planes, frames, bitstream I/O, sizes."""

from .bitstream import BitReader, BitWriter
from .frame import ChromaSubsampling, Frame
from .plane import Plane
from .size import Offset, Range, Size

__all__ = ["BitReader", "BitWriter", "ChromaSubsampling", "Frame", "Plane",
           "Offset", "Range", "Size"]
