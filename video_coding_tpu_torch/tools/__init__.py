"""YUV tools: containers, packed/planar formats, chroma resampling,
comparison metrics, conversion pipeline, playback, and the Motion-JPEG
stream helpers (``tools.mjpeg``, imported on its own: it drives the
sessions)."""

from . import compare, convert, packed_422, planar_444, yuv_format
from .yuv import Yuv

__all__ = ["Yuv", "yuv_format", "packed_422", "planar_444", "compare",
           "convert"]
