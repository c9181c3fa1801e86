"""Stream format converter: any format → 4:4:4 → any format, with
frame range selection, a source crop offset and stdin/stdout via '-'.
"""

from __future__ import annotations

import sys

from ..common.plane import EndOfImage
from ..common.size import Offset, Range, Size
from .yuv_format import YuvFormat


def open_in(path: str):
    return sys.stdin.buffer if path == "-" else open(path, "rb")


def open_out(path: str):
    return sys.stdout.buffer if path == "-" else open(path, "wb")


def convert_stream(fin, fout, in_size: Size, in_fmt: YuvFormat,
                   out_fmt: YuvFormat, frame_range: Range | None = None,
                   offset: Offset | None = None,
                   out_size: Size | None = None) -> int:
    """Convert frames; returns the number of frames written.

    Pipeline per frame: read in_fmt → to 4:4:4 → optional
    crop at (offset, out_size) → from 4:4:4 in out_fmt → write."""
    start = frame_range.start if frame_range else 0
    end = frame_range.end if frame_range else None
    count = 0
    index = 0
    buf = in_fmt.create(in_size)
    while True:
        if end is not None and index > end:
            break
        try:
            in_fmt.input(fin, buf)
        except EndOfImage:
            break
        if index >= start:
            yuv = in_fmt.to_444(buf)
            if offset is not None or out_size is not None:
                osz = out_size or in_size
                off = offset or Offset(0, 0)
                yuv = yuv.crop(off.x_off, off.y_off, osz.width, osz.height)
            out = out_fmt.from_444(yuv)
            out_fmt.output(fout, out)
            count += 1
        index += 1
    return count
