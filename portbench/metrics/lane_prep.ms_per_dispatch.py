"""Host lane prep: milliseconds a dispatch from the destuffed frames to
the first upload (lengths, lane order and offsets or the padded lane
matrix, the lane bucket, the joined flat buffer; the port's
``decode.lane_prep`` spans that start in the window)."""

from portbench import program

SPANS = program.RECORDER


def read(run):
    preps = program.window(run, "decode.lane_prep")
    return program.total_ms(preps) / len(preps) if preps else None
