"""Huffman decode kernels: the useful share of the (lanes, L) lane matrix
the padded-matrix decode walks, 100 x the segments' bytes over lanes x L,
from the counts of the port's ``decode.lane_prep`` spans that start in
the window (routes that read the flat buffer record no L)."""

from portbench import program

SPANS = program.RECORDER


def read(run):
    preps = [s for s in program.window(run, "decode.lane_prep")
             if "lane_len" in s.attrs]
    walked = sum(s.attrs["lanes"] * s.attrs["lane_len"] for s in preps)
    if not walked:
        return None
    return 100.0 * sum(s.attrs["lane_bytes"] for s in preps) / walked
