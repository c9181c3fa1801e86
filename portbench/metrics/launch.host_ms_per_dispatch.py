"""Kernel launches: host milliseconds a dispatch enqueueing its device
stages (the port's ``decode.launch`` spans: stage ``huffman``, the lane
gather and the Huffman decode route; stage ``tail``, K2 and plane
assembly) that start in the window, over its ``decode.dispatch`` spans."""

from portbench import program

SPANS = program.RECORDER


def read(run):
    dispatches = program.window(run, "decode.dispatch")
    if not dispatches:
        return None
    return program.total_ms(program.window(run, "decode.launch")) \
        / len(dispatches)
