"""Kernel launches of the encoder: host milliseconds a dispatch enqueueing
its device stages (the port's ``encode.launch`` spans: stage
``datapath``, the pad clean, block gather, K3 and segment pad; stage
``pack``, the routed entropy encode and the wire assembly, one a ladder
rung) that start in the window, over its ``encode.dispatch`` spans."""

from portbench import program

SPANS = program.RECORDER


def read(run):
    dispatches = program.window(run, "encode.dispatch")
    if not dispatches:
        return None
    return program.total_ms(program.window(run, "encode.launch")) \
        / len(dispatches)
