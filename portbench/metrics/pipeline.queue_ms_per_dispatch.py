"""Entry points and pipeline: milliseconds a dispatch waits in
``_pipelined_map`` for a worker, from its submission on the caller's
thread to its start on a worker (the port's ``pipeline.queue`` spans that
start in the window), a dispatch each."""

from portbench import program

SPANS = program.RECORDER


def read(run):
    waits = program.window(run, "pipeline.queue")
    return program.total_ms(waits) / len(waits) if waits else None
