"""Device-to-host copies of the encoder: host milliseconds a frame in the
port's ``encode.fetch`` spans (each copy of the budget ladder: the
lengths and overflow flag, then the bodies; the first waits for the
dispatch's kernels) that start in the window, over the frames of the
``encode.dispatch`` spans that start in it."""

from portbench import program

SPANS = program.RECORDER


def read(run):
    frames = sum(s.attrs.get("frames", 0)
                 for s in program.window(run, "encode.dispatch"))
    if not frames:
        return None
    return program.total_ms(program.window(run, "encode.fetch")) / frames
