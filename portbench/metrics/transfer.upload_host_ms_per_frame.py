"""Host-device copies, the host's side: milliseconds a frame in the
port's ``upload`` spans (every host array the sessions copy to the card)
that start in the window, over the frames of the ``decode.dispatch``
spans that start in it. A pageable copy that only stages reads a fraction
of a millisecond; one that waits for the stream reads the wait."""

from portbench import program

SPANS = program.RECORDER


def read(run):
    frames = sum(s.attrs.get("frames", 0)
                 for s in program.window(run, "decode.dispatch"))
    if not frames:
        return None
    return program.total_ms(program.window(run, "upload")) / frames
