"""The encoder's budget ladder: the mean launches a dispatch took (the
``rungs`` of the port's ``encode.dispatch`` spans that start in the
window). 1.0 while the locked segment budget holds; above it, overflow
retries cost launches and fetches."""

from portbench import program

SPANS = program.RECORDER


def read(run):
    rungs = [s.attrs["rungs"] for s in program.window(run, "encode.dispatch")
             if "rungs" in s.attrs]
    return sum(rungs) / len(rungs) if rungs else None
