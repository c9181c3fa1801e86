"""The card: the share of its idle time in the traced window during
which no span of the port was open on any thread, so that no host code of
the port held it. The ten longest gaps, each put down to the port span
with the most self time over it, go to standard error."""

import sys

from portbench import program

SPANS = program.RECORDER


def read(run):
    items = program.spans(run)
    if not items:
        return None
    gaps = [[lo, hi] for lo, hi in sorted(run.trace.gaps())]
    idle = sum(hi - lo for lo, hi in gaps)
    if not idle:
        return None
    print(f"port spans over the longest idle gaps: "
          f"{program.idle_gaps(run)}", file=sys.stderr)
    held = program.overlap(program.union((s.start, s.end) for s in items),
                           gaps)
    return 100.0 * (idle - held) / idle
