"""The card: the share of the traced window that the union of its
kernels, copies and memsets leaves uncovered."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
