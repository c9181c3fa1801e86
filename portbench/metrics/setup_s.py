"""Seconds from the process's start to the window's opening: imports,
the sources made from the seed, the kernels built or loaded, the session
built, the warm-up dispatches (host clock)."""


def read(run):
    return run.setup_s
