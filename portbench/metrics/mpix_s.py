"""Megapixels a second: the pixels of every frame completed inside the
window, over the window's length (host clock)."""


def read(run):
    return run.completed_in_window() * run.pixels / run.seconds / 1e6
