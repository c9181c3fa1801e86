"""Shared pieces of the benchmark's CPU tests: a cell cut to a tiny frame
and run on the port's plain CPU versions."""

from __future__ import annotations

import dataclasses
import time

from portbench import harness

TINY = {"width": 256, "height": 128}
CELLS = ("decode-4k-tworow-q90",)


def tiny_cell(name: str, root=harness.ROOT) -> harness.Cell:
    """The cell at 256x128 (restart intervals of whole MCU rows kept as
    many rows), two warm-up dispatches, 16 frames sampled."""
    cell = harness.load_cell(name, root)
    t = dict(cell.traffic, warmup_dispatches=2, sample_frames=16)
    row = -(-cell.config["width"] // 16)
    if t["restart_interval_in"] % row == 0:
        t["restart_interval_in"] = t["restart_interval_in"] // row \
            * (TINY["width"] // 16)
    return dataclasses.replace(cell, config=dict(cell.config, **TINY),
                               traffic=t)


def run_tiny(cell: harness.Cell, seed: int = 2**40 + 3, seconds=1.0,
             traced=False, tamper=None) -> dict:
    return harness.execute(cell, seed, seconds, traced, time.perf_counter(),
                           device="cpu", tamper=tamper, log=lambda m: None)
