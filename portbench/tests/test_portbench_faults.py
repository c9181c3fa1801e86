"""The comparison that decides ``correct`` has to fail: the control (the
reference with the float32 DCT in the program's place) and faults
planted underneath the timed path each read ``correct: false``."""

from __future__ import annotations

import pytest
import torch

from portbench import control as control_mod
from portbench.tests.helpers import run_tiny, tiny_cell

from portbench.tests.helpers import CELLS


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_not_correct(name):
    out = control_mod.control(tiny_cell(name), 2**36 + 9)
    assert not out["correct"]
    assert out["check"]["frames_differing"]["value"] == \
        out["check"]["frames_compared"]["value"] > 0


def _unchanged(runner, inner):
    """A step that returns its state unchanged: the decoder hands back the
    previous dispatch's output (zeros at the first)."""
    last = []

    def step(entropy_list):
        out = inner(entropy_list)
        if not last:
            last.append(tuple(torch.zeros_like(p) for p in out)
                        if isinstance(out, tuple) else torch.zeros_like(out))
        prev, last[0] = last[0], out
        return prev
    return step


def _half(runner, inner):
    """Half of the batch left out."""
    def step(entropy_list):
        out = inner(entropy_list)
        n = len(entropy_list) // 2
        if isinstance(out, tuple):
            return tuple(p[:n] for p in out)
        return out[:n]
    return step


def _altered(runner, inner):
    """One answer altered where it is produced: a pixel of the first frame
    of every dispatch."""
    def step(entropy_list):
        out = inner(entropy_list)
        t = out[0] if isinstance(out, tuple) else out
        t.view(-1)[t.numel() // 3 // t.shape[0]] += 1
        return out
    return step


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_reads_not_correct(name, fault):
    def tamper(runner):
        inner = getattr(runner.session, runner.dispatch)
        setattr(runner.session, runner.dispatch, fault(runner, inner))

    result = run_tiny(tiny_cell(name), tamper=tamper)
    assert not result["correct"], result["check"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_reads_correct(name):
    assert run_tiny(tiny_cell(name))["correct"]
