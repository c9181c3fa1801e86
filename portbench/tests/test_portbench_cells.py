"""Each cell end to end at a tiny size on the port's plain CPU versions:
the loop, the sample, the check and the result's last-line shape."""

from __future__ import annotations

import json

import pytest

from portbench.tests.helpers import CELLS, run_tiny, tiny_cell


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_at_a_tiny_size(name):
    cell = tiny_cell(name)
    result = run_tiny(cell)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "check"
    assert result["correct"], result["check"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["check"]["frames_compared"]["value"] >= \
        cell.traffic["frames_per_dispatch"]
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert result["metrics"]["setup_s"]["value"] > 0
    json.loads(json.dumps(result))


def test_traced_run_reports_no_device_metric_off_the_card():
    """A traced run on the CPU has no device trace: its device readers
    find nothing, and none reports a number under a device metric; the
    host clock's per-layer metric is there."""
    cell = tiny_cell("decode-4k-tworow-q90")
    result = run_tiny(cell, traced=True)
    assert result["correct"]
    device = {m["name"] for m in cell.per_layer
              if m["source"] == "device_trace"}
    assert device and not device & set(result["metrics"])
    assert "p95_frame_ms" in result["metrics"]
    assert "busy_s" not in result["device"]
