"""The re-encode cell ``transcode-1080p-ri1`` on the port's plain CPU
versions: found by name beside the decode cell, correct end to end when
shrunk, the comparison failing for the float32 control and for a dropped
frame, and the encoder's work counts against a hand count."""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from portbench import control as control_mod
from portbench import harness, work_encode
from portbench.tests.helpers import run_tiny

NAME = "transcode-1080p-ri1"
# the smallest frame the benchmark's generator draws (its rectangles
# need more than 64 pixels each way); 5 x 5 MCUs, the last row and
# column partial, so the pad clean has work
SMALL = {"width": 80, "height": 72}
METRICS = {"huffman_encode.roofline_pct", "encode_datapath.roofline_pct",
           "encode.fetch_host_ms_per_frame",
           "encode.launch_host_ms_per_dispatch",
           "encode.ladder_rungs_per_dispatch"}
# the decode half's metrics, which the cell shares with the decode cell
SHARED = {"p95_frame_ms", "host_entropy.ms_per_frame",
          "huffman_decode.roofline_pct", "datapath.roofline_pct",
          "transfer.copy_ms_per_frame", "device.idle_pct",
          "pipeline.queue_ms_per_dispatch",
          "host_entropy.program_ms_per_frame", "lane_prep.ms_per_dispatch",
          "transfer.upload_host_ms_per_frame", "launch.host_ms_per_dispatch",
          "device.idle_unexplained_pct"}


def small_cell(tmp_path) -> harness.Cell:
    """The cell from a temporary copy of its configuration at 80x72, two
    warm-up dispatches of 4 frames, 16 frames sampled."""
    bench = harness.load_manifest()
    cell = harness.load_cell(NAME)
    cfg = dict(cell.config, **SMALL)
    path = tmp_path / "mjpeg-small.json"
    path.write_text(json.dumps(cfg))
    small = harness.make_cell(NAME, path, cell.traffic_name, cell.chips,
                              bench)
    t = dict(small.traffic, frames_per_dispatch=4, warmup_dispatches=2,
             sample_frames=16)
    return dataclasses.replace(small, traffic=t)


def test_every_cell_loads_by_name():
    cells = {w["name"]: harness.load_cell(w["name"])
             for w in harness.load_manifest()["workloads"]}
    assert {"decode-4k-tworow-q90", NAME} <= set(cells)
    cell = cells[NAME]
    assert {m["name"] for m in cell.per_layer} == METRICS | SHARED
    assert {m["name"] for m in cell.end_to_end} == {"mpix_s", "setup_s"}
    entry = cell.entry()
    assert (entry.QUALITY_OUT, entry.RESTART_INTERVAL_OUT) == (
        cell.config["quality_out"], cell.config["restart_interval_out"])
    assert cell.config["reference"] == "mjpeg_transcode"
    decode = {m["name"] for m in cells["decode-4k-tworow-q90"].per_layer}
    assert SHARED < decode and not METRICS & decode


def test_small_cell_runs_correct(tmp_path):
    cell = small_cell(tmp_path)
    result = run_tiny(cell)
    assert result["correct"], result["check"]
    check = result["check"]
    assert check["frames_differing"]["value"] == 0
    assert check["frames_missing"]["value"] == 0
    assert check["frames_compared"]["value"] >= 4
    assert set(result["metrics"]) == {"mpix_s", "setup_s"}


def test_traced_small_cell_reports_no_device_metric_off_the_card(tmp_path):
    """Off the card there is no device trace: neither the device readers
    nor the port-span readers (which read on the trace's clock) report."""
    result = run_tiny(small_cell(tmp_path), traced=True)
    assert result["correct"]
    assert not (METRICS | SHARED - {"p95_frame_ms"}) & set(result["metrics"])


def test_the_float32_control_reads_frames_differing(tmp_path):
    out = control_mod.control(small_cell(tmp_path), 2**36 + 11)
    assert not out["correct"]
    assert out["check"]["frames_differing"]["value"] > 0


def test_a_dropped_frame_reads_frames_missing(tmp_path):
    """The last frame of every dispatch left out."""
    def tamper(runner):
        inner = runner.session.transcode_batch

        def step(entropy_list):
            return inner(entropy_list)[:-1]
        runner.session.transcode_batch = step

    result = run_tiny(small_cell(tmp_path), tamper=tamper)
    assert not result["correct"]
    assert result["check"]["frames_missing"]["value"] > 0


def test_work_counts_match_a_hand_count():
    """A 16x16 4:2:0 frame is one MCU of 6 blocks and one segment. Its
    output codes a DC and an EOB in each block and two AC values in the
    first: 14 symbols; its entropy bytes are the body between the header
    and the EOI (no 0xFF to stuff, no RSTn)."""
    ref = harness.load_module(harness.ROOT / "portbench" / "reference"
                              / "baseline_jpeg.py", "baseline_jpeg")
    layout = ref.Layout(16, 16)
    coefs = np.zeros((6, 64), np.int64)
    coefs[:, 0] = [3, -2, 1, 0, 5, -1]
    coefs[0, 1], coefs[0, 5] = 4, -1
    out = ref.encode_coefs(coefs, layout, 75, 1)
    body = out.stream[out.header_len:-2]
    assert out.symbols == 6 + 6 + 2 and b"\xff" not in body
    assert work_encode.huffman_encode(out, layout) == (
        6 * 64 * 4 + len(body), 30.0 * 14)
    assert work_encode.encode_datapath(layout) == (6 * 64 * 5, 1100.0 * 6)
