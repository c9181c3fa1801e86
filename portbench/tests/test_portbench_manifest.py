"""BENCHMARK.json and the files it names: every configuration, cell and
metric is found by name and meets the benchmark's contract; a new cell,
configuration and metric need only new files and entries."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import harness
from portbench.tests.helpers import run_tiny, tiny_cell

ROOT = harness.ROOT
BENCH = harness.load_manifest(ROOT)
LINE = re.compile(r"^[^\t\n]{1,200}$")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert (ROOT / p).is_dir() and ".." not in p
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(LINE.match(w) for w in cmd)
    for w in cmd:
        assert not w.startswith("/") and ".." not in w
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"])


def test_run_seconds_fits_the_check_with_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("portbench/")
        # a cut names a key of the file, of scale only: never a width
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg
            assert key not in ("width", "height", "factors", "qualities")
        names.add(c["name"])
    assert len(names) == len(BENCH["configs"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert LINE.match(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    every = [c["name"] for c in BENCH["configs"]] + [
        w["name"] for w in BENCH["workloads"]] + [m["name"] for m in metrics]
    assert len(set(every)) == len(every)
    for n in every + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                  "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        if m["name"].endswith("_roofline") or m["unit"] == "%":
            assert m["unit"] == "%"


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(name):
    cell = harness.load_cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert set(cell.traffic) <= harness.TRAFFIC_KEYS
    # every dispatch holds the same frames in another order
    assert cell.traffic["frames_per_dispatch"] % \
        cell.traffic["distinct_frames"] == 0
    for key in ("width", "height", "factors", "reference", "source"):
        assert key in cell.config
    assert hasattr(cell.entry(), "open") and hasattr(cell.entry(),
                                                      "expected")
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.metric_reader(ROOT, m["name"]).read)


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A configuration, a traffic mix and a metric added as files and
    manifest entries in a copy of the benchmark: the harness finds and
    runs them without an edit to any file that was there."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "portbench/configs/uhd-4k-420.json")
                     .read_text())
    cfg.update(width=256, height=128, factors=[[1, 1], [1, 1], [1, 1]])
    (tmp_path / "portbench/configs/tiny-444.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((ROOT / "portbench/workloads/"
                          "decode-4k-tworow-q90.json").read_text())
    traffic.update(restart_interval_in=4, warmup_dispatches=2,
                   sample_frames=8)
    (tmp_path / "portbench/workloads/decode-tiny-444.json").write_text(
        json.dumps(traffic))
    (tmp_path / "portbench/metrics/frames_done.py").write_text(
        "def read(run):\n    return float(len(run.done))\n")
    bench["configs"].append({"name": "tiny-444", "source": "a test",
                             "file": "portbench/configs/tiny-444.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "decode-tiny-444",
                               "config": "tiny-444",
                               "traffic": "decode-tiny-444", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "frames_done", "unit": "frames",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["decode-tiny-444"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("decode-tiny-444", tmp_path)
    assert cell.config["factors"] == [[1, 1], [1, 1], [1, 1]]
    result = run_tiny(cell)
    assert result["correct"], result["check"]
    assert result["metrics"]["frames_done"]["value"] > 0
    assert {"mpix_s", "setup_s"} <= set(result["metrics"])


def test_tiny_cell_keeps_its_rows_a_segment():
    cell = tiny_cell("decode-4k-tworow-q90")
    assert cell.traffic["restart_interval_in"] == 32


def test_a_quality_outside_its_configuration_is_refused(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    path = tmp_path / "portbench/workloads/decode-4k-tworow-q90.json"
    traffic = json.loads(path.read_text())
    path.write_text(json.dumps(dict(traffic, quality_in=95)))
    with pytest.raises(ValueError, match="quality 95"):
        harness.load_cell("decode-4k-tworow-q90", tmp_path)
