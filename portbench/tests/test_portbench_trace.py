"""The reduction from work counts and traces to metrics, on hand-computed
cases: the roofline arithmetic, the device timeline's union and gaps,
what the host was doing in a gap, and the readers."""

from __future__ import annotations

import dataclasses

import pytest

from portbench import harness, work
from portbench.trace import TraceView, base_name, covered

PEAKS = {"hbm_bytes_per_s": 1e12, "int32_ops_per_s": 1e12}


def test_least_time_and_roofline():
    assert work.least_s(3e6, 1e6, PEAKS) == pytest.approx(3e-6)
    assert work.least_s(1e6, 2e6, PEAKS) == pytest.approx(2e-6)
    # 10 frames of 2 us each against 100 us of kernels: 20%
    assert work.roofline_pct([(1e6, 2e6)], 10, 1e-4, PEAKS) == \
        pytest.approx(20.0)
    # two kernels: their least times add
    assert work.roofline_pct([(1e6, 2e6), (3e6, 0)], 10, 1e-4, PEAKS) == \
        pytest.approx(50.0)
    assert work.roofline_pct([(1, 1)], 0, 1.0, PEAKS) is None
    assert work.roofline_pct([(1, 1)], 1, 1.0, None) is None


def test_stage_work_counts():
    layout = dataclasses.make_dataclass("L", ["n_blocks"])(100)
    enc = dataclasses.make_dataclass(
        "E", ["raw_bytes", "symbols", "stream", "header_len"])(
        500, 40, b"x" * 620, 18)
    src = dataclasses.make_dataclass("S", ["encoded"])(enc)
    assert work.huffman_decode(src, layout) == (500 + 100 * 256, 1600.0)
    assert work.decode_datapath(layout) == (100 * 64 * 5, 120000.0)


def _events():
    def ev(cat, name, ts, dur, corr=None, tid=0):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
             "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    return [
        ev("user_annotation", "portbench.window", 1000.0, 5000.0, tid=1),
        ev("kernel", "huffman_decode_kernel(unsigned char const*, int)",
           1200.0, 100.0, 7),
        ev("kernel", "lut_level1_kernel", 1250.0, 100.0, 8),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 2000.0, 50.0,
           9),
        ev("kernel", "decode_datapath_kernel", 7000.0, 10.0, 10),
    ]


SPANS = [("dispatch", 42, 0.0013, 0.0019),
         ("host_entropy.destuff", 43, 0.0014, 0.0016)]


def test_trace_view_window_union_and_gaps():
    view = TraceView(_events(), 0.001, (0.001, 0.006), SPANS)
    assert view.window_s == pytest.approx(0.005)
    assert len(view.device) == 3                  # the last is outside
    assert view.busy_s() == pytest.approx(200e-6)
    assert [g for g in view.gaps()] == [(2050.0, 6000.0), (1350.0, 2000.0),
                                        (1000.0, 1200.0)]
    assert [k[0] for k in view.kernels({"huffman_decode_kernel"})] == [
        "huffman_decode_kernel(unsigned char const*, int)"]
    assert sum(e - s for _n, s, e, _c, _k in view.copies()) == 50.0
    # a dispatch's own time, net of the destuff inside it, covers most
    assert view.host_during(1350.0, 2000.0) == "dispatch"
    assert view.host_during(5000.0, 6000.0) == "outside spans"
    b = view.breakdown()
    assert b["device_ops"][0] == ["huffman_decode_kernel", 100e-6]
    assert b["idle_gaps"][0] == ["outside spans", pytest.approx(3950e-6)]


def test_covered_and_names():
    assert covered([(0, 2), (1, 3), (5, 6)], 0.5, 5.5) == pytest.approx(3.0)
    assert base_name("ns::foo_kernel(int, float)") == "foo_kernel"
    assert base_name("(anonymous namespace)::huffman_decode_kernel("
                     "unsigned char const*, long long)") == \
        "huffman_decode_kernel"
    assert base_name("void at::native::(anonymous namespace)::"
                     "vectorized_gather_kernel<16, long>(char*, char*)") == \
        "vectorized_gather_kernel"
    assert base_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"


def test_device_readers_on_a_synthetic_trace():
    cell = harness.load_cell("decode-4k-tworow-q90")
    layout = cell.reference().Layout(1920, 1080)
    feed = harness.Feed([b""], 16)
    run = harness.Run(cell, 1, 5.0, layout, [], feed, [], 1.0)
    run.trace = TraceView(_events(), 0.001, (0.001, 0.006), SPANS)
    idle = harness.metric_reader(harness.ROOT, "device.idle_pct").read(run)
    assert idle == pytest.approx(96.0)
    host = harness.metric_reader(harness.ROOT,
                                 "host_entropy.ms_per_frame").read(run)
    assert host == pytest.approx(0.2)
    # no decode-datapath launch in the window: no frames to divide by
    assert harness.metric_reader(
        harness.ROOT, "transfer.copy_ms_per_frame").read(run) is None
    for name in ("huffman_decode.roofline_pct", "datapath.roofline_pct"):
        assert harness.metric_reader(harness.ROOT, name).read(run) is None


def test_memory_peak_is_net_of_the_sample(monkeypatch):
    """The reservoir tells the peak tracker its holding before and after
    every change: each stretch's peak less that holding is the program's."""
    import types

    alloc = {"peak": 0}
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        max_memory_allocated=lambda: alloc["peak"],
        reset_peak_memory_stats=lambda: None))
    monkeypatch.setitem(__import__("sys").modules, "torch", fake)
    monkeypatch.setattr(harness, "device_bytes", lambda unit: unit)
    net = harness.PeakNet(cuda=True)
    res = harness.Reservoir(2, seed=5, net=net)
    alloc["peak"] = 100                      # the program alone
    res.offer((0, 30))
    alloc["peak"] = 100 + 30                 # the program's 100 beside it
    res.offer((1, 30))
    alloc["peak"] = 100 + 60
    for i in range(2, 40):
        res.offer((i, 30))
    net.close()
    assert res.held == 60
    assert net.peak == 100
