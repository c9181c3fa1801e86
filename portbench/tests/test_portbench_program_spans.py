"""The readers of the port's own spans, and the idle gaps put down to
them, on hand-built traces: each reader's arithmetic, None where the port
recorded nothing (a port without the recorder), the self-time
attribution, and a traced tiny run on the CPU that starts and stops the
port's recorder."""

from __future__ import annotations

import pytest

from portbench import harness, program
from portbench.tests.helpers import run_tiny, tiny_cell
from portbench.trace import TraceView
from video_coding_tpu_torch.runtime import trace as port_trace

READERS = ("pipeline.queue_ms_per_dispatch",
           "host_entropy.program_ms_per_frame", "lane_prep.ms_per_dispatch",
           "transfer.upload_host_ms_per_frame", "launch.host_ms_per_dispatch",
           "huffman_decode.lane_fill_pct", "device.idle_unexplained_pct")
ANCHOR_S = 0.001      # the window anchor at trace time 1000 us


def _events():
    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "tid": 0}

    # busy 1000-1100 and 1600-1700; idle 1100-1600 and 1700-2000
    return [ev("user_annotation", "portbench.window", 1000.0, 1000.0),
            ev("kernel", "huffman_decode_padded_kernel", 1000.0, 100.0),
            ev("kernel", "decode_datapath_kernel", 1600.0, 100.0)]


def _span(name, t0_us, t1_us, sid, parent=None, tid=1, **attrs):
    """A port span whose trace-clock times are ``t0_us``, ``t1_us``."""
    return port_trace.Span(name, int(t0_us * 1e3), int(t1_us * 1e3), tid,
                           sid, parent, 1, attrs)


def _spans():
    return [
        _span("pipeline.queue", 1050, 1100, 1, dispatch=0),
        _span("decode.dispatch", 1100, 1900, 2, 1, tid=2, frames=4,
              bytes_in=400),
        _span("decode.destuff_pool", 1100, 1200, 3, 2, tid=2, frames=4),
        _span("decode.destuff", 1110, 1190, 4, 3, tid=3, bytes_in=100,
              segments=2),
        _span("decode.destuff", 1120, 1180, 5, 3, tid=4, bytes_in=100,
              segments=2),
        _span("decode.lane_prep", 1200, 1250, 6, 2, tid=2, lanes=4,
              lane_len=64, lane_bytes=192),
        _span("upload", 1250, 1550, 7, 2, tid=2, bytes=4096),
        _span("decode.launch", 1550, 1600, 8, 2, tid=2, stage="huffman",
              route="pallas"),
        _span("decode.launch", 1700, 1720, 9, 2, tid=2, stage="tail"),
        _span("pipeline.queue", 2500, 2600, 10, dispatch=1),  # past it
    ]


def _run(spans):
    cell = harness.load_cell("decode-4k-tworow-q90")
    layout = cell.reference().Layout(1920, 1080)
    run = harness.Run(cell, 1, 1.0, layout, [], harness.Feed([b""], 4), [],
                      1.0)
    run.trace = TraceView(_events(), ANCHOR_S, (0.001, 0.002), [])
    program.RECORDER.trace, program.RECORDER.taken = None, spans
    return run


def _read(name, run):
    return harness.metric_reader(harness.ROOT, name).read(run)


def test_readers_on_a_hand_built_trace():
    run = _run(_spans())
    assert _read("pipeline.queue_ms_per_dispatch", run) == \
        pytest.approx(0.05)
    assert _read("host_entropy.program_ms_per_frame", run) == \
        pytest.approx(0.07)                       # (80 + 60) us / 2 frames
    assert _read("lane_prep.ms_per_dispatch", run) == pytest.approx(0.05)
    assert _read("transfer.upload_host_ms_per_frame", run) == \
        pytest.approx(0.3 / 4)
    assert _read("launch.host_ms_per_dispatch", run) == pytest.approx(0.07)
    assert _read("huffman_decode.lane_fill_pct", run) == pytest.approx(75.0)
    # idle 800 us; the spans' union covers 1100-1900 of it: 100 us is not
    assert _read("device.idle_unexplained_pct", run) == \
        pytest.approx(12.5)


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_port_spans(name):
    """A port without the recorder, as before it had one: every reader
    returns None and none raises."""
    assert _read(name, _run([])) is None
    run = _run(_spans())
    run.trace = None                              # a traced run off the card
    assert _read(name, run) is None


def test_a_gap_goes_to_the_span_with_most_self_time():
    """The upload under the dispatch holds most of the 1100-1600 gap: the
    gap reads ``upload``, not ``decode.dispatch``, and the destuffs on
    the pool's threads take their parent's time; the queue, a wait, takes
    a gap only where nothing else was open."""
    items = program.spans(_run(_spans()))
    assert program.host_during(items, 1100, 1600) == "upload"
    assert program.host_during(items, 1110, 1190) == "decode.destuff"
    assert program.host_during(items, 1720, 1900) == "decode.dispatch"
    assert program.host_during(items, 1050, 1100) == "pipeline.queue"
    assert program.host_during(items, 2000, 2400) is None
    dispatch = [s for s in items if s.name == "decode.dispatch"][0]
    kids = [s for s in items if s.parent == dispatch.id]
    # 1100-1900 less destuff pool, prep, upload and launches (520 us)
    assert program.self_time(dispatch, kids, 0, 1e9) == pytest.approx(280)
    run = _run(_spans())
    assert program.idle_gaps(run) == [["upload", pytest.approx(500e-6)],
                                      ["decode.dispatch",
                                       pytest.approx(300e-6)]]


def test_union_and_overlap():
    assert program.union([(5, 6), (0, 2), (1, 3), (4, 4)]) == [[0, 3],
                                                               [5, 6]]
    assert program.overlap([[0, 3], [5, 6]], [[2, 5.5]]) == \
        pytest.approx(1.5)
    assert program.overlap([], [[0, 1]]) == 0.0


def test_traced_tiny_run_starts_and_stops_the_port_recorder():
    """Off the card a traced run has no device trace: the readers of the
    port's spans report nothing, and the recorder they started is off
    again when the run ends."""
    cell = tiny_cell("decode-4k-tworow-q90")
    result = run_tiny(cell, traced=True)
    assert result["correct"]
    assert not set(READERS) & set(result["metrics"])
    assert program.RECORDER.trace is None
    assert program.RECORDER.taken                 # the port recorded
    assert {"decode.dispatch", "pipeline.queue", "upload"} <= {
        s.name for s in program.RECORDER.taken}
    with port_trace.recording():                  # the recorder is off
        pass
