"""The port's own spans in a traced run, for the readers that read them.

The port records spans at the layer boundaries of its decode path and
pipeline (``video_coding_tpu_torch.runtime.trace``: name, start and end on
``perf_counter_ns``, native thread id, id, parent id, dispatch id and
counts), off unless started. The harness reads each per-layer reader's
``SPANS`` once, when it sets up a traced run and before the profiler
starts, and in no other run: the readers of the port's spans give it
``RECORDER``, which starts the port's recorder there and asks for no
wrapper. The first reader to read stops it. A port without a recorder
gives no spans, and the readers return None.

The spans are moved onto the device trace's clock with the offset the
harness's window anchor gives (``TraceView.offset_us``): ``perf_counter``
and ``perf_counter_ns`` are one clock.
"""

from __future__ import annotations

import importlib
from typing import NamedTuple

WAITS = ("pipeline.",)      # a wait for a worker holds no host code


class ProgramSpan(NamedTuple):
    """A port span on the trace's clock (microseconds)."""

    name: str
    tid: int
    start: float
    end: float
    id: int
    parent: int | None
    dispatch: int
    attrs: dict


def port_trace():
    """The port's trace module, if it has the span recorder."""
    try:
        mod = importlib.import_module(
            "video_coding_tpu_torch.runtime.trace")
    except ImportError:
        return None
    return mod if hasattr(mod, "start") and hasattr(mod, "stop") else None


class Recorder:
    """Iterated as a reader's ``SPANS``: starts the port's recorder (once
    a run) and patches nothing. ``take`` stops it and keeps what it
    recorded until the next start."""

    def __init__(self):
        self.trace = None
        self.taken: list = []

    def __iter__(self):
        if self.trace is None:
            self.trace = port_trace()
            if self.trace is not None:
                self.taken = []
                self.trace.start()
        return iter(())

    def take(self) -> list:
        if self.trace is not None:
            self.taken = self.trace.stop().spans
            self.trace = None
        return self.taken


RECORDER = Recorder()


def spans(run) -> list:
    """Every port span of the run on the trace's clock, by start; [] off
    the card (no trace) or without a recorder."""
    raw = RECORDER.take()
    if run.trace is None:
        return []
    off = run.trace.offset_us
    return sorted((ProgramSpan(s.name, s.tid, s.start_ns / 1e3 + off,
                               s.end_ns / 1e3 + off, s.id, s.parent,
                               s.dispatch, s.attrs) for s in raw),
                  key=lambda s: s.start)


def window(run, *names) -> list:
    """The port spans named ``names`` that start in the window."""
    return [s for s in spans(run)
            if s.name in names and run.trace.w0 <= s.start < run.trace.w1]


def total_ms(items) -> float:
    return sum(s.end - s.start for s in items) / 1e3


def union(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def overlap(a: list, b: list) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def self_time(span: ProgramSpan, children: list, lo: float,
              hi: float) -> float:
    """The span's time in [lo, hi] net of its children's, on any
    thread."""
    lo, hi = max(lo, span.start), min(hi, span.end)
    if hi <= lo:
        return 0.0
    kids = union((max(c.start, lo), min(c.end, hi)) for c in children)
    return (hi - lo) - overlap(kids, [[lo, hi]])


def host_during(items: list, lo: float, hi: float) -> str | None:
    """The name of the port span with the most self time over [lo, hi],
    on any thread; a wait for a worker only where no other span was open.
    None where no span was open."""
    kids: dict = {}
    for s in items:
        kids.setdefault(s.parent, []).append(s)
    by_name: dict = {}
    for s in items:
        if s.end > lo and s.start < hi:
            t = self_time(s, kids.get(s.id, []), lo, hi)
            by_name[s.name] = by_name.get(s.name, 0.0) + t
    work = {n: t for n, t in by_name.items() if not n.startswith(WAITS)}
    pick = work if any(t > 0 for t in work.values()) else by_name
    best = max(pick.items(), key=lambda kv: kv[1], default=(None, 0.0))
    return best[0] if best[1] > 0 else None


def idle_gaps(run, n: int = 10) -> list:
    """[name, seconds] of the window's ``n`` longest idle gaps, each put
    down to the port span with the most self time over it ("outside
    spans" where none was open)."""
    items = spans(run)
    return [[host_during(items, lo, hi) or "outside spans", (hi - lo) / 1e6]
            for lo, hi in run.trace.gaps()[:n]]
