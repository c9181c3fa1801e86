"""The traced run: host spans the benchmark records around the port's
calls, the device timeline from ``torch.profiler``, and the two on one
clock.

The profiler records host-side ranges of the thread that starts it only,
and the port works on worker threads, so host spans are taken here with
``time.perf_counter`` and the thread's native id. One ``record_function``
range on the main thread, opened when the window opens, ties the two
clocks.
"""

from __future__ import annotations

import importlib
import json
import os
import re
import threading
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ANCHOR = "portbench.window"


class Spans:
    """Host spans: (name, native thread id, start s, end s)."""

    def __init__(self):
        self.items: list[tuple] = []
        self._undo: list[tuple] = []

    def wrap(self, fn, name: str):
        items = self.items

        def spanned(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                items.append((name, threading.get_native_id(), t0,
                              time.perf_counter()))
        return spanned

    def patch(self, obj, attr: str, name: str) -> None:
        """Record a span around every call of ``obj.attr`` (``obj`` a
        module path or an object) until ``restore``."""
        if isinstance(obj, str):
            obj = importlib.import_module(obj)
        old = getattr(obj, attr)
        self._undo.append((obj, attr, old))
        setattr(obj, attr, self.wrap(old, name))

    def restore(self) -> None:
        for obj, attr, old in reversed(self._undo):
            setattr(obj, attr, old)
        self._undo.clear()


def base_name(name: str) -> str:
    """A kernel's or copy's name without its return type, namespaces,
    template arguments or argument list."""
    s = name.replace("(anonymous namespace)::", "")
    s = re.sub(r"^void ", "", s)
    return re.split(r"[<(]", s, maxsplit=1)[0].split("::")[-1].strip() \
        or name[:64]


def covered(intervals, lo: float, hi: float) -> float:
    """Length of [lo, hi] covered by the union of (start, end) intervals,
    sorted by start."""
    total, reach = 0.0, lo
    for s, e in intervals:
        s, e = max(s, reach), min(e, hi)
        if e > s:
            total += e - s
            reach = e
        if reach >= hi:
            break
    return total


class TraceView:
    """The window of a traced run on the trace's clock (microseconds).

    ``device``: (name, start, end, category, correlation) of every kernel,
    copy and memset that started in the window; ``spans``: the host spans
    moved onto the trace's clock."""

    def __init__(self, events: list, anchor_s: float, window_s: tuple,
                 spans: list):
        anchor = [e for e in events if e.get("name") == ANCHOR
                  and e.get("ph") == "X"]
        if not anchor:
            raise RuntimeError("the trace has no window anchor")
        self.offset_us = float(anchor[0]["ts"]) - anchor_s * 1e6
        self.w0, self.w1 = (t * 1e6 + self.offset_us for t in window_s)
        self.device = []
        for e in events:
            cat, args = e.get("cat"), e.get("args") or {}
            if cat in DEVICE_CATS and self.w0 <= e["ts"] < self.w1:
                self.device.append((e["name"], float(e["ts"]),
                                    float(e["ts"]) + float(e.get("dur", 0)),
                                    cat, args.get("correlation")))
        self.device.sort(key=lambda d: d[1])
        self.spans = sorted(((n, tid, t0 * 1e6 + self.offset_us,
                              t1 * 1e6 + self.offset_us)
                             for n, tid, t0, t1 in spans), key=lambda s: s[2])

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e6

    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the card."""
        return covered([(s, e) for _n, s, e, _c, _k in self.device],
                       self.w0, self.w1) / 1e6

    def kernels(self, names) -> list:
        return [d for d in self.device
                if d[3] == "kernel" and base_name(d[0]) in names]

    def copies(self) -> list:
        return [d for d in self.device if d[3] == "gpu_memcpy"]

    def spans_named(self, prefix: str, in_window: bool = True) -> list:
        return [s for s in self.spans if s[0].startswith(prefix)
                and (not in_window or self.w0 <= s[2] < self.w1)]

    def gaps(self) -> list:
        """(start, end) of every idle stretch of the window, longest
        first."""
        out, reach = [], self.w0
        for _n, s, e, _c, _k in self.device:
            if s > reach:
                out.append((reach, s))
            reach = max(reach, e)
        if reach < self.w1:
            out.append((reach, self.w1))
        return sorted(out, key=lambda g: g[0] - g[1])

    def host_during(self, lo: float, hi: float) -> str:
        """What the host was doing in [lo, hi]: the span name covering most
        of it, a dispatch's time net of the spans inside it."""
        by_name: dict = {}
        for n, _tid, s, e in self.spans:
            if e > lo and s < hi:
                by_name.setdefault(n, []).append((s, e))
        inner = sorted(iv for n, ivs in by_name.items() if n != "dispatch"
                       for iv in ivs)
        cover = {n: covered(sorted(ivs), lo, hi) for n, ivs in by_name.items()}
        if "dispatch" in cover:
            cover["dispatch"] = covered(
                sorted(by_name["dispatch"] + inner), lo, hi) - covered(
                    inner, lo, hi)
        best = max(cover.items(), key=lambda kv: kv[1], default=(None, 0.0))
        return best[0] if best[1] > 0 else "outside spans"

    def breakdown(self) -> dict:
        ops: dict = {}
        for n, s, e, _c, _k in self.device:
            key = base_name(n)
            ops[key] = ops.get(key, 0.0) + (e - s) / 1e6
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        gaps = [[self.host_during(lo, hi), (hi - lo) / 1e6]
                for lo, hi in self.gaps()[:10]]
        return {"device_ops": [[n, v] for n, v in top], "idle_gaps": gaps}


class Profiler:
    """torch.profiler over the run, started during set-up so that its own
    start-up is not in the window; ``anchor`` opens the range that ties the
    clocks."""

    def __init__(self, out_dir):
        import torch
        from torch.profiler import ProfilerActivity

        self.torch = torch
        self.out_dir = out_dir
        self.prof = torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.range = None
        self.anchor_s = None

    def start(self) -> None:
        self.prof.start()

    def anchor(self, t0: float) -> None:
        self.range = self.torch.profiler.record_function(ANCHOR)
        self.anchor_s = time.perf_counter()
        self.range.__enter__()

    def stop(self) -> list:
        """Stop, and return the trace's events."""
        if self.range is not None:
            self.range.__exit__(None, None, None)
        self.torch.cuda.synchronize()
        self.prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "trace.json")
        self.prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.remove(path)
