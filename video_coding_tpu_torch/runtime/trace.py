"""Tracing and observability.

- ``pipeline_trace``: the decode datapath with every intermediate stage
  kept (dequant, row pass, column pass, clip, recon) — a per-stage tensor
  dump of what K2 computes, for tests and logs;
- ``profile``: a context manager around ``torch.profiler`` that writes a
  Chrome trace (``chrome://tracing``, Perfetto, TensorBoard's profiler
  plugin) into a directory, with the program's spans on the trace's
  clock;
- the span recorder: ``span`` / ``attrs`` at each layer boundary of the
  sessions and the pipeline, ``carry`` / ``queued`` for work handed to
  another thread, and ``start`` / ``stop`` / ``recording`` around a
  region.

The recorder is off unless ``start`` (or ``profile``) turned it on. Off,
``span`` is one check of a module flag and returns a shared no-op: it
reads no clock, keeps nothing and takes no lock. On, a span records its
name, its start and end on ``time.perf_counter_ns`` (CLOCK_MONOTONIC), the
native id of its thread, its own id, the id of the span that caused it
(the thread's open span, or the one a handed-over task carries), the id
of its dispatch (shared by every span of one unit of work) and its
attributes (integers and short strings). ``torch.profiler`` drops ranges
opened on worker threads, where the sessions do their host work, so the
spans are the program's own; ``profile`` moves them onto the profiler's
clock through one anchor range.

The JAX package's ``xla_dump_flags`` has no counterpart: there is no XLA
here to dump.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..model.zigzag import FORWARD
from ..ops.chen import _idct_pass
from ..ops.datapath import COEF_MAX, COEF_MIN

CAP = 1 << 20               # spans a recording keeps; the rest are counted
ANCHOR = "vct.trace.anchor"


@dataclasses.dataclass
class DecodeTrace:
    """Every intermediate array of the decode datapath for a batch of
    blocks."""

    coefs_zigzag: np.ndarray   # (N, 64) input
    dequant_zigzag: np.ndarray
    dequant_natural: np.ndarray
    after_row_pass: np.ndarray  # (N, 8, 8)
    after_col_pass: np.ndarray
    clipped: np.ndarray
    recon: np.ndarray          # (N, 8, 8) final pixels


def pipeline_trace(coefs, quant, device=None) -> DecodeTrace:
    """Stage-by-stage decode datapath of (N, 64) zigzag coefficients and
    (N, 64) or (64,) zigzag quant values (bit-exact with K2 and its plain
    version; the row and column passes are ``ops/chen.py``'s), run on
    ``device`` (None: the card) and returned as host arrays."""
    dev = resolve_device(device)
    coefs = np.asarray(coefs, dtype=np.int32)
    quant = torch.as_tensor(np.asarray(quant, dtype=np.int32), device=dev)
    deq_zz = (torch.as_tensor(coefs, device=dev).to(torch.int64) * quant) \
        .clamp(COEF_MIN, COEF_MAX).to(torch.int32)
    nat = deq_zz[:, torch.as_tensor(np.asarray(FORWARD), device=dev)] \
        .reshape(-1, 8, 8)
    rows = torch.stack(_idct_pass([nat[..., c] for c in range(8)], True),
                       dim=-1)
    cols = torch.stack(_idct_pass([rows[..., r, :] for r in range(8)],
                                  False), dim=-2)
    clipped = cols.clamp(-128, 127)
    return DecodeTrace(
        coefs_zigzag=coefs,
        dequant_zigzag=deq_zz.cpu().numpy(),
        dequant_natural=nat.cpu().numpy(),
        after_row_pass=rows.cpu().numpy(),
        after_col_pass=cols.cpu().numpy(),
        clipped=clipped.cpu().numpy(),
        recon=(clipped + 128).cpu().numpy(),
    )


# -- the span recorder ---------------------------------------------------------

class Span(NamedTuple):
    """One recorded span; times in ``perf_counter_ns`` nanoseconds."""

    name: str
    start_ns: int
    end_ns: int
    tid: int                  # native thread id
    id: int
    parent: int | None        # the span that caused it
    dispatch: int             # shared by every span of one dispatch
    attrs: dict


@dataclasses.dataclass
class Recording:
    """What a recording kept, and how many spans past ``CAP`` it
    counted without keeping."""

    spans: list = dataclasses.field(default_factory=list)
    dropped: int = 0


class _Context(NamedTuple):
    """A parent handed to another thread: its span id and dispatch."""

    id: int | None
    dispatch: int
    attrs: None = None        # ``attrs`` adds nothing to a handed context


class _Thread:
    """A thread's open spans and adopted contexts, and its native id."""

    __slots__ = ("stack", "tid")

    def __init__(self):
        self.stack: list = []
        self.tid = threading.get_native_id()


class _Recorder:
    def __init__(self, cap: int):
        self.cap = cap
        self.spans: list[tuple] = []      # Span fields, made Spans at close
        self.dropped = 0
        self.closed = False
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.dispatches = itertools.count(1)
        self.local = threading.local()

    def thread(self) -> _Thread:
        try:
            return self.local.thread
        except AttributeError:
            self.local.thread = _Thread()
            return self.local.thread

    def stack(self) -> list:
        """The calling thread's open spans and adopted contexts."""
        return self.thread().stack

    def context(self) -> _Context:
        """The calling thread's open span, as a parent for other
        threads (a new dispatch when none is open)."""
        st = self.stack()
        if st:
            return _Context(st[-1].id, st[-1].dispatch)
        return _Context(None, next(self.dispatches))

    def add(self, fields: tuple) -> None:
        with self.lock:
            if self.closed:
                return
            if len(self.spans) < self.cap:
                self.spans.append(fields)
            else:
                self.dropped += 1

    def close(self) -> Recording:
        with self.lock:
            self.closed = True
            out = Recording([Span._make(f) for f in self.spans],
                            self.dropped)
            self.spans, self.dropped = [], 0
        return out


class _Span:
    __slots__ = ("rec", "name", "attrs", "id", "parent", "dispatch", "t0",
                 "thread")

    def __init__(self, rec: _Recorder, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        rec = self.rec
        self.thread = th = rec.thread()
        st = th.stack
        if st:
            self.parent, self.dispatch = st[-1].id, st[-1].dispatch
        else:
            self.parent, self.dispatch = None, next(rec.dispatches)
        self.id = next(rec.ids)
        st.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        th = self.thread
        if th.stack[-1] is self:
            th.stack.pop()
        else:
            th.stack.remove(self)
        self.rec.add((self.name, self.t0, t1, th.tid, self.id, self.parent,
                      self.dispatch, self.attrs))
        return False


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _Noop()
_recorder: _Recorder | None = None     # the flag: None while off
_control = threading.Lock()


def span(name: str, **attrs):
    """A context manager recording ``name`` with ``attrs`` while the
    recorder is on; the shared no-op while it is off."""
    rec = _recorder
    if rec is None:
        return _NOOP
    return _Span(rec, name, attrs)


def attrs(**kv) -> None:
    """Add counts to the calling thread's open span (while recording)."""
    rec = _recorder
    if rec is None:
        return
    st = rec.stack()
    if st and st[-1].attrs is not None:
        st[-1].attrs.update(kv)


@contextlib.contextmanager
def _adopted(rec: _Recorder, ctx: _Context):
    st = rec.stack()
    st.append(ctx)
    try:
        yield
    finally:
        st.remove(ctx)


def carry(fn):
    """``fn`` bound to the calling thread's open span, for another
    thread to run: the spans it opens there are that span's children, in
    its dispatch. Off, ``fn`` itself."""
    rec = _recorder
    if rec is None:
        return fn
    ctx = rec.context()

    def carried(*a, **k):
        with _adopted(rec, ctx):
            return fn(*a, **k)
    return carried


def queued(name: str, fn, **kv):
    """``fn`` for a worker to run, with a span ``name`` (attributes
    ``kv``) from now, on the calling thread, to the moment a worker
    starts it: a new dispatch, whose spans on the worker are the wait's
    children. Off, ``fn`` itself."""
    rec = _recorder
    if rec is None:
        return fn
    st = rec.stack()
    parent = st[-1].id if st else None
    ctx = _Context(next(rec.ids), next(rec.dispatches))
    tid, t0 = threading.get_native_id(), time.perf_counter_ns()

    def run(*a, **k):
        rec.add((name, t0, time.perf_counter_ns(), tid, ctx.id, parent,
                 ctx.dispatch, kv))
        with _adopted(rec, ctx):
            return fn(*a, **k)
    return run


def start() -> None:
    """Turn the recorder on, with an empty buffer of ``CAP`` spans."""
    global _recorder
    with _control:
        if _recorder is not None:
            raise RuntimeError("the span recorder is already on")
        _recorder = _Recorder(CAP)


def stop() -> Recording:
    """Turn the recorder off and hand out what it recorded (spans still
    open are left out)."""
    global _recorder
    with _control:
        rec, _recorder = _recorder, None
    if rec is None:
        raise RuntimeError("the span recorder is not on")
    return rec.close()


@contextlib.contextmanager
def recording():
    """Record the spans of a region; the yielded ``Recording`` is filled
    when the region ends."""
    out = Recording()
    start()
    try:
        yield out
    finally:
        done = stop()
        out.spans, out.dropped = done.spans, done.dropped


def _chrome_events(spans: list, offset_us: float, pid: int) -> list:
    """The spans as Chrome trace events on a clock ``offset_us`` ahead of
    ``perf_counter_ns`` (in microseconds), on their own threads."""
    return [{"ph": "X", "cat": "vct.span", "name": s.name, "pid": pid,
             "tid": s.tid, "ts": s.start_ns / 1e3 + offset_us,
             "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"id": s.id, "parent": s.parent,
                      "dispatch": s.dispatch, **s.attrs}}
            for s in spans]


@contextlib.contextmanager
def profile(log_dir: str):
    """Profile a region with ``torch.profiler`` (the host, and the card
    when there is one) and the span recorder, and write one Chrome trace
    into ``log_dir``: the profiler's events and the program's spans, moved
    onto the profiler's clock through the range ``ANCHOR`` opened at a
    known ``perf_counter_ns``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        with recording() as rec:
            # the thread's first range pays the profiler's set-up inside
            # its timestamps: the second is the one read
            for _ in range(2):
                anchor_ns = time.perf_counter_ns()
                with record_function(ANCHOR):
                    pass
            yield prof
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    anchor = [e for e in events if e.get("name") == ANCHOR
              and e.get("ph") == "X"]
    if not anchor:
        raise RuntimeError("the profiler's trace has no anchor range")
    last = max(anchor, key=lambda e: e["ts"])
    events.extend(_chrome_events(rec.spans, last["ts"] - anchor_ns / 1e3,
                                last.get("pid", os.getpid())))
    with open(path, "w") as f:
        json.dump(trace, f)
