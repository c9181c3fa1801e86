"""The benchmark of the PyTorch/CUDA port, driven by data.

``BENCHMARK.json`` names every piece; each is found by its name:

- a configuration: ``portbench/configs/<name>.json`` (frame size and
  sampling, the qualities its source states, the source, the reference
  codec ``portbench/reference/<ref>.py``);
- a traffic mix: ``portbench/workloads/<traffic>.json`` (the entry point,
  the sources' quality, one of the configuration's, and restart interval,
  frames a dispatch, depth, distinct frames, warm-up and sample sizes),
  read by ``make_sources``;
- an entry point: ``portbench/entries/<entry>.py`` (``open`` builds the
  port's session and returns a runner);
- a metric: ``portbench/metrics/<metric>.py`` (``read(run)`` returns the
  value, or None when it finds nothing to read).

A run is a closed loop: the entry point's iterator pulls frame i (the
distinct source ``(i + i // batch) % distinct``, so consecutive dispatches
differ) from a ``Feed``, which stamps the pull. After the warm-up
dispatches the window opens for ``seconds``; the feed stops at the first
dispatch boundary after it closes and the frames pulled in the window
drain (at most ``DRAIN_S`` past the close). A seeded reservoir keeps a
sample of the window's outputs, which are held against the reference once
the window has closed and the program's state is freed.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import pathlib
import re
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
DRAIN_S = 60.0
TRAFFIC_KEYS = {"entry", "quality_in", "restart_interval_in",
                "frames_per_dispatch", "depth", "distinct_frames",
                "warmup_dispatches", "sample_frames", "why"}
FORBIDDEN = ("jax", "jaxlib", "flax", "video_coding_tpu")


def load_module(path: pathlib.Path, name: str):
    """Import a file of the benchmark by its path (once a path)."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    key = "portbench_file_" + re.sub(r"\W", "_", str(path.resolve()))
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


@dataclasses.dataclass
class Cell:
    name: str
    root: pathlib.Path
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    end_to_end: list      # manifest entries of the metrics this cell reports
    per_layer: list

    def reference(self):
        return load_module(self.root / "portbench" / "reference"
                           / f"{self.config['reference']}.py",
                           self.config["reference"])

    def entry(self):
        return load_module(self.root / "portbench" / "entries"
                           / f"{self.traffic['entry']}.py",
                           self.traffic["entry"])


def metric_reader(root: pathlib.Path, name: str):
    return load_module(root / "portbench" / "metrics" / f"{name}.py", name)


def load_manifest(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(workload: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``workload`` of the manifest, its configuration, traffic
    and metrics, each found by name and checked."""
    bench = load_manifest(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return make_cell(workload, root / cfg["file"], w["traffic"], w["chips"],
                     bench, root)


def make_cell(name: str, config_file: pathlib.Path, traffic: str,
              chips: int, bench: dict, root: pathlib.Path = ROOT) -> Cell:
    """A cell from its configuration file and traffic mix: the manifest's
    metrics that name it, or that name no cells."""
    config = json.loads(pathlib.Path(config_file).read_text())
    mix = json.loads((root / "portbench" / "workloads"
                      / f"{traffic}.json").read_text())
    unknown = set(mix) - TRAFFIC_KEYS
    if unknown:
        raise ValueError(f"traffic {traffic}: unknown keys {unknown}")
    if mix["quality_in"] not in config.get("qualities", [mix["quality_in"]]):
        raise ValueError(f"traffic {traffic}: quality {mix['quality_in']} "
                         f"is not one of its configuration's")

    def mine(m):
        return name in m.get("workloads", [name])

    cell = Cell(name, root, pathlib.Path(config_file).stem, config, traffic,
                mix, chips, [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])
    for m in cell.end_to_end + cell.per_layer:
        metric_reader(root, m["name"])
    cell.entry()
    cell.reference()
    return cell


# --- inputs -------------------------------------------------------------------

@dataclasses.dataclass
class Source:
    """One distinct frame: its planes, the stream the benchmark's encoder
    made of them and the entropy-coded payload the sessions take."""

    planes: tuple
    encoded: object           # reference.Encoded
    payload: bytes


def layout_of(ref, config: dict):
    return ref.Layout(config["width"], config["height"],
                      tuple(tuple(f) for f in config["factors"]))


def _preload(paths: list) -> None:
    """A worker's start: the benchmark's files that jobs refer to."""
    for path in paths:
        load_module(pathlib.Path(path), "")


@dataclasses.dataclass(frozen=True)
class ModuleFile:
    """Stands, in a worker's job, for the module of a benchmark file."""

    path: str


def _call(job):
    """Run ``fn(*args)`` of the benchmark file at ``path`` in a worker."""
    path, fn, args = job
    args = [load_module(pathlib.Path(a.path), "")
            if isinstance(a, ModuleFile) else a for a in args]
    return getattr(load_module(pathlib.Path(path), ""), fn)(*args)


def workers(cell: Cell):
    """Worker processes for the host-side NumPy work outside the window
    (the sources, the reference): spawned, at most one a core, up to the
    distinct frames."""
    import concurrent.futures
    import multiprocessing
    import os

    paths = [str(p) for p in (cell.root / "portbench" / "reference"
                              / f"{cell.config['reference']}.py",
                              cell.root / "portbench" / "entries"
                              / f"{cell.traffic['entry']}.py")]
    return concurrent.futures.ProcessPoolExecutor(
        max_workers=max(1, min(cell.traffic["distinct_frames"],
                               os.cpu_count() or 1, 8)),
        mp_context=multiprocessing.get_context("spawn"),
        initializer=_preload, initargs=(paths,))


def make_sources(cell: Cell, seed: int, pool):
    """(layout, sources) of the cell from the seed: ``distinct_frames``
    synthetic frames encoded by the benchmark's own encoder at the
    traffic's quality and restart interval, on ``pool``."""
    frames_mod = load_module(cell.root / "portbench" / "frames.py", "frames")
    ref = cell.reference()
    layout = layout_of(ref, cell.config)
    t = cell.traffic
    frames = frames_mod.synth_frames(t["distinct_frames"], seed,
                                     layout.width, layout.height,
                                     layout.actual(1))
    jobs = [(ref.__file__, "encode", (planes, layout, t["quality_in"],
                                      t["restart_interval_in"]))
            for planes in frames]
    return layout, [Source(planes, enc, enc.stream[enc.header_len:])
                    for planes, enc in zip(frames, pool.map(_call, jobs))]


def reference_outputs(cell: Cell, layout, sources: list, pool,
                      dct: str = "chen") -> list:
    """The reference's output of each source for the cell's entry point."""
    ref = ModuleFile(cell.reference().__file__)
    jobs = [(cell.entry().__file__, "expected",
             (ref, layout, s, cell.traffic, dct)) for s in sources]
    return list(pool.map(_call, jobs))


class Feed:
    """The closed loop's frames, iterated as a generator of payloads;
    every frame's pull is stamped. Iteration ends at the first dispatch
    boundary after the window closes."""

    def __init__(self, payloads: list, batch: int, clock=time.perf_counter):
        self.payloads = payloads
        self.batch = batch
        self.clock = clock
        self.pulled: list[float] = []
        self.t_open = self.t_close = None

    def source_of(self, i: int) -> int:
        return (i + i // self.batch) % len(self.payloads)

    def open(self, t0: float, seconds: float) -> None:
        self.t_open, self.t_close = t0, t0 + seconds

    def closed(self) -> bool:
        return self.t_close is not None and self.clock() >= self.t_close

    def __iter__(self):
        i = 0
        while not (i % self.batch == 0 and self.closed()):
            self.pulled.append(self.clock())
            yield self.payloads[self.source_of(i)]
            i += 1

    def in_window(self, i: int) -> bool:
        """Frame i belongs to the window: its dispatch's first pull came
        while the window was open."""
        t = self.pulled[i - i % self.batch]
        return self.t_open <= t < self.t_close


def device_bytes(unit) -> int:
    """Bytes of the card's memory that the tensors of an output unit (a
    tensor, or tuples and lists of them) keep alive."""
    seen: dict = {}
    stack = [unit]
    while stack:
        x = stack.pop()
        if isinstance(x, (tuple, list)):
            stack.extend(x)
        elif getattr(x, "is_cuda", False):
            st = x.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


class PeakNet:
    """The card's peak of allocated bytes net of what the reservoir holds:
    the check's sample is not the program's memory. Between two changes
    of the reservoir its holding is fixed, so each stretch's peak less
    that holding is the program's: ``close`` ends a stretch before a
    change, ``open`` starts the next after it."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.peak = 0
        self.held = 0

    def close(self) -> None:
        if self.cuda:
            import torch

            self.peak = max(self.peak,
                            torch.cuda.max_memory_allocated() - self.held)

    def open(self, held: int) -> None:
        if self.cuda:
            import torch

            torch.cuda.reset_peak_memory_stats()
        self.held = held


class Reservoir:
    """A seeded uniform sample of the window's output units. ``net``, if
    given, is told of every change of the card's bytes they keep."""

    def __init__(self, size: int, seed: int, net: PeakNet | None = None):
        self.size = size
        self.rng = np.random.default_rng([seed, 7])
        self.items: list = []
        self.sizes: list = []
        self.seen = 0
        self.net = net

    @property
    def held(self) -> int:
        return sum(self.sizes)

    def _put(self, j: int, item) -> None:
        if self.net is None:
            b = 0
        else:
            b = device_bytes(item[1])
            self.net.close()
        if j == len(self.items):
            self.items.append(item)
            self.sizes.append(b)
        else:
            self.items[j], self.sizes[j] = item, b
        if self.net is not None:
            self.net.open(self.held)

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self._put(len(self.items), item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.size:
                self._put(j, item)


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""

    cell: Cell
    seed: int
    seconds: float
    layout: object
    sources: list
    feed: Feed
    done: list                # completion time of each frame, in order
    setup_s: float
    expected: list = None     # the reference's output of each source
    trace: object = None      # trace.TraceView of a traced run
    peaks: dict = None

    @property
    def batch(self) -> int:
        return self.cell.traffic["frames_per_dispatch"]

    @property
    def pixels(self) -> int:
        return self.layout.width * self.layout.height

    def window_frames(self) -> list[int]:
        return [i for i in range(len(self.feed.pulled))
                if self.feed.in_window(i)]

    def latencies_s(self) -> np.ndarray:
        return np.array([self.done[i] - self.feed.pulled[i]
                         for i in self.window_frames() if i < len(self.done)])

    def completed_in_window(self) -> int:
        f = self.feed
        return sum(f.t_open <= t <= f.t_close for t in self.done)


def measure(runner, feed: Feed, seconds: float, warmup: int,
            reservoir: Reservoir, clock=time.perf_counter, on_open=None):
    """Drive the closed loop: ``warmup`` dispatches, then the window.
    Returns the completion time of each frame in order."""
    done: list[float] = []
    owed = None          # frames up to the window's last, once it has closed
    it = runner.stream(feed)
    try:
        for unit in it:
            runner.wait(unit)
            t = clock()
            first = len(done)
            done.extend([t] * runner.frames(unit))
            if feed.t_open is None:
                if len(done) >= warmup * feed.batch:
                    t0 = clock()
                    if on_open is not None:
                        on_open(t0)
                    feed.open(t0, seconds)
                continue
            if first < len(feed.pulled) and feed.in_window(first):
                reservoir.offer((first, unit))
            if feed.closed():
                if owed is None:
                    owed = 1 + max((i for i in range(len(feed.pulled))
                                    if feed.in_window(i)), default=-1)
                if len(done) >= owed or clock() > feed.t_close + DRAIN_S:
                    break
    finally:
        it.close()
    return done


def judge(same, run: Run, sample: list) -> dict:
    """Every sampled output (first frame, per-frame outputs on the host)
    against the reference's output of its source, and every frame of the
    window accounted for: {name: {value, limit}}."""
    differing = compared = 0
    for first, outs in sample:
        for j, got in enumerate(outs):
            want = run.expected[run.feed.source_of(first + j)]
            differing += not same(got, want)
            compared += 1
    missing = sum(1 for i in run.window_frames() if i >= len(run.done))
    return {"frames_differing": {"value": differing, "limit": 0},
            "frames_missing": {"value": missing, "limit": 0},
            "frames_compared": {"value": compared, "at_least": 1}}


def completion_probe(session, attr: str, events: dict) -> None:
    """Record a CUDA event after every call of ``session.attr`` (a
    dispatch), keyed by the id of what it returns. The events block: a
    waiter sleeps rather than spins, so the loop's wait takes no core from
    the program's host threads."""
    import torch

    if session.device.type != "cuda":
        return
    inner = getattr(session, attr)

    def dispatch(*a, **k):
        out = inner(*a, **k)
        ev = torch.cuda.Event(blocking=True)
        ev.record()
        events[id(out)] = ev
        return out
    setattr(session, attr, dispatch)


def check_passes(check: dict) -> bool:
    return all(("limit" not in c or c["value"] <= c["limit"])
               and ("at_least" not in c or c["value"] >= c["at_least"])
               for c in check.values())


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def read_metrics(entries: list, run: Run) -> dict:
    """{name: {value, unit}} of every metric whose reader finds a value."""
    out = {}
    for m in entries:
        v = metric_reader(run.cell.root, m["name"]).read(run)
        if v is not None:
            if not math.isfinite(v):
                raise ValueError(f"{m['name']} read {v}")
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def peaks_for(root: pathlib.Path, kind: str) -> dict | None:
    table = json.loads((root / "portbench" / "peaks.json").read_text())
    return table.get(kind)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def execute(cell: Cell, seed: int, seconds: float, traced: bool,
            t_start: float, device=None, tamper=None, log=_log) -> dict:
    """One run of the cell: sources from the seed, the port's session, the
    warm-up and the window, then the check against the reference and the
    metrics. Returns the result line. ``device="cpu"`` runs the port's
    plain versions (the tests); ``tamper(runner)`` may break the timed
    path underneath (the tests' planted faults). The worker processes of
    the host-side NumPy work live for the run and are stopped with it."""
    pool = workers(cell)
    try:
        return _execute(cell, seed, seconds, traced, t_start, device, tamper,
                        log, pool)
    finally:
        pool.shutdown(wait=True)


def _execute(cell, seed, seconds, traced, t_start, device, tamper, log,
             pool) -> dict:
    import gc

    import torch

    from portbench import trace as tr

    t = cell.traffic
    cuda = device is None or torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    layout, sources = make_sources(cell, seed, pool)
    log(f"sources: {len(sources)} distinct {layout.width}x{layout.height} "
        f"frames, q{t['quality_in']} ri={t['restart_interval_in']}, "
        f"{sum(len(s.payload) for s in sources) / len(sources):.0f} "
        f"entropy bytes a frame, {time.perf_counter() - t0:.2f} s")
    entry = cell.entry()
    t0 = time.perf_counter()
    runner = entry.open(cell, layout, sources, device)
    log(f"session: {time.perf_counter() - t0:.2f} s")
    if tamper is not None:
        tamper(runner)
    spans = profiler = None
    if traced:
        spans = tr.Spans()
        spans.patch(runner.session, runner.dispatch, "dispatch")
        for m in cell.per_layer:
            reader = metric_reader(cell.root, m["name"])
            for mod, attr, name in getattr(reader, "SPANS", ()):
                spans.patch(mod, attr, name)
        if cuda:
            profiler = tr.Profiler(cell.root / "build" / "portbench")
            profiler.start()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    feed = Feed([s.payload for s in sources], t["frames_per_dispatch"])
    net = PeakNet(cuda)
    reservoir = Reservoir(max(1, t["sample_frames"] // runner.unit_frames),
                          seed, net)
    t_warm = time.perf_counter()
    try:
        done = measure(runner, feed, seconds, t["warmup_dispatches"],
                       reservoir,
                       on_open=profiler.anchor if profiler else None)
    finally:
        events = profiler.stop() if profiler else None
        if spans is not None:
            spans.restore()
    log(f"warm-up: {feed.t_open - t_warm:.2f} s; window {seconds} s, "
        f"{len(feed.pulled)} frames pulled, drained "
        f"{time.perf_counter() - feed.t_close:.2f} s after the close")
    per_s = np.bincount([int(d - feed.t_open) for d in done
                         if feed.t_open <= d < feed.t_close],
                        minlength=int(seconds))
    log(f"frames completed in each second of the window: {per_s.tolist()}")
    if cuda:
        torch.cuda.synchronize()
        net.close()
        log(f"memory: peak {net.peak} bytes net of the sample's "
            f"{reservoir.held} bytes on the card")
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": cell.chips, "memory_peak_bytes": int(net.peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    sample = [(first, runner.to_host(unit))
              for first, unit in reservoir.items]
    same = runner.same
    del runner, reservoir
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package were loaded: "
                         f"{', '.join(found)}")
    t0 = time.perf_counter()
    expected = reference_outputs(cell, layout, sources, pool)
    run = Run(cell, seed, seconds, layout, sources, feed, done,
              feed.t_open - t_start, expected)
    check = judge(same, run, sample)
    log(f"reference and check: {time.perf_counter() - t0:.2f} s")
    if events is not None:
        run.trace = tr.TraceView(events, profiler.anchor_s,
                                 (feed.t_open, feed.t_close), spans.items)
        run.peaks = peaks_for(cell.root, dev["kind"])
        log(f"trace: {len(run.trace.device)} device operations and "
            f"{len(run.trace.spans)} host spans in the window; peaks "
            f"{'found' if run.peaks else 'not found'} for {dev['kind']}")
    metrics = read_metrics(cell.per_layer if traced else cell.end_to_end,
                           run)
    missing = check["frames_missing"]["value"]
    result = {"correct": check_passes(check),
              "attempted": len(run.window_frames()), "failed": missing,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["check"] = check
    return result
