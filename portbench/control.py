"""The control of a cell's comparison: the reference computed with the
float32 DCT (the lower-precision step a later change might take) put in
the program's place, judged exactly as a run judges the program.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

The program's outputs repeat for a source, so the control needs no
window: every sampled frame of a run is the control's output for its
source. Prints one JSON line a seed; the control has to read
``correct: false``. The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def control(cell, seed: int, dct: str = "float32") -> dict:
    from portbench import harness

    t = cell.traffic
    with harness.workers(cell) as pool:
        layout, sources = harness.make_sources(cell, seed, pool)
        expected = harness.reference_outputs(cell, layout, sources, pool)
        lower = harness.reference_outputs(cell, layout, sources, pool, dct)
    feed = harness.Feed([s.payload for s in sources],
                        t["frames_per_dispatch"])
    n = t["sample_frames"]
    feed.pulled = [0.0] * n
    feed.open(0.0, 1.0)
    run = harness.Run(cell, seed, 1.0, layout, sources, feed,
                      [0.0] * n, 0.0, expected)
    sample = [(i, [lower[feed.source_of(i)]]) for i in range(n)]
    check = harness.judge(cell.entry().Runner.same, run, sample)
    return {"seed": seed, "dct": dct, "correct": harness.check_passes(check),
            "check": check}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    cell = harness.load_cell(args.workload, ROOT)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control(cell, seed)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
