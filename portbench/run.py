"""Run one cell of the port's benchmark on the card this process is on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``. The last
line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics; with ``--trace 1``
its per-layer ones), ``device`` and, last, ``check``: each number held
against the reference beside its limit, which also end standard error.
Without a CUDA device, or with fewer than the cell asks for, the run
exits with 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its own kernels under ``build/torch_kernels``)."""
    cache = ROOT / "build" / "portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


def card_note() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    cell = harness.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"card: {card_note()}; torch {torch.__version__}", file=sys.stderr)
    result = harness.execute(cell, args.seed, args.seconds,
                             bool(args.trace), T_START)
    print(json.dumps(result), flush=True)
    for name, c in result["check"].items():
        bound = (f"limit {c['limit']}" if "limit" in c
                 else f"at least {c['at_least']}")
        print(f"check {name}: {c['value']} ({bound})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
