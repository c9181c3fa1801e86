"""What the benchmark loads: nothing of JAX or the JAX package in a run
(top-level module names compared whole: the port's name begins with the
JAX package's), nothing of the program in the reference, none of the JAX
package's benchmark files; and no result without a card."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys

from portbench import harness

ROOT = harness.ROOT
PORTBENCH = ROOT / "portbench"


def _python(code: str, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import portbench.run, portbench.control\n"
        "from portbench import harness\n"
        "from portbench.tests.helpers import run_tiny, tiny_cell\n"
        "r = run_tiny(tiny_cell('decode-4k-tworow-q90'))\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps([r['correct'], harness.forbidden_modules(),"
        " 'video_coding_tpu_torch' in tops]))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    correct, forbidden, port = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and forbidden == [] and port


def test_forbidden_names_are_whole_top_level_names():
    sys.modules.setdefault("video_coding_tpu_torch_probe", sys)
    try:
        assert "video_coding_tpu_torch_probe" not in \
            harness.forbidden_modules()
    finally:
        del sys.modules["video_coding_tpu_torch_probe"]


def test_the_reference_imports_nothing_of_the_program():
    for path in (PORTBENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in (
                    "video_coding_tpu", "video_coding_tpu_torch", "jax",
                    "torch"), (path, n)
    out = _python(
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import portbench.reference.baseline_jpeg, portbench.frames\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    tops = set(json.loads(out.stdout))
    assert not tops & {"video_coding_tpu", "video_coding_tpu_torch", "jax",
                       "torch"}


def test_nothing_reads_the_jax_benchmark_or_the_smoke_run():
    for path in PORTBENCH.rglob("*.py"):
        if "tests" in path.relative_to(PORTBENCH).parts:
            continue
        text = path.read_text()
        for name in ("chip_smoke", "bench.py", "benchmarks/", "BENCH_r",
                     "MULTICHIP_"):
            assert name not in text, (path, name)


def test_no_card_no_result(tmp_path):
    cmd = [sys.executable, "portbench/run.py", "--workload",
           "decode-4k-tworow-q90", "--seed", str(2**40 + 1), "--seconds", "1",
           "--trace", "0"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode != 0 and out.stdout == ""
    # a directory with only the manifest and the benchmark's files
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode != 0 and out.stdout == ""
