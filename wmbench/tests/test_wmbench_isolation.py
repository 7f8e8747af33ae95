"""The benchmark imports neither JAX nor the JAX package, its reference
imports nothing of the program, and a run that cannot measure prints no
result."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

from wmbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "wmbench"


def imported_tops(path: Path) -> set[str]:
    """Top-level names of every absolute import in a file."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_imports_jax_or_the_jax_package():
    sources = sorted(BENCH.rglob("*.py"))
    assert len(sources) > 20
    for path in sources:
        bad = imported_tops(path) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert imported_tops(path) <= {"__future__", "math", "torch"}, path


def test_loaded_modules_are_compared_by_whole_top_level_name():
    assert harness.forbidden_modules(
        ["watermarking_gpu_tpu_torch", "watermarking_gpu_tpu_torch.ops",
         "jaxtyping", "flaxen.x"]) == []
    assert harness.forbidden_modules(
        ["watermarking_gpu_tpu.ops.me", "jax.numpy", "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib", "watermarking_gpu_tpu"]


def test_a_run_loads_no_jax():
    code = ("import sys, time, torch; sys.path.insert(0, sys.argv[1]); "
            "from wmbench import harness; "
            "m = harness.load_json(harness.ROOT / 'BENCHMARK.json'); "
            "[harness.run(harness.Context(m, w['name'], 5, 0.1, t, "
            "torch.device('cpu'), overrides={'rows': 48, 'cols': 64, "
            "'batch': 2, 'ring': 2, 'pool': 4, 'candidates': 3, "
            "'marked_frames': 1, 'rate_per_s': 100, 'trace_seconds': 0.1})"
            ", time.perf_counter()) for w in m['workloads'] "
            "for t in (False, True)]; "
            "print(harness.forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_run_exits_1_and_prints_nothing():
    proc = subprocess.run(
        [sys.executable, "wmbench/run.py", "--workload",
         "me_p3_1080p.bulk_b8", "--seed", str(2 ** 31 + 5), "--seconds",
         "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 1
    assert proc.stdout == ""


def test_without_the_program_a_run_fails_and_prints_nothing(tmp_path):
    """A checkout of BENCHMARK.json and wmbench/ alone: the harness finds
    no program to measure and raises before any result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "wmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time, json, torch; sys.path[:] = [sys.argv[1]] + "
            "[p for p in sys.path[1:] if p and 'repo' not in p]; "
            "from wmbench import harness; "
            "m = harness.load_json(harness.ROOT / 'BENCHMARK.json'); "
            "ctx = harness.Context(m, 'me_p3_1080p.bulk_b8', 5, 0.1, False, "
            "torch.device('cpu'), overrides={'rows': 48, 'cols': 64}); "
            "print(json.dumps(harness.run(ctx, time.perf_counter())))")
    env = {key: value for key, value in os.environ.items()
           if key != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "watermarking_gpu_tpu_torch" in proc.stderr
