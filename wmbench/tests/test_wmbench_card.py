"""Every cell on the card, as the benchmark's command runs it: a short plain
run and a short traced run, each correct, with the metrics the manifest
gives the cell and the device's fields. Needs an NVIDIA GPU and nvcc;
elsewhere every test skips. On the card:

    python -m pytest -m cuda wmbench/tests/test_wmbench_card.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; on the card run python "
                    "-m pytest -m cuda wmbench/tests/test_wmbench_card.py")


def expected_metrics(name: str, trace: int) -> set[str]:
    group = MANIFEST["per_layer" if trace else "end_to_end"]
    return {metric["name"] for metric in group
            if name in metric.get("workloads", [name])}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", [cell["name"]
                                  for cell in MANIFEST["workloads"]])
def test_a_cell_runs_correct_with_its_metrics(card, name, trace):
    proc = subprocess.run(
        [sys.executable, "wmbench/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 99), "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == expected_metrics(name, trace)
    device = result["device"]
    assert device["platform"] == "gpu" and device["count"] == 1
    assert device["kind"] == torch.cuda.get_device_name(0)
    assert device["memory_peak_bytes"] > 0
    if trace:
        assert 0 < device["busy_s"] <= device["window_s"]
        assert len(result["breakdown"]["device_ops"]) <= 10
        for metric, value in result["metrics"].items():
            if metric.endswith("roofline"):
                assert 0 < value["value"] <= 100
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
