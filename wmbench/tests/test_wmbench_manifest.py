"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds a
new cell, configuration, traffic mix and metric by name, as new files."""

import json
import re
import shutil
import time
from pathlib import Path

import pytest
import torch

from wmbench import harness, readers

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_command():
    assert set(MANIFEST) == TOP_KEYS
    assert MANIFEST["command"] == ["python3", "wmbench/run.py"]
    assert MANIFEST["paths"] == ["wmbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_text():
    names = ([c["name"] for c in MANIFEST["configs"]]
             + [w["name"] for w in MANIFEST["workloads"]]
             + [m["name"] for m in MANIFEST["end_to_end"]
                + MANIFEST["per_layer"]]
             + [w["traffic"] for w in MANIFEST["workloads"]])
    assert all(NAME.match(name) for name in names), names
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    for entry in MANIFEST["configs"] + MANIFEST["workloads"]:
        assert one_line(entry["why"])
    for config in MANIFEST["configs"]:
        assert one_line(config["source"])
        assert config["source"].startswith("https://")
        assert config["reduced"] == []
        assert config["file"].startswith("wmbench/")


@pytest.mark.parametrize("entry", MANIFEST["workloads"],
                         ids=lambda entry: entry["name"])
def test_each_cell_has_its_files_and_metrics(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] == 1
    assert (ROOT / "wmbench" / "traffic" / f"{entry['traffic']}.json"
            ).is_file()
    params = harness.load_json(ROOT / "wmbench" / "traffic"
                               / f"{entry['traffic']}.json")
    assert (ROOT / "wmbench" / "traffic" / f"{params['kind']}.py").is_file()
    assert harness.load_json(ROOT / "wmbench" / "cells"
                             / f"{entry['name']}.json")["limits"]
    for trace in (False, True):
        ctx = harness.Context(MANIFEST, entry["name"], 1, 1.0, trace,
                              torch.device("cpu"))
        names = {m["name"] for m in ctx.metrics()}
        assert names, (entry["name"], trace)
        if not trace:
            assert "setup_s" in names and len(names) >= 2


def test_metrics_have_readers_bounds_and_layers():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for metric in MANIFEST["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for metric in MANIFEST["per_layer"]:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert one_line(metric["layer"])
        moved = e2e[metric["moves"]]
        assert set(metric["workloads"]) <= set(moved.get("workloads",
                                                         cells))
        if "roofline" in metric["name"] or "mfu" in metric["name"]:
            assert metric["unit"] == "%"
    for metric in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert set(metric.get("workloads", [])) <= cells
        assert callable(harness.reader(ROOT / "wmbench", metric["name"]))


def test_a_metric_split_by_configuration_reads_with_its_stems_reader():
    bench = ROOT / "wmbench"
    assert not (bench / "metrics" / "step_fps.1080p.py").exists()
    assert harness.reader(bench, "step_fps.1080p") is readers.window_rate
    with pytest.raises(FileNotFoundError):
        harness.reader(bench, "no_such_metric")


def test_a_new_cell_config_mix_and_metric_are_found_as_new_files(tmp_path):
    bench = tmp_path / "wmbench"
    shutil.copytree(ROOT / "wmbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    config = json.loads((bench / "configs" / "me_p3_1080p.json").read_text())
    config["p"] = 5
    (bench / "configs" / "me_p5_1080p.json").write_text(json.dumps(config))
    mix = json.loads((bench / "traffic" / "bulk_b8.json").read_text())
    mix["batch"] = 2
    (bench / "traffic" / "bulk_b2.json").write_text(json.dumps(mix))
    (bench / "cells" / "me_p5_1080p.bulk_b2.json").write_text(json.dumps(
        {"limits": {"pixel_abs": 1.0, "corr_abs": 0.01}}))
    (bench / "metrics" / "steps_in_window.py").write_text(
        "def read(ctx):\n    return ctx.spans['window'][1]\n")
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["configs"].append({"name": "me_p5_1080p", "source": "x",
                                "file": "wmbench/configs/me_p5_1080p.json",
                                "reduced": [], "why": "x"})
    manifest["workloads"].append({"name": "me_p5_1080p.bulk_b2",
                                  "config": "me_p5_1080p",
                                  "traffic": "bulk_b2", "chips": 1,
                                  "why": "x"})
    manifest["end_to_end"].append({"name": "steps_in_window", "unit": "n",
                                   "better": "higher", "bound": 0.25,
                                   "source": "host_clock",
                                   "workloads": ["me_p5_1080p.bulk_b2"]})
    ctx = harness.Context(manifest, "me_p5_1080p.bulk_b2", 3, 0.2, False,
                          torch.device("cpu"), bench_dir=bench,
                          overrides={"rows": 48, "cols": 64})
    assert ctx.config["p"] == 5 and ctx.params["batch"] == 2
    result = harness.run(ctx, time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["metrics"]["steps_in_window"]["value"] >= 1
    assert set(result["metrics"]) == {"steps_in_window", "setup_s"}
    assert list(result)[-1] == "checks"
