#!/usr/bin/env python3
"""Readings that a cell's limits are set from, on the card.

    python3 wmbench/calibrate.py --workload me_p3_1080p.bulk_b8 \
        --seeds 11 12 ... --control-seeds 11 12 13 --seconds 2

For each seed, in one process: the cell's set-up, a short window at the
cell's own load, and the numbers its check compares, the program's answers
against the float64 reference (the lower readings). For each control seed
also the control's: the reference computed in bfloat16, the nearest
precision below the configuration's float32, put in the program's place
(the upper readings). One JSON line a seed, then the largest program
reading and the smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

# the checkout's root, not wmbench/ itself
sys.path[0] = str(Path(__file__).resolve().parents[1])

import torch  # noqa: E402

from wmbench import harness  # noqa: E402


def readings(manifest: dict, workload: str, seed: int, seconds: float,
             control: bool, device: torch.device) -> dict:
    """{"program": numbers, "control": numbers or None} of one seed."""
    ctx = harness.Context(manifest, workload, seed, seconds, False, device)
    cell = harness.kind(ctx.params).Cell(ctx)
    cell.run(ctx)
    harness.synchronize(device)
    got = cell.answers()
    cell.release()
    want = cell.expected(torch.float64)
    out = {"seed": seed, "program": cell.compare(got, want),
           "control": None}
    if control:
        out["control"] = cell.compare(cell.expected(torch.bfloat16), want)
    del cell, got, want
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    device = torch.device("cuda", 0)
    lower: dict = {}
    upper: dict = {}
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        start = time.perf_counter()
        out = readings(manifest, args.workload, seed, args.seconds,
                       seed in args.control_seeds, device)
        out["seconds"] = time.perf_counter() - start
        print(json.dumps(out), flush=True)
        if seed in args.seeds:
            for name, value in out["program"].items():
                lower[name] = max(lower.get(name, value), value)
        for name, value in (out["control"] or {}).items():
            upper[name] = min(upper.get(name, value), value)
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper,
                      "device": torch.cuda.get_device_name(device)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
