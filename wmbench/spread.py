#!/usr/bin/env python3
"""Run a cell several times and report each end-to-end metric's spread.

    python3 wmbench/spread.py --workload me_p3_1080p.bulk_b8 --seconds 10 \
        --seeds 1 2 3 4 5 6 --sets 2 [--trace-seeds 7 8 9] \
        [--out runs/bulk.jsonl]

Runs ``wmbench/run.py`` once a seed, the seeds in order, ``--sets`` times
(the same seeds in every set), then once with ``--trace 1`` for each trace
seed; every run is its own process, as the benchmark's command runs it.
Writes each run's result line (or its exit code and the end of its
standard error) to ``--out``, then for each metric and set the median and
the spread, the distance between the first and third quartiles (Python's
``statistics.quantiles(values, n=4)``) as a share of the median; the same
with each set's run farthest from its median left out; and over all the
runs of every set together.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values: list[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values: list[float]) -> list[float]:
    """The values without the one farthest from their median."""
    median = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - median))
    return values[:far] + values[far + 1:]


def one_run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "wmbench" / "run.py"), "--workload",
         workload, "--seed", str(seed), "--seconds", str(seconds),
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True)
    out = {"seed": seed, "trace": trace, "rc": proc.returncode,
           "wall_s": time.perf_counter() - start}
    lines = proc.stdout.strip().splitlines()
    if proc.returncode == 0 and lines:
        out["result"] = json.loads(lines[-1])
    else:
        out["stderr"] = proc.stderr[-3000:]
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--sets", type=int, default=2)
    parser.add_argument("--trace-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--out", type=Path)
    args = parser.parse_args()
    runs = []
    sink = open(args.out, "a") if args.out else None
    try:
        plan = [(s, seed, 0) for s in range(args.sets) for seed in args.seeds]
        plan += [(None, seed, 1) for seed in args.trace_seeds]
        for index, (which, seed, trace) in enumerate(plan):
            out = one_run(args.workload, seed, args.seconds, trace)
            out["set"] = which
            runs.append(out)
            line = json.dumps(out)
            if sink:
                sink.write(line + "\n")
                sink.flush()
            result = out.get("result", {})
            print(f"[{index}] set {which} seed {seed} trace {trace} rc "
                  f"{out['rc']} wall {out['wall_s']:.1f}s correct "
                  f"{result.get('correct')} "
                  f"{json.dumps(result.get('metrics', {}))} "
                  f"{json.dumps(result.get('checks', {}))} "
                  f"{out.get('stderr', '')[-1500:]}", flush=True)
            if trace and result:
                print(f"    device {json.dumps(result['device'])}\n    "
                      f"breakdown {json.dumps(result.get('breakdown'))}",
                      flush=True)
    finally:
        if sink:
            sink.close()
    summary = {"workload": args.workload, "seconds": args.seconds,
               "metrics": {}}
    for which in range(args.sets):
        for out in runs:
            if out["set"] != which or "result" not in out:
                continue
            for name, metric in out["result"]["metrics"].items():
                summary["metrics"].setdefault(name, {}).setdefault(
                    which, []).append(metric["value"])
    for name, sets in summary["metrics"].items():
        report = {}
        for which, values in sets.items():
            if len(values) >= 2:
                report[f"set{which}"] = {
                    "median": statistics.median(values),
                    "spread": spread(values),
                    "spread_trimmed": (spread(trimmed(values))
                                       if len(values) >= 3 else None),
                    "values": values}
        every = [value for values in sets.values() for value in values]
        if len(every) >= 2:
            report["all"] = {"median": statistics.median(every),
                             "spread": spread(every)}
        summary["metrics"][name] = report
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
