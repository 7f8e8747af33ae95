#!/usr/bin/env python3
"""Find the highest rate a serving cell's service sustains, on the card.

    python3 wmbench/sweep.py --workload me_p3_1080p.serve_detect_u8 \
        --seed 5 --seconds 5 --rates 200 400 600 800

One process, one set-up; then for each rate a window of Poisson arrivals
(the cell's own traffic at that rate) and one JSON line: the latency's
median, 95th and 99th percentiles from when each request was due, the
same percentile over the first and the second half of the requests (a
backlog that grows shows as a second half far slower than the first), the
requests refused and unanswered, how late the generator ran, and the rate
completed. The cell's file then fixes a rate below the knee.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

# the checkout's root, not wmbench/ itself
sys.path[0] = str(Path(__file__).resolve().parents[1])

import numpy as np  # noqa: E402
import torch  # noqa: E402

from wmbench import harness  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--rates", type=float, nargs="+", required=True)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    ctx = harness.Context(manifest, args.workload, args.seed, args.seconds,
                          False, torch.device("cuda", 0))
    cell = harness.kind(ctx.params).Cell(ctx)
    try:
        for rate in args.rates:
            ctx.params["rate_per_s"] = rate
            cell.run(ctx)
            ms = ctx.latencies_s * 1e3
            half = len(ms) // 2
            print(json.dumps({
                "rate_per_s": rate, "requests": len(ms),
                "p50_ms": float(np.percentile(ms, 50)),
                "p95_ms": float(np.percentile(ms, 95)),
                "p99_ms": float(np.percentile(ms, 99)),
                "p95_first_half_ms": float(np.percentile(ms[:half], 95)),
                "p95_second_half_ms": float(np.percentile(ms[half:], 95)),
                "failed": ctx.failed,
                "completed_per_s": (len(ms) - ctx.failed) / args.seconds,
                "batches": ctx.counters["batches"],
                **ctx.extra["generator"]}), flush=True)
    finally:
        cell.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
