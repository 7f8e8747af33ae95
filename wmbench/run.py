#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result.

    python3 wmbench/run.py --workload me_p3_1080p.bulk_b8 --seed 7 \
        --seconds 10 --trace 0

Run from the repository's root on a machine with the card(s) the cell asks
for. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``; with ``--trace 1`` the
per-layer metrics, the device's busy and window seconds and a
``breakdown``); the last lines of standard error give each number the check
compared beside its limit, as does the result's last key, ``checks``.
Without a card, with fewer cards than the cell asks for, or with JAX or the
JAX package loaded once the window has closed, it exits 1 and prints no
result.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)     # the checkout's root, not wmbench/ itself


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    import torch

    from wmbench import harness

    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    chips = {cell["name"]: cell["chips"]
             for cell in manifest["workloads"]}.get(args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    ctx = harness.Context(manifest, args.workload, args.seed, args.seconds,
                          bool(args.trace), torch.device("cuda", 0))
    result = harness.run(ctx, STARTED)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"the run loaded {loaded}: the port must not import JAX or "
              f"the JAX package", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
