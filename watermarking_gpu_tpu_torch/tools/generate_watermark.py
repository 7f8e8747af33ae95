"""Watermark matrix generator CLI.

Same contract as the reference's ``CommonRandomMatrix.exe rows cols seed
file`` (``CommonRandomMatrix/main.cpp:16-68``) and the JAX package's
``tools/generate_watermark.py``: writes ``rows*cols`` N(0,1) float32 values
to a raw little-endian file.

    python -m watermarking_gpu_tpu_torch.tools.generate_watermark \
        rows cols seed output_file [--repeat-blocks N]

``--repeat-blocks N`` emulates the reference generator's same-seed-per-
OpenMP-thread quirk (``CommonRandomMatrix/main.cpp:41``). The tool does no
device work.
"""

from __future__ import annotations

import argparse
import sys

from ..io.matfile import generate_watermark, save_watermark


def main(argv: list[str] | None = None, device=None) -> int:
    """``device`` is accepted for the tools' common signature and unused."""
    del device
    parser = argparse.ArgumentParser(
        description="Generate a N(0,1) float32 watermark matrix (.dat)")
    parser.add_argument("rows", type=int)
    parser.add_argument("cols", type=int)
    parser.add_argument("seed", type=int)
    parser.add_argument("output_file")
    parser.add_argument("--repeat-blocks", type=int, default=1,
                        help="emulate the reference's per-thread stream "
                             "repetition quirk")
    args = parser.parse_args(argv)
    try:
        matrix = generate_watermark(args.rows, args.cols, args.seed,
                                    repeat_blocks=args.repeat_blocks)
    except ValueError as exc:
        print(exc, file=sys.stderr)
        return 1
    save_watermark(args.output_file, matrix)
    print(f"Successfully wrote {args.rows * args.cols} random floats to "
          f"{args.output_file}.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
