"""``python -m watermarking_gpu_tpu_torch [settings.ini]`` — the benchmark CLI
on the card."""

import sys

from .cli.main import main

if __name__ == "__main__":
    sys.exit(main())
