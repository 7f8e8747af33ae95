"""The benchmark of ``watermarking_gpu_tpu_torch`` on one NVIDIA H100.

    python3 wmbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``BENCHMARK.json`` at the repository's root lists the cells; ``harness.py``
says how a cell's parts are found by name. Nothing here imports JAX or the
JAX package; ``reference/`` imports nothing of the program either.
"""
