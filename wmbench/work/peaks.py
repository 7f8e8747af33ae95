"""Published peaks of the cards the benchmark runs on.

NVIDIA's H100 SXM data sheet, dense rates at the full 700 W power limit:
80 GB of HBM3 at 3.35 TB/s, and 67 TFLOP/s in float32 outside the tensor
cores, the rate of the port's kernels. A card set below 700 W runs slower
under load; the result's device line and PERF.md give the card's name, and
PERF.md its power limit, beside every share of these peaks.
"""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": HBM_BYTES_PER_S,
                              "f32_flops_per_s": F32_FLOPS_PER_S},
}


def least_seconds(nbytes: float, flops: float,
                  device_name: str) -> tuple[float, str]:
    """(least seconds, "bytes" or "flops") of moving ``nbytes`` and doing
    ``flops`` on the named card at its peaks; a card not in the table has
    no roofline."""
    peak = PEAKS.get(device_name)
    if peak is None:
        raise KeyError(f"no published peaks for {device_name!r}")
    by_bytes = nbytes / peak["hbm_bytes_per_s"]
    by_flops = flops / peak["f32_flops_per_s"]
    return (by_bytes, "bytes") if by_bytes >= by_flops else (by_flops,
                                                             "flops")
