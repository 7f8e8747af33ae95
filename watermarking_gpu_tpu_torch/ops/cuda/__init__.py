"""Hand-written CUDA kernels for the main path, each beside its plain
PyTorch version.

Importing this package builds nothing: the kernels are compiled by
``build.library()`` at their first launch on a CUDA tensor. Each wrapper
counts its launches in a plain integer attribute, ``wrapper.launches``.
"""

from .fused import (detect_partials, detect_partials_plain, embed_field,
                    embed_field_plain)
from .me_kernel import me_gram, me_gram_plain

KERNELS = {"me_gram": me_gram, "embed_field": embed_field,
           "detect_partials": detect_partials}


def reset_launch_counts() -> None:
    for wrapper in KERNELS.values():
        wrapper.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: wrapper.launches for name, wrapper in KERNELS.items()}


__all__ = ["KERNELS", "detect_partials", "detect_partials_plain",
           "embed_field", "embed_field_plain", "launch_counts", "me_gram",
           "me_gram_plain", "reset_launch_counts"]
