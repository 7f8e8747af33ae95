"""Hand-written CUDA kernels for the main path, each beside its plain
PyTorch version.

Importing this package builds nothing: the kernels are compiled by
``build.library()`` at their first launch on a CUDA tensor. Each wrapper
counts its launches in a plain integer attribute, ``wrapper.launches``.
"""

from ..me import lag_partials_plain, me_gram_wide_plain
from .fused import (detect_partials, detect_partials_plain, embed_field,
                    embed_field_plain)
from .me_gram_wide import me_gram_wide, wide_gram_partials
from .me_kernel import me_gram, me_gram_plain

KERNELS = {"me_gram": me_gram, "me_gram_wide": me_gram_wide,
           "embed_field": embed_field, "detect_partials": detect_partials}


def reset_launch_counts() -> None:
    for wrapper in KERNELS.values():
        wrapper.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: wrapper.launches for name, wrapper in KERNELS.items()}


__all__ = ["KERNELS", "detect_partials", "detect_partials_plain",
           "embed_field", "embed_field_plain", "lag_partials_plain",
           "launch_counts", "me_gram", "me_gram_plain", "me_gram_wide",
           "me_gram_wide_plain", "reset_launch_counts",
           "wide_gram_partials"]
