"""Hand-written CUDA kernels, each beside its plain PyTorch version.

Importing this package builds nothing: the kernels are compiled by
``build.library()`` at their first launch on a CUDA tensor. Each wrapper
counts its launches in a plain integer attribute, ``wrapper.launches``, where
it launches its kernel; ``me_gram`` launches the 3x3 Gram's two kernels
through their wrappers, ``me_gram_lags`` and ``me_gram_assemble``, and
``me_gram_wide`` the wide Gram's, ``wide_lag_strips`` and
``wide_assemble``, so each of those counts one a Gram. ``me_gram_solve8``
is the 3x3 Gram with the 3x3 predictor's solve in its assembly kernel
(its two launches count in ``me_gram_lags`` and ``me_gram_assemble``, and
the call once in its own count): a single device's analysis.
``spd_solve8`` solves that system from a Gram alone, the Gram that the
spatial routes fold from their shards, and ``spd_solve_wide`` the wide
predictor's from the wide Gram, one launch a solve. ``embed_finish`` scales the embed field to each frame's strength and
adds it to the output, one launch a fused embed.
``prediction_error`` and ``nvf_mask`` are standalone ops that no engine path
calls (their modules say why); the rest carry the embed, detect and
identification paths. ``detect_many_partials.clustered`` counts, beside its
launches, those that ran in clusters of frames sharing each candidate's
copy, ``detect_partials.pipelined`` the detect tail's launches (by its
wrapper or ``detect_chain``) that took the pipelined schedule of ME p=3,
and ``embed_field.nvf`` and ``detect_partials.nvf`` the embed field's and
the detect tail's launches at the NVF mask (by their wrappers or
``embed_chain`` / ``detect_chain``); ``launch_counts`` leaves these four
out, ``reset_launch_counts`` zeroes them.
Each wrapper of ``KERNELS``, ``me_gram`` and ``me_gram_wide`` opens a
``kernels.<name>`` span (``utils/profiling.py``) over its checks,
allocations and launch.

``embed_chain`` and ``detect_chain`` (``chain.py``) are the pipelines'
fused embed and detect of whole CUDA frames, each one call into the
library: the predictor's analysis (the 3x3 lag kernel and solving
assembly, or the wide lag kernel, wide assembly and blocked solve; none
for NVF's embed), then the embed field and the embed finish, or the detect
tail, whose last block of a frame (the detect tail's at ME p=3: of a chunk
of frames) finishes that frame's sums or its correlation. Each of their
launches counts in its kernel's wrapper, as the wrappers called one by one
count it (``me_gram_solve8`` once a 3x3 analysis), and each call once in
``embed_chain.launches`` or ``detect_chain.launches``, which
``launch_counts`` and ``reset_launch_counts`` cover; their spans are
``kernels.embed_chain`` and ``kernels.detect_chain``. The wrappers one by
one remain the route of CPU tensors, the halo forms
(``parallel/spatial.py``), frames too small for the wide Gram's lag form,
identification (``detect_many_partials``), the tools and the tests.
"""

from ..me import (assemble_lags_plain, assemble_strips_plain, frame_banks,
                  gram_lags_plain, lag_partials_plain, lag_strips_plain,
                  me_gram_wide_plain)
from .chain import detect_chain, embed_chain
from .detect_many import detect_many_partials, detect_many_partials_plain
from .finish import embed_finish, embed_finish_plain
from .fused import (detect_partials, detect_partials_plain, embed_field,
                    embed_field_plain, stencil_reach)
from .me_gram_wide import me_gram_wide, wide_assemble, wide_lag_strips
from .me_kernel import (me_gram, me_gram_assemble, me_gram_lags,
                        me_gram_plain, me_gram_solve8)
from .nvf import nvf_mask, nvf_mask_plain
from .predict import prediction_error, prediction_error_plain
from .solve import (spd_solve8, spd_solve8_plain, spd_solve_wide,
                    spd_solve_wide_plain)

KERNELS = {"me_gram_lags": me_gram_lags,
           "me_gram_assemble": me_gram_assemble,
           "me_gram_solve8": me_gram_solve8,
           "wide_lag_strips": wide_lag_strips,
           "wide_assemble": wide_assemble,
           "embed_field": embed_field, "detect_partials": detect_partials,
           "detect_many": detect_many_partials,
           "prediction_error": prediction_error, "nvf_mask": nvf_mask,
           "spd_solve8": spd_solve8, "spd_solve_wide": spd_solve_wide,
           "embed_finish": embed_finish, "embed_chain": embed_chain,
           "detect_chain": detect_chain}


def reset_launch_counts() -> None:
    for wrapper in KERNELS.values():
        wrapper.launches = 0
    detect_many_partials.clustered = 0
    detect_partials.pipelined = 0
    detect_partials.nvf = 0
    embed_field.nvf = 0


def launch_counts() -> dict[str, int]:
    return {name: wrapper.launches for name, wrapper in KERNELS.items()}


__all__ = ["KERNELS", "assemble_lags_plain", "assemble_strips_plain",
           "detect_chain", "detect_many_partials",
           "detect_many_partials_plain", "detect_partials",
           "detect_partials_plain", "embed_chain", "embed_field",
           "embed_field_plain",
           "embed_finish", "embed_finish_plain",
           "frame_banks", "gram_lags_plain", "lag_partials_plain",
           "lag_strips_plain", "launch_counts", "me_gram", "me_gram_assemble",
           "me_gram_lags", "me_gram_plain", "me_gram_solve8", "me_gram_wide",
           "me_gram_wide_plain", "nvf_mask", "nvf_mask_plain",
           "prediction_error", "prediction_error_plain",
           "reset_launch_counts", "spd_solve8", "spd_solve8_plain",
           "spd_solve_wide", "spd_solve_wide_plain", "stencil_reach",
           "wide_assemble", "wide_lag_strips"]
