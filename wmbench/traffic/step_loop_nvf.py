"""Closed loop of bulk steps at the NVF mask: ``step_loop``'s set-up,
window, answers and check, held against the NVF reference
(``reference/plain_nvf.py``).

Beside the metrics (``launches`` in the result, not a metric) it reports
what the port's launch counters (``ops/cuda``) show over the run's steps:
the embed field's and the detect tail's launches, and as shares of them
those at the NVF mask (``embed_field.nvf``, ``detect_partials.nvf``) and
those made by the one-call chains (``embed_chain``, ``detect_chain``), so
that a run that fell off the chain or off the NVF kernels shows. A program
without a counter reports the others; on CPU tensors nothing launches and
only the counts, all 0, are reported.
"""

from __future__ import annotations

import torch

from watermarking_gpu_tpu_torch.ops import cuda as kernels

from ..reference import plain_nvf
from . import step_loop

# (name in the result, wrapper, attribute)
COUNTERS = (("embed_field", kernels.embed_field, "launches"),
            ("embed_field.nvf", kernels.embed_field, "nvf"),
            ("embed_chain", kernels.embed_chain, "launches"),
            ("detect_partials", kernels.detect_partials, "launches"),
            ("detect_partials.nvf", kernels.detect_partials, "nvf"),
            ("detect_chain", kernels.detect_chain, "launches"))
# each share's counter over the launches it is a share of
SHARES = {"embed_field.nvf": "embed_field",
          "embed_chain": "embed_field",
          "detect_partials.nvf": "detect_partials",
          "detect_chain": "detect_partials"}


def counts() -> dict[str, int]:
    """The counters the program has, as they stand."""
    out = {}
    for name, wrapper, attr in COUNTERS:
        value = getattr(wrapper, attr, None)
        if value is not None:
            out[name] = int(value)
    return out


def launch_report(before: dict, after: dict) -> dict:
    """The counters' growth between two ``counts()`` and each share whose
    counter and whose base grew by something."""
    grown = {name: after[name] - before[name] for name in after
             if name in before}
    shares = {name: grown[name] / grown[base]
              for name, base in SHARES.items()
              if name in grown and grown.get(base)}
    return {"counts": grown, "shares": shares}


class Cell(step_loop.Cell):
    def run(self, ctx) -> None:
        before = counts()
        super().run(ctx)
        ctx.extra["launches"] = launch_report(before, counts())

    def expected(self, dtype):
        """The NVF reference's answers, one step a ring slot, in
        ``dtype``."""
        flat = self.frames.reshape(-1, *self.frames.shape[-2:])
        marked, strengths = plain_nvf.embed(flat, self.watermark, self.psnr,
                                            self.p, dtype)
        corrs = plain_nvf.detect(marked, self.watermark, self.p, dtype)
        shape = (self.ring, self.batch)
        return {"marked": list(marked.view(*shape, *marked.shape[-2:])),
                "slots": torch.arange(self.ring),
                "strengths": strengths.view(shape).cpu(),
                "corrs": corrs.view(shape).cpu()}
