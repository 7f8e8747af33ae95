"""Inputs made from ``--seed``: frames, watermarks, banks and arrivals.

Everything the card holds is drawn on the card by a ``torch.Generator`` in a
few large calls (the host's MT19937 takes ~40 ms a 1080p matrix); each input
has a stream of its own, so adding one leaves the others as they were. The
same seed gives the same inputs. Every seed gives the same sizes and the
same set of arrival gaps, in another order, so that seeds differ in content
and order and not in the amount of work.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_STREAMS = {"frames": 1, "watermark": 2, "bank": 3, "choice": 4,
            "arrivals": 5, "order": 6, "sample": 7}
_MASK64 = (1 << 64) - 1


def stream_seed(seed: int, name: str) -> int:
    """A 64-bit seed for input ``name`` of run seed ``seed`` (any int)."""
    mixed = (seed * 0x9E3779B97F4A7C15 + _STREAMS[name] * 0xBF58476D1CE4E5B9)
    return (mixed ^ (mixed >> 31)) & _MASK64


def generator(seed: int, name: str, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, name))
    return gen


def frames(seed: int, count: int, rows: int, cols: int,
           device: torch.device) -> torch.Tensor:
    """(count, rows, cols) f32 frames on [0, 255] that look like images: a
    smooth field (uniform levels on a grid of 16-pixel cells, bilinearly
    upsampled) plus fine N(0, 6) detail, clamped."""
    gen = generator(seed, "frames", device)
    coarse = torch.rand(count, 1, rows // 16 + 2, cols // 16 + 2,
                        generator=gen, device=device) * 200.0 + 28.0
    smooth = F.interpolate(coarse, size=(rows, cols), mode="bilinear",
                           align_corners=False)[:, 0]
    detail = torch.randn(count, rows, cols, generator=gen, device=device)
    return torch.clamp(smooth + 6.0 * detail, 0.0, 255.0)


def watermark(seed: int, rows: int, cols: int,
              device: torch.device) -> torch.Tensor:
    """(rows, cols) N(0, 1) f32 watermark."""
    return torch.randn(rows, cols, generator=generator(seed, "watermark",
                                                       device),
                       device=device)


def bank(seed: int, count: int, rows: int, cols: int,
         device: torch.device) -> torch.Tensor:
    """(count, rows, cols) N(0, 1) f32 candidate watermarks."""
    return torch.randn(count, rows, cols,
                       generator=generator(seed, "bank", device),
                       device=device)


def host_rng(seed: int, name: str) -> np.random.Generator:
    """A numpy generator for choices made on the host."""
    return np.random.default_rng(stream_seed(seed, name))


def poisson_dues(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Due times in [0, seconds) of a Poisson stream at ``rate`` a second:
    the n = rate * seconds gaps are the exponential distribution's
    quantiles at (i + 1/2) / n, the same set for every seed, in an order
    drawn from the seed."""
    n = int(round(rate * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    dues = np.cumsum(host_rng(seed, "arrivals").permutation(gaps))
    return dues[dues < seconds]
