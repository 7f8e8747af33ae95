"""Work counts: the bytes and flops an operation needs, from its shapes.

Each operation of a traffic kind has a module here, named by the kind's
``work`` entry, with ``counts(config, params) -> (bytes, flops)`` for one
call of the operation. ``kernels.py`` holds the per-kernel bounds of
PERF.md §6 and ``peaks.py`` the card's published peaks.
"""

from __future__ import annotations

import importlib


def counts(op: str, config: dict, params: dict) -> tuple[float, float]:
    """(bytes, flops) of one call of operation ``op``."""
    return importlib.import_module(f"{__name__}.{op}").counts(config,
                                                               params)
