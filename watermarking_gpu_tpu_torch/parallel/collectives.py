"""Collectives over one mesh axis, for the per-shard programs of
``parallel.spatial`` driven from one process.

They replace the JAX package's ``lax.psum``, ``lax.pmax`` and
``lax.ppermute`` inside ``shard_map``. A value along the axis is the list
of its shards' tensors in shard order, each on its own shard's device;
``lax.axis_index`` and ``lax.axis_size`` become a shard's place in that
list and the list's length. Every copy between devices is an explicit
``.to(device, non_blocking=True)``, which queues on the devices' streams
and does not wait: on several cards the copies go device to device, on one
card that a mesh names more than once they are no copies at all. Nothing
here reads a value on the host, so a loop over the shards never waits for
one of them.
"""

from __future__ import annotations

import torch


def fold(values: list[torch.Tensor], op=torch.add) -> torch.Tensor:
    """``values`` folded with ``op`` in shard order, once, on shard 0's
    device (what a program that needs the result on one shard takes)."""
    total = values[0]
    for value in values[1:]:
        total = op(total, value.to(total.device, non_blocking=True))
    return total


def psum(values: list[torch.Tensor]) -> list[torch.Tensor]:
    """The sum of the shards' values, added in shard order, on every
    shard."""
    return broadcast(fold(values), [value.device for value in values])


def pmax(values: list[torch.Tensor]) -> list[torch.Tensor]:
    """The elementwise max of the shards' values, on every shard."""
    return broadcast(fold(values, torch.maximum),
                     [value.device for value in values])


def broadcast(value: torch.Tensor,
              devices: list[torch.device]) -> list[torch.Tensor]:
    """``value`` on each of ``devices`` (one shard's value to all)."""
    return [value.to(device, non_blocking=True) for device in devices]


def shift(blocks: list[torch.Tensor],
          hops: int) -> list[torch.Tensor | None]:
    """Send each shard's block ``hops`` shards along the axis (back when
    negative): entry i is block i - hops on shard i's device, None where
    no shard is that far from i (``lax.ppermute`` with the pairs
    (i, i + hops))."""
    n = len(blocks)
    return [blocks[i - hops].to(blocks[i].device, non_blocking=True)
            if 0 <= i - hops < n else None for i in range(n)]
