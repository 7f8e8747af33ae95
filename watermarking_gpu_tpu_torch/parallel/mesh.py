"""Device meshes and sharded values, driven from one process.

Counterpart of the JAX package's ``parallel/mesh.py``. There a mesh is a
``jax.sharding.Mesh`` and ``shard_map`` runs the per-shard program on every
device from one controller. Here a ``Mesh`` is a (data, space) grid of
``torch.device``s and the per-shard program is a Python loop over the grid,
which queues its work on each shard's device without waiting for it:

* ``data`` axis: frame-parallel (DP), independent frames (or candidates)
  on each data row, no collectives (``parallel.data_parallel``);
* ``space`` axis: spatial parallelism (SP), one frame's rows over a space
  row, halo rows and scalar reductions moved between the shards' tensors
  by ``parallel.collectives``.

A grid may name one device more than once (several shards of one card, as
the JAX package's tests use virtual CPU devices); only the caller's device
list can do that, ``devices=None`` names every visible CUDA device once.
``Sharded`` is a value split over a mesh: one tensor per mesh position and
the spec that says which dims are split over which axis.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

DATA_AXIS = "data"
SPACE_AXIS = "space"
AXES = (DATA_AXIS, SPACE_AXIS)


class Mesh:
    """A (data, space) grid of devices: ``devices[i][j]`` holds the shard
    at data index i and space index j; ``shape`` maps each axis name to its
    size (``mesh.shape["data"]``)."""

    def __init__(self, devices: list[list[torch.device]]):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        if not self.devices or not self.devices[0] or any(
                len(row) != len(self.devices[0]) for row in self.devices):
            raise ValueError("a mesh needs a non-empty rectangular grid")
        self.shape = {DATA_AXIS: len(self.devices),
                      SPACE_AXIS: len(self.devices[0])}

    def __repr__(self) -> str:
        names = [[str(d) for d in row] for row in self.devices]
        return f"Mesh(data={self.shape[DATA_AXIS]}, " \
               f"space={self.shape[SPACE_AXIS]}, devices={names})"


def make_mesh(data: int | None = None, space: int = 1,
              devices=None) -> Mesh:
    """Create a (data, space) mesh over ``devices`` (every visible CUDA
    device when None), data-major. ``data`` defaults to the devices that
    fill whole space rows. Raises where ``data * space`` exceeds the
    devices given."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if data is None:
        data = n // space
    if data < 1 or space < 1 or data * space > n:
        raise ValueError(f"mesh {data}x{space} needs more than {n} devices")
    return Mesh([devices[i * space:(i + 1) * space] for i in range(data)])


@dataclass
class Sharded:
    """A value split over a mesh.

    ``spec`` names, per dim of the whole value, the mesh axis it is split
    over (``DATA_AXIS``, ``SPACE_AXIS``) or None (not split); an axis the
    spec does not name holds copies. ``shards[i][j]`` is the block at mesh
    position (i, j), on ``mesh.devices[i][j]``.
    """

    mesh: Mesh
    spec: tuple
    shards: list[list[torch.Tensor]]

    def row(self, i: int) -> list[torch.Tensor]:
        """The blocks of data index i along the space axis."""
        return self.shards[i]

    def gather(self, device=None) -> torch.Tensor:
        """The whole value on ``device`` (the mesh's first device when
        None): blocks joined along their split dims, one copy of each."""
        device = torch.device(device) if device is not None else \
            self.mesh.devices[0][0]
        data_dim = _dim_of(self.spec, DATA_AXIS)
        space_dim = _dim_of(self.spec, SPACE_AXIS)
        n_data = self.mesh.shape[DATA_AXIS] if data_dim is not None else 1
        n_space = self.mesh.shape[SPACE_AXIS] if space_dim is not None else 1
        rows = []
        for i in range(n_data):
            blocks = [self.shards[i][j].to(device) for j in range(n_space)]
            rows.append(torch.cat(blocks, dim=space_dim)
                        if space_dim is not None else blocks[0])
        return (torch.cat(rows, dim=data_dim) if data_dim is not None
                else rows[0])

    def __array__(self, dtype=None, copy=None):
        array = self.gather("cpu").numpy()
        return array if dtype is None else array.astype(dtype)

    def __float__(self) -> float:
        return float(self.gather("cpu"))


def _padded(spec: tuple, ndim: int) -> tuple:
    """``spec`` with None for the dims it leaves out."""
    return tuple(spec) + (None,) * (ndim - len(spec))


def _dim_of(spec: tuple, axis: str) -> int | None:
    return spec.index(axis) if axis in spec else None


def shard(mesh: Mesh, value, spec: tuple) -> Sharded:
    """Place ``value`` (a tensor or array) on ``mesh`` split as ``spec``
    says: a split dim must divide by its axis' size. A ``Sharded`` of the
    same spec is returned as it is; of another spec it is gathered and
    split again."""
    if isinstance(value, Sharded):
        ndim = value.shards[0][0].ndim
        if value.mesh is mesh and value.spec == _padded(spec, ndim):
            return value
        value = value.gather()
    tensor = (value if isinstance(value, torch.Tensor)
              else torch.from_numpy(np.ascontiguousarray(value)))
    spec = _padded(spec, tensor.ndim)
    pieces = {}
    for axis in AXES:
        dim = _dim_of(spec, axis)
        size = mesh.shape[axis]
        if dim is not None and tensor.shape[dim] % size:
            raise ValueError(f"dim {dim} of {tuple(tensor.shape)} does not "
                             f"divide over the mesh {axis} axis ({size})")
        pieces[axis] = dim
    shards = []
    for i in range(mesh.shape[DATA_AXIS]):
        row = []
        for j in range(mesh.shape[SPACE_AXIS]):
            block = tensor
            for axis, index in ((DATA_AXIS, i), (SPACE_AXIS, j)):
                dim = pieces[axis]
                if dim is not None:
                    block = block.chunk(mesh.shape[axis], dim=dim)[index]
            row.append(block.contiguous().to(mesh.devices[i][j],
                                             non_blocking=True))
        shards.append(row)
    return Sharded(mesh, spec, shards)


def per_position(mesh: Mesh, fn) -> list[list]:
    """[[fn(i, j) for each space index j] for each data index i]."""
    return [[fn(i, j) for j in range(mesh.shape[SPACE_AXIS])]
            for i in range(mesh.shape[DATA_AXIS])]
