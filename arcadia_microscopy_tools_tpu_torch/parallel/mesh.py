"""Device mesh construction and sharding helpers over `torch.distributed`.

Counterpart of `arcadia_microscopy_tools_tpu/parallel/mesh.py`. HCS plates
are embarrassingly parallel across wells, so the primary axis is data
parallelism ("wells"); a second optional axis ("space") shards the rows of
each image, with halo exchange and cross-shard merges in
`parallel.collectives` and `parallel.plate`; a multi-host mesh adds an
outermost "hosts" axis.

Where torch differs from JAX: one JAX process sees every device, while the
torch idiom is one process (rank) per device. A mesh here is therefore a
grid over the ranks of the default process group, `hosts` outermost and
`space` innermost, holding one process subgroup per axis for this rank.
`torch.distributed.device_mesh.init_device_mesh` builds the same grid, but
for "cuda" it binds each rank to the card of its local rank and expects
NCCL, which refuses two ranks on one card; the grid is simple enough to
build here over whatever backend the group was initialised with
(`parallel.multiprocess.initialize_distributed`). With no process group
initialised, `create_mesh()` is the 1 x 1 mesh of the current process.

The sharding helpers return what a rank owns (`Shard`): its contiguous
block of a batch of wells and, when spatial, its contiguous block of image
rows, in place of JAX's `NamedSharding`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch.distributed as dist

__all__ = [
    "MeshConfig",
    "Mesh",
    "Shard",
    "create_mesh",
    "create_multihost_mesh",
    "well_sharding",
    "plate_sharding_multihost",
    "replicated",
    "row_bounds",
]

WELL_AXIS = "wells"
SPACE_AXIS = "space"
HOST_AXIS = "hosts"


def _world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass(frozen=True)
class MeshConfig:
    """Mesh configuration.

    Attributes:
        n_devices: Number of ranks to use (None = every rank of the default
            process group; a mesh spans all of them).
        space_parallelism: Ranks per image for spatial sharding (1 = each
            image lives on one rank; >1 shards the Y axis across ranks with
            halo exchange for stencil ops).
    """

    n_devices: int | None = None
    space_parallelism: int = 1

    def resolve_devices(self) -> list[int]:
        """The ranks of the mesh: every rank of the default group."""
        _, world = _world()
        n = self.n_devices if self.n_devices is not None else world
        if n > world:
            raise ValueError(f"Requested {n} devices but only {world} available")
        if n < world:
            raise ValueError(
                f"Requested {n} devices of a process group of {world} ranks; a mesh spans "
                "every rank of the default process group"
            )
        return list(range(n))


class Mesh:
    """A grid of ranks with named axes and this rank's place in it.

    Attributes:
        shape: axis name -> size, in axis order (outermost first).
        axis_names: the axis names in order.
        devices: the ranks as an array of the mesh's shape.
        coords: axis name -> this rank's index along the axis.
        rank: this rank in the default process group.
    """

    def __init__(self, ranks: np.ndarray, axis_names: tuple[str, ...]):
        self.devices = ranks
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        self.rank, world = _world()
        where = np.argwhere(ranks == self.rank)
        self.coords = dict(zip(self.axis_names, (int(i) for i in where[0])))
        self._groups = {}
        for k, axis in enumerate(self.axis_names):
            if world == 1 or ranks.shape[k] == 1:
                self._groups[axis] = None
                continue
            # every rank creates every group of the axis in the same order
            lines = np.moveaxis(ranks, k, -1).reshape(-1, ranks.shape[k])
            mine, _ = dist.new_subgroups_by_enumeration([[int(r) for r in line] for line in lines])
            self._groups[axis] = mine

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def group(self, axis: str):
        """This rank's process group along `axis` (None when the axis has
        one rank: nothing to communicate)."""
        return self._groups[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords})"


def create_mesh(config: MeshConfig | None = None) -> Mesh:
    """Build a (wells, space) mesh over the ranks of the default group."""
    config = config or MeshConfig()
    ranks = config.resolve_devices()
    n = len(ranks)
    sp = config.space_parallelism
    if n % sp != 0:
        raise ValueError(f"space_parallelism={sp} must divide device count {n}")
    return Mesh(np.array(ranks).reshape(n // sp, sp), (WELL_AXIS, SPACE_AXIS))


def create_multihost_mesh(n_hosts: int, config: MeshConfig | None = None) -> Mesh:
    """Build a (hosts, wells, space) mesh for multi-host plates.

    Ranks are numbered host by host (`initialize_distributed`'s process
    ids), so reshaping (n_hosts, per_host_wells, space) keeps every space
    group and every host's wells on one host and puts cross-host traffic on
    the outer axis only: the final all-gather of the small per-cell tables.
    """
    config = config or MeshConfig()
    ranks = config.resolve_devices()
    n = len(ranks)
    sp = config.space_parallelism
    if n % (n_hosts * sp) != 0:
        raise ValueError(
            f"n_hosts={n_hosts} x space_parallelism={sp} must divide device count {n}"
        )
    grid = np.array(ranks).reshape(n_hosts, n // (n_hosts * sp), sp)
    return Mesh(grid, (HOST_AXIS, WELL_AXIS, SPACE_AXIS))


def row_bounds(h: int, count: int, align: int = 1) -> tuple[int, ...]:
    """The row slabs of an image of `h` rows on `count` ranks, as
    (0, start of slab 1, ..., h): blocks of ceil(h / count) rows rounded up
    to a multiple of `align`, the last one shorter when h is not a multiple
    (a ragged last shard). Raises ValueError when a slab would hold no row."""
    per = -(-math.ceil(h / count) // align) * align
    if (count - 1) * per >= h:
        raise ValueError(
            f"space_parallelism={count} leaves a shard of an image of {h} rows without rows"
            + (f" (slabs start on multiples of {align} rows)" if align > 1 else "")
        )
    return (*range(0, count * per, per), h)


@dataclass(frozen=True)
class Shard:
    """What one rank owns of a (B, C, H, W) well batch: block `batch_index`
    of `batch_count` contiguous blocks of the batch and, along the rows,
    block `space_index` of `space_count`."""

    batch_index: int = 0
    batch_count: int = 1
    space_index: int = 0
    space_count: int = 1

    def batch_rows(self, b: int) -> slice:
        """This rank's wells of a batch of `b`: contiguous blocks of
        ceil(b / batch_count) (the last ones shorter or empty)."""
        per = math.ceil(b / self.batch_count)
        lo = min(b, self.batch_index * per)
        return slice(lo, min(b, lo + per))

    def image_rows(self, h: int) -> slice:
        """This rank's rows of an image of `h` rows: its slab of
        `row_bounds(h, space_count)`."""
        bounds = row_bounds(h, self.space_count)
        return slice(bounds[self.space_index], bounds[self.space_index + 1])


def _batch_shard(mesh: Mesh, axes: tuple[str, ...], spatial: bool) -> Shard:
    index, count = 0, 1
    for axis in axes:
        if axis in mesh.shape:
            index = index * mesh.shape[axis] + mesh.coords[axis]
            count *= mesh.shape[axis]
    if spatial:
        return Shard(index, count, mesh.coords[SPACE_AXIS], mesh.shape[SPACE_AXIS])
    return Shard(index, count)


def well_sharding(mesh: Mesh, *, spatial: bool = False) -> Shard:
    """A rank's share of a well batch: batch over the wells axis; when
    `spatial`, the image rows over the space axis as well."""
    return _batch_shard(mesh, (WELL_AXIS,), spatial)


def plate_sharding_multihost(mesh: Mesh, *, spatial: bool = False) -> Shard:
    """Batch over the combined (hosts, wells) axes of a multi-host mesh:
    each host takes a contiguous block of the plate batch and, within it,
    wells spread as in `well_sharding`."""
    return _batch_shard(mesh, (HOST_AXIS, WELL_AXIS), spatial)


def replicated(mesh: Mesh) -> Shard:
    """Every rank owns the whole batch (e.g. model weights on every rank)."""
    return Shard()

