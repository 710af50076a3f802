"""Plate-scale execution on one device or on a mesh of ranks: mesh
construction (parallel/mesh.py), collectives over `torch.distributed`
(parallel/collectives.py), the plate runner (parallel/plate.py) and
multi-process runs (parallel/multiprocess.py, not imported here)."""

from .collectives import (
    halo_exchange,
    sharded_gaussian_filter,
    sharded_histogram_uint16,
    sharded_otsu_threshold,
)
from .mesh import MeshConfig, create_mesh, replicated, well_sharding
from .plate import PlateResults, PlateRunConfig, PlateRunner

__all__ = [
    "MeshConfig",
    "PlateResults",
    "PlateRunConfig",
    "PlateRunner",
    "create_mesh",
    "halo_exchange",
    "replicated",
    "sharded_gaussian_filter",
    "sharded_histogram_uint16",
    "sharded_otsu_threshold",
    "well_sharding",
]
