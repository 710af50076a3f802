"""Multi-process plate execution over `torch.distributed`.

Counterpart of `arcadia_microscopy_tools_tpu/parallel/multiprocess.py`. The
JAX module initialises `jax.distributed`, builds global arrays from
process-local data and gathers results with `multihost_utils`. In torch
every process is one rank with one device: `initialize_distributed` starts
the default process group, and `run_plate_multiprocess` is `PlateRunner`
on a multi-host mesh of all ranks, whose runner already decodes each rank's
block of every batch locally and all-gathers the small packed per-cell
results.
"""

from __future__ import annotations

import socket
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize_distributed", "run_plate_multiprocess"]


def initialize_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_count: int | None = None,
    backend: str | None = None,
) -> None:
    """Start this process's rank of the default process group.

    Args:
        coordinator_address: "host:port" of rank 0's store (a TCP store,
            as `jax.distributed`'s coordinator), or a full init method such
            as "file:///shared/path" or "tcp://host:port".
        num_processes: ranks in the group.
        process_id: this rank; ranks are numbered host by host.
        local_device_count: ranks on this host (None: all of them); rank r
            drives card r % local_device_count.
        backend: None picks "cpu:gloo,cuda:nccl" (CPU tensors over gloo,
            card tensors over NCCL) when every rank of the host has its own
            card, else "gloo", which also runs on card tensors, so several
            ranks can share one card. NCCL refuses ranks that share a card:
            asking for it then raises ValueError.

    Raises:
        RuntimeError: a process group is already initialised.
    """
    if dist.is_initialized():
        raise RuntimeError(
            "initialize_distributed: this process already belongs to a process group; call it "
            "once, before any other distributed call"
        )
    local = local_device_count or num_processes
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if cards >= local else "gloo"
    elif "nccl" in backend and cards < local:
        raise ValueError(
            f"backend {backend!r} needs a card per rank, but {local} ranks on this host share "
            f"{cards} card(s); pass backend='gloo' to let ranks share a card"
        )
    if "nccl" in backend:
        torch.cuda.set_device(process_id % local)
    init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes, rank=process_id
    )


def _host_count() -> int:
    """Distinct hosts among the ranks of the default group."""
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return len(set(names))


def run_plate_multiprocess(
    layout: Any,
    image_source: Mapping[str, np.ndarray] | Callable[[str], np.ndarray],
    config: Any = None,
    channels: list | None = None,
    unet_params: Any = None,
    space_parallelism: int = 1,
    *,
    device: str | torch.device | None = None,
):
    """Process every well of `layout` across all ranks of the default
    process group (`initialize_distributed` first).

    Every rank calls this with the SAME layout and config (the SPMD
    contract). Batches of `config.batch_size` wells (None: 8 per rank along
    the hosts x wells axes) are split into contiguous blocks, one per rank,
    and each rank decodes only its block (the ranks of a space group the
    same block, each staging its rows). Image shapes need no agreement
    across ranks: a rank runs each shape as its own dispatch; the ranks of
    a space group agree on each well's shape, and a well that any of them
    failed to decode fails. Failure isolation and capacity escalation are
    `PlateRunner.run`'s; results are all-gathered, so every rank returns
    the full `PlateResults`. Checkpoint/resume is not wired here, as in the
    JAX function: run one `PlateRunner(checkpoint_dir=...)` for a resumable
    plate. `device` None is the rank's card.
    """
    from .mesh import MeshConfig, create_multihost_mesh
    from .plate import PlateRunConfig, PlateRunner

    if not dist.is_initialized():
        raise RuntimeError("run_plate_multiprocess needs initialize_distributed first")
    mesh = create_multihost_mesh(_host_count(), MeshConfig(space_parallelism=space_parallelism))
    runner = PlateRunner(
        config or PlateRunConfig(), mesh=mesh, unet_params=unet_params, device=device
    )
    return runner.run(layout, image_source, channels)
