"""Device mesh helpers.

JAX-native replacement for the reference's MPI world / machine.conf
cluster model (reference: src/aslp-parallel/mpi-node.h:18 MpiNode,
aslp_scripts/machine.conf): a named `jax.sharding.Mesh` over all chips,
with 'data' as the batch axis.  Multi-host initialization goes through
jax.distributed (one process per host) instead of mpirun."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    axis_names: Sequence[str] = ("data",),
    shape: Optional[Sequence[int]] = None,
    devices=None,
) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, tuple(axis_names))


def data_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Batch-dim sharding for input arrays."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def num_hosts() -> int:
    return jax.process_count()


def host_index() -> int:
    return jax.process_index()


def is_main_host() -> bool:
    """Equivalent of MpiNode::IsMainNode (rank 0 writes models)."""
    return jax.process_index() == 0


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (replaces MPI_Init).  No-op single-host."""
    if num_processes and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
