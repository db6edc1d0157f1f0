"""Device mesh construction and multi-host runtime initialization.

No reference counterpart (SURVEY.md §2b "Distributed runtime" row; the
reference is single-process pure Julia). Design per SURVEY.md §5:
`jax.distributed.initialize` for the multi-host runtime, a 1–2D
`jax.sharding.Mesh` over the devices, and a flattened ``chains`` (or
``batch``) axis for sampling and training workloads (chains, particles and
batch rows are embarrassingly parallel; params replicate). The cards of
one GPU host are joined all to all by NVLink, so the mesh shape follows
the algorithm alone: one axis for data parallelism, a second only where a
program shards two things at once (e.g. hosts x chains).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize the multi-host JAX runtime (no-op if single-process).

    Pass ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` explicitly; environments that export
    ``JAX_COORDINATOR_ADDRESS`` are picked up as well.

    NOTE the already-initialized guard must NOT touch the backend:
    ``jax.process_count()`` here would initialize XLA and make the
    subsequent ``jax.distributed.initialize`` raise — found the first time
    this path ran in real multiple processes (tests/test_multiprocess.py).
    """
    if jax.distributed.is_initialized():
        return  # already initialized
    env_says_multi = any(k in os.environ for k in
                         ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS"))
    if coordinator_address or num_processes or env_says_multi:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)


def make_mesh(axes: Optional[dict[str, int]] = None,
              devices: Optional[Sequence[jax.Device]] = None,
              axis_name: str = "chains") -> Mesh:
    """Build a mesh. Default: every device on one flattened ``chains`` axis.

    ``axes``: ordered {name: size} with total == device count; e.g.
    {"hosts": 2, "chains": 4} puts the host axis outermost so the inner
    ``chains`` collectives stay within a host.
    """
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices)
    if axes is None:
        axes = {axis_name: devices.size}
    sizes = tuple(axes.values())
    if int(np.prod(sizes)) != devices.size:
        raise ValueError(
            f"mesh axes {axes} do not cover {devices.size} devices")
    return Mesh(devices.reshape(sizes), tuple(axes.keys()))


def chains_sharding(mesh: Mesh, axis: str = "chains") -> NamedSharding:
    """Sharding for (chains, ...) arrays: leading axis split over ``axis``."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_chains(x, mesh: Mesh, axis: str = "chains"):
    """Place a (chains, ...) pytree with the leading axis sharded."""
    sh = chains_sharding(mesh, axis)
    return jax.tree.map(lambda a: jax.device_put(a, sh), x)
