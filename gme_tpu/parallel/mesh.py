"""Device-mesh construction and multi-host initialisation.

The reference has no distributed code at all (SURVEY.md §2.2); the
communication layer here is XLA collectives (psum / ppermute / all_gather)
over a `jax.sharding.Mesh`, which XLA hands to NCCL on GPUs — never a
hand-rolled transport.  The mesh follows the algorithm alone: the cards of
one host are joined all to all, so no axis order is preferred.

Mesh axes:
- "data": independent frame pairs / GOPs (embarrassingly parallel — the
  moral equivalent of DP);
- "space": row-bands of a single frame (the moral equivalent of
  sequence/context parallelism — the "sequence" is the pixel grid), with
  search-window halo exchange between neighbouring shards.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
SPACE_AXIS = "space"


def make_mesh(
    data: Optional[int] = None,
    space: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (data, space) mesh.  `data=None` uses all remaining devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data is None:
        if n % space:
            raise ValueError(f"{n} devices not divisible by space={space}")
        data = n // space
    if data * space > n:
        raise ValueError(f"mesh {data}x{space} needs {data * space} devices, have {n}")
    return jax.make_mesh((data, space), (DATA_AXIS, SPACE_AXIS),
                         devices=devices[: data * space])


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for a (B, H, W) frame-pair batch: B over "data"."""
    return NamedSharding(mesh, P(DATA_AXIS))


def batch_space_sharding(mesh: Mesh) -> NamedSharding:
    """(B, H, W) batch: B over "data", rows over "space"."""
    return NamedSharding(mesh, P(DATA_AXIS, SPACE_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Multi-process bring-up (jax.distributed): GOPs shard across
    processes.  No-op on a single process.

    `local_device_ids` restricts this process to those local cards.  With
    several processes on one host, give each its own card (process k ->
    ``[k]``): a JAX process reserves most of every card it opens, so
    processes that all open every card run out of memory.  Leave it None
    for one process per host that drives all of that host's cards."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
