"""Multi-host orchestration helpers.

The reference has no distributed backend at all (SURVEY.md §2.12); multi-host
scale is a new first-class capability here: jax.distributed for cross-host
process groups, with the mesh layer (mesh.py) spanning all hosts' devices
so the collectives in cholesky.py/gram.py run over the interconnect within
a host and the network across hosts.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed (no-op for single-process runs).

    Pass the arguments explicitly (coordinator ``host:port``, process
    count, this process's id) unless the environment describes the
    cluster to JAX; without either this is a single-process no-op.
    """
    if jax.process_count() > 1:
        return  # already initialized
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (ValueError, RuntimeError):
        # single-process environment — nothing to join
        pass


def global_mesh(axis_names: Sequence[str] = ("data",), shape=None):
    """Mesh over every device of every host (call after
    initialize_multihost)."""
    from .mesh import make_mesh

    return make_mesh(len(jax.devices()), axis_names, shape)


def process_local_batch(global_batch_size: int) -> int:
    """Rows this host contributes to a globally sharded batch."""
    count = jax.process_count()
    if global_batch_size % count != 0:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"{count} processes"
        )
    return global_batch_size // count
