"""Device-mesh helpers.

The capability-equivalent of the reference's ThreadPool knob
(/root/reference/include/albatross/src/core/model.hpp:30-36 — its only
parallelism) re-imagined for accelerators: a ``jax.sharding.Mesh`` over the
device interconnect is the
unit of scale, and every parallel decomposition in the framework (row-sharded
Gram assembly, distributed blocked Cholesky, fold/walker parallelism) is
expressed against named mesh axes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data",),
    shape: Optional[Sequence[int]] = None,
) -> Mesh:
    """Build a mesh over the first n devices.

    With one axis name the mesh is 1-D over all requested devices; pass
    ``shape`` for multi-axis meshes (e.g. shape=(4, 2),
    axis_names=('data', 'model')).
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if shape is None:
        if len(axis_names) == 1:
            shape = (n_devices,)
        else:
            raise ValueError("multi-axis mesh needs an explicit shape")
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"shape {shape} does not cover {len(devices)} devices")
    return Mesh(np.asarray(devices).reshape(shape), tuple(axis_names))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharded(mesh: Mesh, axis: str = "data") -> NamedSharding:
    return NamedSharding(mesh, P(axis, None))


def vector_sharded(mesh: Mesh, axis: str = "data") -> NamedSharding:
    return NamedSharding(mesh, P(axis))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
