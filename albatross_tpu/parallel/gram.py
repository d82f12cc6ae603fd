"""Mesh-sharded Gram assembly.

Replaces the reference's ThreadPool-tiled Gram construction
(/root/reference/include/albatross/src/covariance_functions/callers.hpp:66-166)
with a shard_map: each device computes the row panel

    K[d·b:(d+1)·b, :] = k(X_local, X_full)

entirely locally (features are small; the N×N Gram is what must be sharded),
so the output covariance never materializes on any single device.  Target
variance and Measurement semantics are applied per-panel.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from ..kernels.base import CovarianceFunction
from ..kernels.features import Measurement


def _add_diagonal(block, variance_rows, jitter, row0, col0):
    """block + (variance + jitter) on the global diagonal, where the block
    starts at global (row0, col0); fused into the block's own write."""
    if variance_rows is None and not jitter:
        return block
    diag = jitter if variance_rows is None else variance_rows[:, None] + jitter
    rows = jax.lax.broadcasted_iota(jnp.int32, block.shape, 0) + row0
    cols = jax.lax.broadcasted_iota(jnp.int32, block.shape, 1) + col0
    return block + jnp.where(rows == cols, diag, 0.0)


def _gram_panel(kernel, X_local, X_full, variance_local, *, measurement, jitter, b, axis):
    Xl = Measurement(X_local) if measurement else X_local
    Xf = Measurement(X_full) if measurement else X_full
    panel = kernel.matrix_or_none(Xl, Xf)
    if panel is None:
        raise TypeError("covariance undefined for these features")
    return _add_diagonal(
        panel, variance_local, jitter, jax.lax.axis_index(axis) * b, 0
    )


def sharded_gram(
    kernel: CovarianceFunction,
    X,
    mesh: Mesh,
    axis: str = "data",
    measurement: bool = False,
    target_variance: Optional[jnp.ndarray] = None,
    jitter: float = 0.0,
):
    """Row-sharded (N, N) Gram matrix of a feature batch.

    N must divide the mesh axis size.  ``measurement=True`` applies the
    Measurement tag to both sides (training covariance semantics);
    ``target_variance`` and ``jitter`` are added to the diagonal.
    """
    n = jax.tree_util.tree_leaves(X)[0].shape[0]
    G = mesh.shape[axis]
    if n % G != 0:
        raise ValueError(f"N={n} not divisible by mesh axis size {G}")
    b = n // G

    var_spec = P(axis) if target_variance is not None else None
    in_specs = (P(), P(axis), P(), var_spec)
    fn = jax.shard_map(
        functools.partial(
            _gram_panel, measurement=measurement, jitter=jitter, b=b, axis=axis
        ),
        mesh=mesh,
        in_specs=in_specs,
        out_specs=P(axis, None),
    )
    return fn(kernel, X, X, target_variance)


def _gram_tile(
    kernel, X_rows, X_cols, variance_rows, *, measurement, jitter, br, bc,
    row_axis, col_axis,
):
    Xr = Measurement(X_rows) if measurement else X_rows
    Xc = Measurement(X_cols) if measurement else X_cols
    tile = kernel.matrix_or_none(Xr, Xc)
    if tile is None:
        raise TypeError("covariance undefined for these features")
    return _add_diagonal(
        tile, variance_rows, jitter,
        jax.lax.axis_index(row_axis) * br, jax.lax.axis_index(col_axis) * bc,
    )


def sharded_gram_2d(
    kernel: CovarianceFunction,
    X,
    mesh: Mesh,
    row_axis: str = "data",
    col_axis: str = "model",
    measurement: bool = False,
    target_variance: Optional[jnp.ndarray] = None,
    jitter: float = 0.0,
):
    """(N, N) Gram matrix block-sharded over a 2-D mesh — the TP-analog
    decomposition (SURVEY.md §2 checklist): device (i, j) computes and owns
    only its (N/R, N/C) tile, so per-device Gram memory scales as N²/(R·C)
    instead of N²/R.  Features replicate (they are O(N·D), tiny next to K).
    ``target_variance`` and ``jitter`` are added to the diagonal inside the
    tile's own write, so no second N×N array exists."""
    n = jax.tree_util.tree_leaves(X)[0].shape[0]
    R, C = mesh.shape[row_axis], mesh.shape[col_axis]
    if n % R != 0 or n % C != 0:
        raise ValueError(f"N={n} not divisible by mesh axes ({R}, {C})")
    br, bc = n // R, n // C

    var_spec = P(row_axis) if target_variance is not None else None
    fn = jax.shard_map(
        functools.partial(
            _gram_tile,
            measurement=measurement,
            jitter=jitter,
            br=br,
            bc=bc,
            row_axis=row_axis,
            col_axis=col_axis,
        ),
        mesh=mesh,
        in_specs=(P(), P(row_axis), P(col_axis), var_spec),
        out_specs=P(row_axis, col_axis),
    )
    return fn(kernel, X, X, target_variance)


def sharded_cross_gram(
    kernel: CovarianceFunction,
    X_train,
    X_test,
    mesh: Mesh,
    axis: str = "data",
):
    """(N_train, M) cross-covariance, row-sharded over the train axis."""

    def panel(k, Xl, Xt):
        out = k.matrix_or_none(Xl, Xt)
        if out is None:
            raise TypeError("covariance undefined for these features")
        return out

    fn = jax.shard_map(
        panel,
        mesh=mesh,
        in_specs=(P(), P(axis), P()),
        out_specs=P(axis, None),
    )
    return fn(kernel, X_train, X_test)
