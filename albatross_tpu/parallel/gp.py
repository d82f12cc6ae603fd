"""Mesh-distributed exact GP: fit / predict / NLML past one device.

Exact GP at N where the N×N covariance does not fit one device, and never
exists on one.  The pipeline is

    sharded Gram (gram.py)  →  distributed blocked Cholesky (cholesky.py)
    →  panel-substitution solves  →  predictions / NLML

with collectives over the device interconnect.  ``DistributedCholesky``
exposes the same
capability surface as the dense ``CholeskyFactor`` so the single-chip and
multi-chip paths share prediction code.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ..core.dataset import RegressionDataset
from ..core.distributions import MarginalDistribution
from ..kernels.features import as_measurement
from ..models.gp import GaussianProcess, GPFit
from .cholesky import (
    distributed_cholesky,
    distributed_inverse_diagonal,
    distributed_log_determinant,
    distributed_solve,
    distributed_sqrt_solve,
)
from .cholesky2d import (
    distributed_cholesky_2d,
    distributed_inverse_blocks_2d,
    distributed_inverse_diagonal_2d,
    distributed_log_determinant_2d,
    distributed_solve_2d,
    distributed_sqrt_solve_2d,
)
from .gram import sharded_gram, sharded_gram_2d

LOG_2PI = math.log(2.0 * math.pi)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DistributedCholesky:
    """Row-sharded Cholesky factor bound to its mesh."""

    L: jax.Array  # (N, N), row-sharded over `axis`
    mesh: Mesh
    axis: str = "data"

    def tree_flatten(self):
        return (self.L,), (self.mesh, self.axis)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1])

    def solve(self, rhs):
        return distributed_solve(self.L, rhs, self.mesh, self.axis)

    def sqrt_solve(self, rhs):
        return distributed_sqrt_solve(self.L, rhs, self.mesh, self.axis)

    def log_determinant(self):
        return distributed_log_determinant(self.L, self.mesh, self.axis)

    def inverse_diagonal(self):
        return distributed_inverse_diagonal(self.L, self.mesh, self.axis)

    def inverse_blocks(self, indices_groups):
        from .cholesky import distributed_inverse_blocks

        return distributed_inverse_blocks(
            self.L, indices_groups, self.mesh, self.axis
        )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DistributedCholesky2D:
    """Tile-sharded (2-D mesh) Cholesky factor bound to its mesh.

    Per-device bytes for the factor are N²/(R·C) — the layout for N past
    one device
    (SURVEY.md §2 checklist: 2-D block sharding / TP analog)."""

    L: jax.Array  # (N, N), tile-sharded over (row_axis, col_axis)
    mesh: Mesh
    row_axis: str = "data"
    col_axis: str = "model"

    def tree_flatten(self):
        return (self.L,), (self.mesh, self.row_axis, self.col_axis)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1], aux[2])

    def solve(self, rhs):
        return distributed_solve_2d(
            self.L, rhs, self.mesh, self.row_axis, self.col_axis
        )

    def sqrt_solve(self, rhs):
        return distributed_sqrt_solve_2d(
            self.L, rhs, self.mesh, self.row_axis, self.col_axis
        )

    def log_determinant(self):
        return distributed_log_determinant_2d(
            self.L, self.mesh, self.row_axis, self.col_axis
        )

    def inverse_diagonal(self):
        return distributed_inverse_diagonal_2d(
            self.L, self.mesh, self.row_axis, self.col_axis
        )

    def inverse_blocks(self, indices_groups):
        return distributed_inverse_blocks_2d(
            self.L, indices_groups, self.mesh, self.row_axis, self.col_axis
        )


class DistributedGaussianProcess(GaussianProcess):
    """Exact GP whose fit-time linear algebra is mesh-distributed.

    Prediction math is inherited — it only calls ``solve`` on the fit's
    covariance representation, which dispatches to the distributed factor.
    """

    def __init__(
        self,
        covariance,
        mesh: Mesh,
        mean=None,
        axis: str = "data",
        col_axis: Optional[str] = None,
        panel: Optional[int] = None,
        **kw,
    ):
        super().__init__(covariance, mean, **kw)
        self.mesh = mesh
        self.axis = axis
        # col_axis selects the 2-D tile-sharded layout (N²/(R·C) bytes per
        # device); default (None) keeps the 1-D row-panel layout.
        self.col_axis = col_axis
        # panel width for the 2-D factorization: the per-device transient is
        # O(N·panel), so capping it trades collective rounds for memory
        # (None = cholesky2d._default_panel, up to the tile width).
        self.panel = panel

    def _sharded_factorize(self, features, target_variance):
        """Gram + Cholesky in the mesh layout this model was built with."""
        if self.col_axis is None:
            K = sharded_gram(
                self.covariance_function,
                features,
                self.mesh,
                self.axis,
                measurement=True,
                target_variance=target_variance,
                jitter=self.jitter,
            )
            L = distributed_cholesky(K, self.mesh, self.axis)
            return DistributedCholesky(L, self.mesh, self.axis)
        K = sharded_gram_2d(
            self.covariance_function,
            features,
            self.mesh,
            self.axis,
            self.col_axis,
            measurement=True,
            target_variance=target_variance,
            jitter=self.jitter,
        )
        L = distributed_cholesky_2d(
            K, self.mesh, self.axis, self.col_axis, panel=self.panel
        )
        return DistributedCholesky2D(L, self.mesh, self.axis, self.col_axis)

    def _fit_impl(self, features, targets: MarginalDistribution) -> GPFit:
        chol = self._sharded_factorize(features, targets.variance)
        zero_mean = self.mean_function.remove_from(
            as_measurement(features), targets.mean
        )
        information = chol.solve(zero_mean)
        return GPFit(features, chol, information)

    def log_likelihood(self, dataset: RegressionDataset):
        measurements = as_measurement(dataset.features)
        zero_mean = self.mean_function.remove_from(
            measurements, dataset.targets.mean
        )
        chol = self._sharded_factorize(dataset.features, None)
        white = chol.sqrt_solve(zero_mean)
        n = zero_mean.shape[0]
        nll = 0.5 * (
            chol.log_determinant() + jnp.sum(white * white) + n * LOG_2PI
        )
        return -nll + self.prior_log_likelihood()


def distributed_gp_from_covariance(
    covariance, mesh: Mesh, mean=None, **kwargs
) -> DistributedGaussianProcess:
    return DistributedGaussianProcess(covariance, mesh, mean, **kwargs)
