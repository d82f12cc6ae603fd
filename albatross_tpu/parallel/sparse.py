"""Mesh-distributed sparse GP (FITC/PITC) — scalable-N past one chip.

SURVEY.md §2 names "blockwise = PITC groups sharded across chips" as a
first-class decomposition; the reference's scalable-N workhorse is the
sparse fit (sparse_gp.hpp:377-404) whose tall QR runs on SuiteSparse SPQR's
internal threading (spqr_utils.hpp:102-116).  The design here:

* K_fu assembly is row-sharded over the data axis (each device builds its
  own (n/D, m) panel — parallel/gram.py sharded_cross_gram);
* the FITC residual diagonal / PITC residual blocks live sharded over the
  same axis (A is (block-)diagonal, so all its solves are local);
* B = [A^{-1/2} K_fu; K_uuᵀ/²] is factorized by a TSQR: one local
  Householder QR per device plus one (D·m, m) reduction QR of the stacked
  R factors — communication is a single all-gather of m×m blocks, and no
  device ever sees more than (n/D + (D+1)·m) rows;
* v = R⁻¹ Q₁ᵀ y_aug is recovered without materializing Q via the identity
  Q₁ᵀ y = R⁻ᵀ (Bᵀ y)  (exact for full-column-rank B), where Bᵀ y_aug is a
  psum of local (m,) products.

The m×m results (R, K_uu factor, v) replicate — predictions are O(m)-state
and run anywhere, identical to the single-chip SparseGPFit.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..core.dataset import RegressionDataset
from ..models.sparse_gp import (
    SparseGaussianProcessRegression,
    SparseGPFit,
    _numerical_rank,
    SPARSE_R_NUGGET,
)
from .gram import sharded_cross_gram

LOG_2PI = math.log(2.0 * math.pi)


def distributed_tall_qr(B, mesh: Mesh, axis: str = "data", extra=None):
    """R factor of qr([B; extra]) with B row-sharded — TSQR.

    B is (n, m) with n divisible by the mesh axis size D and n/D ≥ m;
    ``extra`` (k, m) rows are folded into the reduction stage (used for the
    K_uuᵀ/² tail of the sparse-GP B, which would otherwise break row
    divisibility).  Returns R (m, m) upper-triangular, sign-canonicalized
    to a non-negative diagonal, replicated on every device.
    """
    D = mesh.shape[axis]
    n, m = B.shape
    if n % D != 0:
        raise ValueError(f"N={n} not divisible by mesh axis size {D}")
    if n // D < m:
        raise ValueError(
            f"TSQR needs n/D >= m rows per device (got {n // D} < {m})"
        )

    def local(B_local):
        return jnp.linalg.qr(B_local, mode="r")  # (m, m) per device

    # out_specs concatenates the per-device R factors into the (D·m, m)
    # reduction stack — no explicit collective needed
    fn = jax.shard_map(
        local, mesh=mesh, in_specs=P(axis, None), out_specs=P(axis, None)
    )
    stack = fn(B)
    if extra is not None:
        stack = jnp.concatenate([stack, extra], axis=0)
    R = jnp.linalg.qr(stack, mode="r")
    # canonicalize: Householder sign freedom flips rows; a non-negative
    # diagonal makes the factor unique (matches single-chip up to roundoff)
    sign = jnp.where(jnp.diagonal(R) < 0, -1.0, 1.0)
    return R * sign[:, None]


class DistributedSparseGaussianProcessRegression(
    SparseGaussianProcessRegression
):
    """Sparse GP whose fit-time linear algebra is mesh-distributed.

    Prediction math is inherited (SparseGPFit state is O(m), replicated).
    The grouper's reordering must keep N divisible by the mesh axis.
    """

    def __init__(self, covariance, mesh: Mesh, axis: str = "data", **kw):
        super().__init__(covariance, **kw)
        self.mesh = mesh
        self.axis = axis

    # sharded K_fu assembly (row panels per device); non-divisible N falls
    # back to the dense single-device assembly
    def _cross_covariance(self, measurements, inducing_features):
        n = jax.tree_util.tree_leaves(measurements)[0].shape[0]
        if n % self.mesh.shape[self.axis] != 0:
            return super()._cross_covariance(measurements, inducing_features)
        return sharded_cross_gram(
            self.covariance_function,
            measurements,
            inducing_features,
            self.mesh,
            self.axis,
        )

    def _shard_rows(self, arr):
        """Best-effort row sharding for the residual-A pipeline outputs."""
        D = self.mesh.shape[self.axis]
        if arr.shape[0] % D != 0:
            return arr
        return jax.lax.with_sharding_constraint(
            arr, NamedSharding(self.mesh, P(self.axis))
        )

    # -- fit: TSQR instead of the single tall QR ------------------------------
    def _fit_impl(self, features, targets) -> SparseGPFit:
        u = self.inducing_point_strategy(self.covariance_function, features)
        A_chol, K_uu_chol, K_fu, y, _ = self._compute_internal_components(
            u, features, targets
        )
        m = K_uu_chol.L.shape[0]
        Phi = A_chol.sqrt_solve(K_fu)  # (n, m), rows stay sharded
        Phi = self._shard_rows(Phi)
        y_t = A_chol.sqrt_solve(y)  # (n,), sharded
        R = distributed_tall_qr(
            Phi, self.mesh, self.axis, extra=K_uu_chol.L.T
        )
        rank_arr = _numerical_rank(R, Phi.shape[0] + m)
        R = R + jnp.where(rank_arr < m, SPARSE_R_NUGGET, 0.0) * jnp.eye(
            m, dtype=R.dtype
        )
        rank = -1 if isinstance(rank_arr, jax.core.Tracer) else int(rank_arr)
        # v = R⁻¹ Q₁ᵀ y_aug = R⁻¹ R⁻ᵀ (Bᵀ y_aug); the L_uuᵀ tail multiplies
        # y_aug's zero block, so Bᵀ y_aug = Φᵀ ỹ (one psum under the hood)
        bty = Phi.T @ y_t
        from jax.scipy.linalg import solve_triangular

        v = solve_triangular(
            R, solve_triangular(R.T, bty, lower=True), lower=False
        )
        return SparseGPFit(u, K_uu_chol, R, v, rank)

    # -- NLML: determinant lemma with sharded pieces --------------------------
    def log_likelihood(self, dataset: RegressionDataset):
        u = self.inducing_point_strategy(
            self.covariance_function, dataset.features
        )
        A_chol, K_uu_chol, K_fu, y, _ = self._compute_internal_components(
            u, dataset.features, dataset.targets
        )
        Phi = self._shard_rows(A_chol.sqrt_solve(K_fu))
        R = distributed_tall_qr(
            Phi, self.mesh, self.axis, extra=K_uu_chol.L.T
        )
        log_det_a = A_chol.log_determinant()
        from ..ops.compensated import accurate_sum_of_logs

        log_det_r = accurate_sum_of_logs(jnp.abs(jnp.diagonal(R)))
        log_det = log_det_a + 2.0 * log_det_r - K_uu_chol.log_determinant()

        y_a = A_chol.solve(y)
        from jax.scipy.linalg import solve_triangular

        y_b = solve_triangular(R.T, K_fu.T @ y_a, lower=True)
        log_quadratic = jnp.sum(y * y_a) - jnp.sum(y_b * y_b)
        n = y.shape[0]
        return (
            -0.5 * (log_det + log_quadratic + n * LOG_2PI)
            + self.prior_log_likelihood()
        )


def distributed_sparse_gp_from_covariance(
    covariance, mesh: Mesh, axis: str = "data", **kw
) -> DistributedSparseGaussianProcessRegression:
    return DistributedSparseGaussianProcessRegression(
        covariance, mesh, axis, **kw
    )
