"""Batched distance metrics.

JAX re-design of the reference distance metrics
(/root/reference/include/albatross/src/covariance_functions/distance_metrics.hpp:30-90).

The reference computes distances one scalar pair at a time; here each metric
produces the full pairwise matrix for feature *batches* in one shot.  Metrics
are immutable, hashable, parameter-free dataclasses — static metadata on
kernels.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

EPSILON = 1e-16  # acos clamping guard (distance_metrics.hpp:18)


def as_matrix(X) -> jnp.ndarray:
    """Coerce a feature batch to (N, D)."""
    X = jnp.asarray(X)
    if X.ndim == 1:
        return X[:, None]
    if X.ndim == 2:
        return X
    return X.reshape(X.shape[0], -1)


@dataclasses.dataclass(frozen=True)
class DistanceMetric:
    @property
    def name(self) -> str:
        raise NotImplementedError

    def pairwise(self, X, Y) -> jnp.ndarray:
        """(N, M) matrix of distances between feature batches."""
        raise NotImplementedError

    def diag(self, X) -> jnp.ndarray:
        """Distance of each feature to itself — zero for all our metrics."""
        X = as_matrix(X)
        return jnp.zeros(X.shape[0], dtype=X.dtype)


@jax.custom_vjp
def squared_distances(X, Y) -> jnp.ndarray:
    """Exact (N, M) squared distances Σ_k (x_ik − y_jk)² of (N, D) / (M, D)
    batches: per-pair differences, as the reference computes them
    (distance_metrics.hpp:30-45).  Bitwise symmetric and exactly zero on
    the diagonal when Y is X, with no cancellation at large coordinates.
    XLA fuses the broadcast, square and sum into one reduction, so no
    (N, M, D) array is stored."""
    diff = X[:, None, :] - Y[None, :, :]
    return jnp.sum(diff * diff, axis=-1)


def _squared_distances_fwd(X, Y):
    return squared_distances(X, Y), (X, Y)


def _squared_distances_bwd(residuals, g):
    # ∂/∂x_i Σ_j g_ij |x_i − y_j|² = 2 (x_i Σ_j g_ij − Σ_j g_ij y_j): two
    # GEMMs instead of an (N, M, D) product.  Shifting both batches by a
    # common centre leaves the result unchanged and keeps large
    # coordinates from cancelling in the difference.
    X, Y = residuals
    c = 0.5 * (jnp.mean(X, axis=0) + jnp.mean(Y, axis=0))
    Xc, Yc = X - c, Y - c
    hi = jax.lax.Precision.HIGHEST
    gX = 2.0 * (Xc * jnp.sum(g, axis=1)[:, None]
                - jnp.matmul(g, Yc, precision=hi))
    gY = 2.0 * (Yc * jnp.sum(g, axis=0)[:, None]
                - jnp.matmul(g.T, Xc, precision=hi))
    return gX, gY


squared_distances.defvjp(_squared_distances_fwd, _squared_distances_bwd)


@dataclasses.dataclass(frozen=True)
class EuclideanDistance(DistanceMetric):
    """|x - y| for scalars, ||x - y|| for vectors."""

    @property
    def name(self) -> str:
        return "euclidean_distance"

    def pairwise_squared(self, X, Y) -> jnp.ndarray:
        """Squared pairwise distances; no sqrt for kernels (like the squared
        exponential) that only need d²."""
        return squared_distances(as_matrix(X), as_matrix(Y))

    def pairwise(self, X, Y) -> jnp.ndarray:
        X, Y = as_matrix(X), as_matrix(Y)
        if X.shape[-1] == 1:
            # 1-D features: exact |x - y| (matches the reference's fabs path).
            return jnp.abs(X[:, 0][:, None] - Y[:, 0][None, :])
        return jnp.sqrt(self.pairwise_squared(X, Y))


@dataclasses.dataclass(frozen=True)
class RadialDistance(DistanceMetric):
    """| ||x|| - ||y|| | (distance_metrics.hpp:47-62)."""

    @property
    def name(self) -> str:
        return "radial_distance"

    def pairwise(self, X, Y) -> jnp.ndarray:
        X, Y = as_matrix(X), as_matrix(Y)
        nx = jnp.linalg.norm(X, axis=-1)
        ny = jnp.linalg.norm(Y, axis=-1)
        return jnp.abs(nx[:, None] - ny[None, :])


@dataclasses.dataclass(frozen=True)
class AngularDistance(DistanceMetric):
    """Great-circle angle via acos of normalized dot products, with the
    reference's special-casing near ±1 (distance_metrics.hpp:64-90)."""

    @property
    def name(self) -> str:
        return "angular_distance"

    def pairwise(self, X, Y) -> jnp.ndarray:
        X, Y = as_matrix(X), as_matrix(Y)
        nx = jnp.linalg.norm(X, axis=-1)
        ny = jnp.linalg.norm(Y, axis=-1)
        dots = jax.lax.dot(X, Y.T, precision=jax.lax.Precision.HIGHEST) / (
            nx[:, None] * ny[None, :]
        )
        angles = jnp.arccos(jnp.clip(dots, -1.0 + EPSILON, 1.0 - EPSILON))
        return jnp.where(
            dots > 1.0 - EPSILON,
            0.0,
            jnp.where(dots < -1.0 + EPSILON, math.pi, angles),
        )
