"""Gaussian distribution containers.

JAX re-design of the reference distribution types
(/root/reference/include/albatross/src/core/distribution.hpp:27-285 and
 transformed_distribution.hpp:30-123).

``MarginalDistribution`` holds a mean vector and *diagonal* covariance (as a
variance vector — never materialized as a matrix); ``JointDistribution`` holds
a mean and a dense covariance.  Both are registered pytrees so they pass
freely through jit/vmap/shard boundaries and can be sharded across a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp


def _as_array(x):
    x = jnp.asarray(x)
    return x.astype(jnp.result_type(x, float))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class MarginalDistribution:
    """Mean + independent (diagonal) variance (distribution.hpp:191-285)."""

    mean: jax.Array
    variance: Optional[jax.Array] = None  # None => zero variance

    def tree_flatten(self):
        return (self.mean, self.variance), None

    @classmethod
    def tree_unflatten(cls, _, children):
        return cls(*children)

    @classmethod
    def create(cls, mean, variance=None) -> "MarginalDistribution":
        mean = _as_array(mean)
        if variance is not None:
            variance = jnp.broadcast_to(_as_array(variance), mean.shape)
        return cls(mean, variance)

    @property
    def size(self) -> int:
        return self.mean.shape[0]

    def __len__(self) -> int:
        return self.size

    def has_covariance(self) -> bool:
        return self.variance is not None

    def get_variance(self) -> jax.Array:
        if self.variance is None:
            return jnp.zeros_like(self.mean)
        return self.variance

    @property
    def covariance_diagonal(self) -> jax.Array:
        return self.get_variance()

    def covariance_matrix(self) -> jax.Array:
        return jnp.diag(self.get_variance())

    def marginal(self) -> "MarginalDistribution":
        return self

    # -- arithmetic (distribution.hpp operators) ----------------------------
    def __add__(self, other: "MarginalDistribution") -> "MarginalDistribution":
        return MarginalDistribution(
            self.mean + other.mean, self.get_variance() + other.get_variance()
        )

    def __sub__(self, other: "MarginalDistribution") -> "MarginalDistribution":
        return MarginalDistribution(
            self.mean - other.mean, self.get_variance() + other.get_variance()
        )

    def __mul__(self, scalar) -> "MarginalDistribution":
        return MarginalDistribution(
            self.mean * scalar, self.get_variance() * scalar**2
        )

    __rmul__ = __mul__

    # -- indexing -----------------------------------------------------------
    def subset(self, indices) -> "MarginalDistribution":
        indices = jnp.asarray(indices)
        var = None if self.variance is None else self.variance[indices]
        return MarginalDistribution(self.mean[indices], var)

    def set_subset(self, indices, other: "MarginalDistribution"):
        indices = jnp.asarray(indices)
        mean = self.mean.at[indices].set(other.mean)
        var = self.get_variance().at[indices].set(other.get_variance())
        return MarginalDistribution(mean, var)

    # -- linear transforms (transformed_distribution.hpp:70-101) ------------
    def transform(self, matrix) -> "JointDistribution":
        """A @ N(mu, diag(v)) = N(A mu, A diag(v) Aᵀ)."""
        matrix = jnp.asarray(matrix)
        cov = (matrix * self.get_variance()[None, :]) @ matrix.T
        return JointDistribution(matrix @ self.mean, cov)

    # make `np_matrix @ dist` defer to __rmatmul__ instead of numpy trying
    # to broadcast the dataclass as a 0-d operand
    __array_ufunc__ = None

    def transform_marginal(self, matrix) -> "MarginalDistribution":
        """Marginal of the transform without materializing A diag(v) Aᵀ —
        the reference's product_sqrt + rowwise square-sum
        (transformed_distribution.hpp:40-45,87-92): var_i = Σ_j A_ij² v_j."""
        matrix = jnp.asarray(matrix)
        return MarginalDistribution(
            matrix @ self.mean, (matrix**2) @ self.get_variance()
        )

    def __rmatmul__(self, matrix) -> "JointDistribution":
        return self.transform(matrix)

    def __repr__(self):
        return (
            f"MarginalDistribution(n={self.mean.shape}, "
            f"has_variance={self.variance is not None})"
        )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class JointDistribution:
    """Mean + dense covariance (distribution.hpp:97-189)."""

    mean: jax.Array
    covariance: jax.Array

    def tree_flatten(self):
        return (self.mean, self.covariance), None

    @classmethod
    def tree_unflatten(cls, _, children):
        return cls(*children)

    @classmethod
    def create(cls, mean, covariance) -> "JointDistribution":
        return cls(_as_array(mean), _as_array(covariance))

    @property
    def size(self) -> int:
        return self.mean.shape[0]

    def __len__(self) -> int:
        return self.size

    def has_covariance(self) -> bool:
        return True

    def marginal(self) -> MarginalDistribution:
        return MarginalDistribution(self.mean, jnp.diagonal(self.covariance))

    def covariance_matrix(self) -> jax.Array:
        return self.covariance

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, other) -> "JointDistribution":
        return JointDistribution(
            self.mean + other.mean,
            self.covariance + _cov_as_dense(other),
        )

    def __sub__(self, other) -> "JointDistribution":
        return JointDistribution(
            self.mean - other.mean,
            self.covariance + _cov_as_dense(other),
        )

    def __mul__(self, scalar) -> "JointDistribution":
        return JointDistribution(self.mean * scalar, self.covariance * scalar**2)

    __rmul__ = __mul__

    def transform(self, matrix) -> "JointDistribution":
        """A @ N(mu, C) = N(A mu, A C Aᵀ) (transformed_distribution.hpp)."""
        matrix = jnp.asarray(matrix)
        return JointDistribution(
            matrix @ self.mean, matrix @ self.covariance @ matrix.T
        )

    __array_ufunc__ = None  # let `np_matrix @ dist` reach __rmatmul__

    def transform_marginal(self, matrix) -> MarginalDistribution:
        """Marginal of the transform without materializing A C Aᵀ (the
        reference computes product_sqrt then rowwise square-sums,
        transformed_distribution.hpp:47-52,87-92; the einsum contracts to
        the diagonal directly)."""
        matrix = jnp.asarray(matrix)
        var = jnp.einsum("ij,jk,ik->i", matrix, self.covariance, matrix)
        return MarginalDistribution(matrix @ self.mean, var)

    def __rmatmul__(self, matrix) -> "JointDistribution":
        return self.transform(matrix)

    # -- indexing -----------------------------------------------------------
    def subset(self, indices) -> "JointDistribution":
        indices = jnp.asarray(indices)
        return JointDistribution(
            self.mean[indices], self.covariance[jnp.ix_(indices, indices)]
        )

    def __repr__(self):
        return f"JointDistribution(n={self.mean.shape})"


def _cov_as_dense(dist) -> jax.Array:
    if isinstance(dist, JointDistribution):
        return dist.covariance
    return jnp.diag(dist.get_variance())


def concatenate_marginals(
    dists: Sequence[MarginalDistribution],
) -> MarginalDistribution:
    """Concatenate independent marginals (distribution.hpp concatenation)."""
    mean = jnp.concatenate([d.mean for d in dists])
    if all(d.variance is None for d in dists):
        return MarginalDistribution(mean, None)
    var = jnp.concatenate([d.get_variance() for d in dists])
    return MarginalDistribution(mean, var)


def concatenate_joints(dists: Sequence[JointDistribution]) -> JointDistribution:
    """Block-diagonal concatenation of independent joints."""
    mean = jnp.concatenate([d.mean for d in dists])
    n = mean.shape[0]
    cov = jnp.zeros((n, n), dtype=mean.dtype)
    offset = 0
    for d in dists:
        k = d.size
        cov = cov.at[offset : offset + k, offset : offset + k].set(d.covariance)
        offset += k
    return JointDistribution(mean, cov)
