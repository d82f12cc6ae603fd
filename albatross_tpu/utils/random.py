"""Random sampling utilities.

JAX counterpart of
/root/reference/include/albatross/src/utils/random_utils.hpp:20-160.
Device-side draws use jax PRNG; host-side index sampling uses numpy.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.distributions import JointDistribution
from ..ops.linalg import CholeskyFactor


def random_without_replacement(values, k: int, rng) -> list:
    idx = rng.choice(len(values), size=k, replace=False)
    return [values[int(i)] for i in sorted(idx)]


def random_covariance_matrix(key, n: int, dtype=None) -> jnp.ndarray:
    """SPD matrix with random orthogonal eigenvectors and positive spectrum
    (random_utils.hpp random covariance)."""
    k_q, k_d = jax.random.split(key)
    A = jax.random.normal(k_q, (n, n), dtype or jnp.float32)
    Q, _ = jnp.linalg.qr(A)
    eigs = jax.random.uniform(k_d, (n,), A.dtype, 0.1, 1.0)
    return (Q * eigs[None, :]) @ Q.T


def sample_mvn(key, distribution: JointDistribution, num_samples: int = 1):
    """Draws via the Cholesky square root (random_utils.hpp MVN sampling)."""
    chol = CholeskyFactor.factorize(distribution.covariance)
    normals = jax.random.normal(
        key, (distribution.size, num_samples), distribution.mean.dtype
    )
    samples = distribution.mean[:, None] + chol.L @ normals
    return samples[:, 0] if num_samples == 1 else samples.T
