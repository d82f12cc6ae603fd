"""Chi-squared CDF.

JAX re-design of
/root/reference/include/albatross/src/stats/chi_squared.hpp:29-80.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops.linalg import CholeskyFactor
from .incomplete_gamma import regularized_lower_incomplete_gamma


def chi_squared_cdf_value(x, k):
    """CDF of chi² with k degrees of freedom at x: P(k/2, x/2)."""
    x = jnp.asarray(x, dtype=jnp.result_type(x, float))
    k = jnp.asarray(k, dtype=x.dtype)
    # k == 0: point mass at zero; x < 0 is outside the support -> NaN
    # (chi_squared.hpp handles both explicitly; test_stats.cc:65-84)
    cdf = jnp.where(
        k <= 0.0,
        1.0,
        regularized_lower_incomplete_gamma(k / 2.0, jnp.maximum(x, 0.0) / 2.0),
    )
    return jnp.where(jnp.isnan(x) | (x < 0.0), jnp.nan, cdf)


def chi_squared_cdf(deviation, covariance) -> jnp.ndarray:
    """CDF of the Mahalanobis norm devᵀ Σ⁻¹ dev under chi²(n)
    (chi_squared.hpp:62-80)."""
    deviation = jnp.asarray(deviation)
    chol = CholeskyFactor.factorize(jnp.asarray(covariance))
    white = chol.sqrt_solve(deviation)
    statistic = jnp.sum(white * white)
    return chi_squared_cdf_value(statistic, deviation.shape[0])
