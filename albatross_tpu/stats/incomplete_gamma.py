"""Regularized incomplete gamma.

Capability-equivalent of
/root/reference/include/albatross/src/stats/incomplete_gamma.hpp:36-140
(which hand-rolls quadrature + continued-fraction branches).  In JAX the
idiomatic path is XLA's native ``igamma`` kernel — fully traceable and
differentiable — so we delegate rather than re-deriving the series.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax.scipy.special import gammainc, gammaln


def regularized_lower_incomplete_gamma(a, z):
    """P(a, z) = γ(a, z) / Γ(a)."""
    return gammainc(a, z)


def lower_incomplete_gamma(a, z):
    """γ(a, z) — unnormalized."""
    return gammainc(a, z) * jnp.exp(gammaln(a))
