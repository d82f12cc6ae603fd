"""Noise kernels: IndependentNoise and Nugget.

JAX re-design of
/root/reference/include/albatross/src/covariance_functions/noise.hpp:21-46 and
nugget.hpp:32-50.

The reference adds sigma² when ``x == y`` feature-wise.  Batched, that is an
equality mask between the two batches; for the overwhelmingly common case of
unique training features over a shared batch this reduces to sigma² I, so the
symmetric path short-circuits on object identity (``X is Y``) when
``assume_unique`` is set — avoiding an N² comparison epilogue at scale.

``assume_unique`` is a CONTRACT, not a hint: if the batch actually contains
duplicated feature values, (a) by-value semantics make the covariance
exactly singular — a duplicated pair gets sigma² on its off-diagonal too,
so the 2×2 block [[k+s², k+s²], [k+s², k+s²]] is rank-1 and the nugget no
longer regularizes it (the factorization NaNs); and (b) the single-chip
gram (identity shortcut → sigma² I) and the mesh-sharded gram (tiles are
distinct slices → value-equality mask, the reference's noise.hpp:21-46
semantics) build DIFFERENT matrices, so distributed results diverge from
single-chip.  Beware f32 inputs at scale: a uniform draw of n ≥ 8192
points over [0, 100] collides on the f32 grid with high probability
(round-5 find — the big-N artifact's "2-D NaN" was one duplicated pair).
Deduplicate (``core.dataset.deduplicate``) or jitter the inputs, or
drop ``assume_unique`` to get the honest (singular) by-value semantics on
every path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.parameters import Parameter
from ..core.priors import FixedPrior, PositivePrior
from .base import CovarianceFunction

DEFAULT_SIGMA_NOISE = 0.1
DEFAULT_NUGGET_NOISE = 1e-8


def equality_matrix(X, Y) -> jnp.ndarray:
    """(N, M) boolean mask of exact feature equality across all leaves."""
    leaves_x = jax.tree_util.tree_leaves(X)
    leaves_y = jax.tree_util.tree_leaves(Y)
    eq = None
    for lx, ly in zip(leaves_x, leaves_y):
        lx = jnp.asarray(lx)
        ly = jnp.asarray(ly)
        pair = lx[:, None] == ly[None, :]
        while pair.ndim > 2:
            pair = jnp.all(pair, axis=-1)
        eq = pair if eq is None else (eq & pair)
    return eq


class _EqualityNoise(CovarianceFunction):
    _sigma_param: str

    def _sigma2(self):
        sigma = getattr(self, self._sigma_param).value
        return sigma * sigma

    def _matrix(self, X, Y, x_meas, y_meas):
        sigma2 = self._sigma2()
        if X is Y and self.assume_unique:
            n = jax.tree_util.tree_leaves(X)[0].shape[0]
            return sigma2 * jnp.eye(n, dtype=jnp.result_type(sigma2, float))
        return sigma2 * equality_matrix(X, Y).astype(
            jnp.result_type(sigma2, float)
        )

    def _diag(self, X, x_meas):
        n = jax.tree_util.tree_leaves(X)[0].shape[0]
        return jnp.full((n,), self._sigma2())


class IndependentNoise(_EqualityNoise):
    """sigma² iff x == y (noise.hpp:21-46)."""

    _sigma_param = "sigma_independent_noise"

    def __init__(self, sigma_noise=DEFAULT_SIGMA_NOISE, assume_unique=False):
        self.sigma_independent_noise = Parameter(sigma_noise, PositivePrior())
        self.assume_unique = assume_unique

    @property
    def name(self):
        return "independent_noise"


class Nugget(_EqualityNoise):
    """Tiny fixed diagonal jitter for conditioning (nugget.hpp:32-50)."""

    _sigma_param = "nugget_sigma"

    def __init__(self, nugget_sigma=DEFAULT_NUGGET_NOISE, assume_unique=False):
        self.nugget_sigma = Parameter(nugget_sigma, FixedPrior())
        self.assume_unique = assume_unique

    @property
    def name(self):
        return "nugget"
