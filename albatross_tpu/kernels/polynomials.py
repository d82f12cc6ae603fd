"""Constant and polynomial covariance terms.

JAX re-design of
/root/reference/include/albatross/src/covariance_functions/polynomials.hpp:20-110.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..core.parameters import Parameter, map_join
from ..core.priors import NonNegativePrior
from .base import CovarianceFunction
from .distances import as_matrix

DEFAULT_SIGMA = 100.0


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class ConstantTerm:
    """State-space marker feature of the Constant kernel
    (polynomials.hpp ConstantTerm): a batch of latent "global constant"
    features.  Covariance against anything through ``Constant`` is sigma²;
    every other kernel should treat it as undefined — the marker leaf is
    NaN so accidental value-based use (equality noise, distances) can never
    silently match a real feature.

    Used to infer the constant's latent value:
    ``fit_model.predict(ConstantTerm())`` (test_scaling_function.cc:144-148
    predicts at constant.get_state_space_representation(features))."""

    marker: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.full((1,), jnp.nan)
    )

    def tree_flatten(self):
        return (self.marker,), None

    @classmethod
    def tree_unflatten(cls, _, children):
        return cls(children[0])

    @property
    def size(self) -> int:
        return self.marker.shape[0]


class Constant(CovarianceFunction):
    """sigma² everywhere — a (biased) mean term (polynomials.hpp:31-61)."""

    def __init__(self, sigma_constant=DEFAULT_SIGMA):
        self.sigma_constant = Parameter(sigma_constant, NonNegativePrior())

    @property
    def name(self):
        return "constant"

    def _sigma2(self):
        s = self.sigma_constant.value
        return s * s

    def _matrix(self, X, Y, x_meas, y_meas):
        import jax

        n = jax.tree_util.tree_leaves(X)[0].shape[0]
        m = jax.tree_util.tree_leaves(Y)[0].shape[0]
        s2 = self._sigma2()
        return jnp.full((n, m), s2, dtype=jnp.result_type(s2, float))

    def _diag(self, X, x_meas):
        import jax

        n = jax.tree_util.tree_leaves(X)[0].shape[0]
        return jnp.full((n,), self._sigma2())

    def state_space_representation(self, X):
        # The reference emits a ConstantTerm marker feature; in array-land the
        # constant's inducing representation is a single pseudo-point.
        return jnp.zeros((1,))


class Polynomial(CovarianceFunction):
    """sum_i sigma_i² (x·y)^i for scalar features (polynomials.hpp:63-90).

    Parameters are named ``sigma_polynomial_<i>`` exactly as the reference.
    """

    def __init__(self, order: int, sigma=DEFAULT_SIGMA):
        self.order = int(order)
        self.sigmas = tuple(
            Parameter(sigma, NonNegativePrior()) for _ in range(order + 1)
        )

    @property
    def name(self):
        return f"polynomial_{self.order}"

    def get_params(self):
        own = {
            f"sigma_polynomial_{i}": p for i, p in enumerate(self.sigmas)
        }
        return map_join(own)

    def _replace_param(self, name, param):
        prefix = "sigma_polynomial_"
        if name.startswith(prefix):
            idx = int(name[len(prefix):])
            sigmas = list(self.sigmas)
            sigmas[idx] = param
            return self._replace(sigmas=tuple(sigmas))
        raise KeyError(name)

    def _matrix(self, X, Y, x_meas, y_meas):
        x = as_matrix(X)[:, 0]
        y = as_matrix(Y)[:, 0]
        cov = jnp.zeros((x.shape[0], y.shape[0]), dtype=x.dtype)
        xp = jnp.ones_like(x)
        yp = jnp.ones_like(y)
        for i, p in enumerate(self.sigmas):
            if i > 0:
                xp = xp * x
                yp = yp * y
            s2 = p.value * p.value
            cov = cov + s2 * xp[:, None] * yp[None, :]
        return cov

    def _diag(self, X, x_meas):
        x = as_matrix(X)[:, 0]
        out = jnp.zeros_like(x)
        xp = jnp.ones_like(x)
        for i, p in enumerate(self.sigmas):
            if i > 0:
                xp = xp * x
            out = out + (p.value * p.value) * xp * xp
        return out
