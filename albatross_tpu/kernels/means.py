"""Mean functions.

JAX re-design of
/root/reference/include/albatross/src/covariance_functions/mean_function.hpp:18-270
and the LinearMean (polynomials.hpp:92-107).

A MeanFunction maps a feature batch to a mean vector; ``add_to`` /
``remove_from`` mirror the reference helpers used inside GP fit/predict.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.module import Module
from ..core.parameters import Parameter
from ..core.priors import GaussianPrior
from .distances import as_matrix
from .features import strip_measurement


class MeanFunction(Module):
    def _mean(self, X) -> jnp.ndarray:
        raise NotImplementedError

    def __call__(self, X) -> jnp.ndarray:
        X, _ = strip_measurement(X)
        return self._mean(X)

    def add_to(self, X, targets: jnp.ndarray) -> jnp.ndarray:
        return targets + self(X)

    def remove_from(self, X, targets: jnp.ndarray) -> jnp.ndarray:
        return targets - self(X)

    def __add__(self, other):
        return SumMean(self, other)

    def __mul__(self, other):
        return ProductMean(self, other)


class ZeroMean(MeanFunction):
    @property
    def name(self):
        return "zero"

    def _mean(self, X):
        from ..core.dataset import feature_count

        return jnp.zeros((feature_count(X),))


class ConstantMean(MeanFunction):
    def __init__(self, value=0.0):
        self.mean_value = Parameter(value)

    @property
    def name(self):
        return "constant_mean"

    def _mean(self, X):
        from ..core.dataset import feature_count

        v = self.mean_value.value
        return jnp.full(
            (feature_count(X),), v, dtype=jnp.result_type(v, float)
        )


class LinearMean(MeanFunction):
    """slope · x + offset for scalar features (polynomials.hpp:92-107)."""

    def __init__(self, slope=0.0, offset=0.0):
        self.slope = Parameter(slope, GaussianPrior(0.0, 1000.0))
        self.offset = Parameter(offset, GaussianPrior(0.0, 1000.0))

    @property
    def name(self):
        return "linear"

    def _mean(self, X):
        x = as_matrix(X)[:, 0]
        return self.slope.value * x + self.offset.value


class SumMean(MeanFunction):
    def __init__(self, lhs: MeanFunction, rhs: MeanFunction):
        self.lhs = lhs
        self.rhs = rhs

    @property
    def name(self):
        return f"({self.lhs.name}+{self.rhs.name})"

    def _mean(self, X):
        return self.lhs._mean(X) + self.rhs._mean(X)


class ProductMean(MeanFunction):
    def __init__(self, lhs: MeanFunction, rhs: MeanFunction):
        self.lhs = lhs
        self.rhs = rhs

    @property
    def name(self):
        return f"({self.lhs.name}*{self.rhs.name})"

    def _mean(self, X):
        return self.lhs._mean(X) * self.rhs._mean(X)
