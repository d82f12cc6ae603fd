"""Least-squares / linear-regression models.

JAX re-design of
/root/reference/include/albatross/src/models/least_squares.hpp:46-133.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..core.distributions import MarginalDistribution
from .base import ModelBase


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class LeastSquaresFit:
    coefs: jax.Array

    def tree_flatten(self):
        return (self.coefs,), None

    @classmethod
    def tree_unflatten(cls, _, children):
        return cls(*children)


class LeastSquares(ModelBase):
    """min_x ‖y − Ax‖² with rows of A as features; QR-based solve."""

    @property
    def model_name(self):
        return "least_squares"

    def convert_features(self, features) -> jnp.ndarray:
        A = jnp.asarray(features)
        if A.ndim == 1:
            A = A[:, None]
        return A

    def _fit_impl(self, features, targets: MarginalDistribution):
        A = self.convert_features(features)
        coefs, *_ = jnp.linalg.lstsq(A, targets.mean)
        return LeastSquaresFit(coefs)

    def _predict_mean(self, features, fit: LeastSquaresFit):
        return self.convert_features(features) @ fit.coefs


class LinearRegression(LeastSquares):
    """Design rows [1, x] — offset + slope (least_squares.hpp:92-133)."""

    @property
    def model_name(self):
        return "linear_regression"

    def convert_features(self, features) -> jnp.ndarray:
        x = jnp.asarray(features).reshape(-1)
        return jnp.stack([jnp.ones_like(x), x], axis=1)
