"""Input-dependent scaling terms.

JAX re-design of
/root/reference/include/albatross/src/covariance_functions/scaling_function.hpp:18-231:
k'(x, y) = s(x) · k(x, y) · s(y) with a deterministic scaling function s.

A ``ScalingFunction`` is a Module implementing batched ``_scale(X) -> (N,)``
(or None when undefined for a feature kind); ``ScalingTerm`` lifts it into the
covariance algebra, where the standard ``ProductKernel`` semantics ("only one
side defined acts alone") reproduce the reference's specialized product
behavior for cross-type covariances.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from ..core.module import Module
from .base import CovarianceFunction


class ScalingFunction(Module):
    def _scale(self, X) -> Optional[jnp.ndarray]:
        raise NotImplementedError

    def __call__(self, X) -> jnp.ndarray:
        s = self._scale(X)
        if s is None:
            raise TypeError(f"{self.name}: undefined feature type")
        return s


class ScalingTerm(CovarianceFunction):
    def __init__(self, scaling_function: ScalingFunction):
        self.scaling_function = scaling_function

    @property
    def name(self):
        return self.scaling_function.name

    def _matrix(self, X, Y, x_meas, y_meas):
        sx = self.scaling_function._scale(X)
        sy = self.scaling_function._scale(Y)
        if sx is None and sy is None:
            return None
        if sx is None:
            import jax

            n = jax.tree_util.tree_leaves(X)[0].shape[0]
            sx = jnp.ones((n,), dtype=sy.dtype)
        if sy is None:
            import jax

            m = jax.tree_util.tree_leaves(Y)[0].shape[0]
            sy = jnp.ones((m,), dtype=sx.dtype)
        return sx[:, None] * sy[None, :]

    def _diag(self, X, x_meas):
        sx = self.scaling_function._scale(X)
        if sx is None:
            return None
        return sx * sx
