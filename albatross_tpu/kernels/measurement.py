"""MeasurementOnly covariance wrapper.

JAX re-design of
/root/reference/include/albatross/src/covariance_functions/measurement.hpp:70-110:
a term that contributes only between Measurement-tagged batches (e.g. noise in
the training covariance but not in train/test or test/test covariances).
"""

from __future__ import annotations

import jax.numpy as jnp

from .base import CovarianceFunction


class MeasurementOnly(CovarianceFunction):
    def __init__(self, sub: CovarianceFunction):
        self.sub = sub

    @property
    def name(self):
        return f"measurement[{self.sub.name}]"

    def _matrix(self, X, Y, x_meas, y_meas):
        inner = self.sub._matrix(X, Y, x_meas, y_meas)
        if inner is None:
            return None
        if x_meas and y_meas:
            return inner
        return jnp.zeros_like(inner)

    def _symmetric_exact(self, X):
        return self.sub._symmetric_exact(X)

    def _tagged_matrix(self, X, Y, tx, ty, x_meas, y_meas):
        inner = self.sub._tagged_matrix(X, Y, tx, ty, x_meas, y_meas)
        if inner is None:
            return None
        if x_meas and y_meas:
            return inner
        return jnp.zeros_like(inner)

    def _tagged_diag(self, X, tx, x_meas):
        inner = self.sub._tagged_diag(X, tx, x_meas)
        if inner is None:
            return None
        if x_meas:
            return inner
        return jnp.zeros_like(inner)

    def _diag(self, X, x_meas):
        inner = self.sub._diag(X, x_meas)
        if inner is None:
            return None
        if x_meas:
            return inner
        return jnp.zeros_like(inner)


def measurement_only(sub: CovarianceFunction) -> MeasurementOnly:
    return MeasurementOnly(sub)
