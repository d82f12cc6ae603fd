"""Feature wrappers: Measurement tags and linear combinations.

JAX re-design of the reference feature wrappers
(/root/reference/include/albatross/src/covariance_functions/measurement.hpp:18-67,
 core/linear_combination.hpp:18-100).

In the reference these are per-element wrapper *types* dispatched by SFINAE;
here they are batch-level pytree wrappers: a ``Measurement`` tags a whole
feature batch (the GP fit wraps its training set exactly once), and a
``LinearCombinationBatch`` carries (N, K)-stacked base features plus
coefficients so covariance with a combination lowers to dense matmuls.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Measurement:
    """Tags a feature batch as noisy measurements (measurement.hpp:18-29)."""

    value: Any

    def tree_flatten(self):
        return (self.value,), None

    @classmethod
    def tree_unflatten(cls, _, children):
        return cls(children[0])


def as_measurement(features) -> Measurement:
    if isinstance(features, Measurement):
        return features
    return Measurement(features)


# Alias matching the reference's vector form; batches make them identical.
as_measurements = as_measurement


def strip_measurement(features):
    """Unwrap, returning (raw_features, was_measurement)."""
    if isinstance(features, Measurement):
        return features.value, True
    return features, False


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class LinearCombinationBatch:
    """N combinations of K base features each (linear_combination.hpp:18-47).

    ``values`` has shape (N, K, ...feature dims...); ``coefficients`` has
    shape (N, K).  cov(lc_i, y_j) = sum_a c_{ia} k(v_{ia}, y_j), which the
    kernel base evaluates as one big gram over the flattened (N*K) features
    followed by a coefficient contraction — GEMM-friendly, no per-element
    dispatch.
    """

    values: Any  # pytree, leaves (N, K, ...)
    coefficients: jax.Array  # (N, K)

    def tree_flatten(self):
        return (self.values, self.coefficients), None

    @classmethod
    def tree_unflatten(cls, _, children):
        return cls(*children)

    @property
    def size(self) -> int:
        return self.coefficients.shape[0]

    @property
    def combo_size(self) -> int:
        return self.coefficients.shape[1]

    def flat_values(self):
        """Merge the (N, K) leading axes of every leaf -> (N*K, ...)."""
        return jax.tree_util.tree_map(
            lambda leaf: leaf.reshape((-1,) + leaf.shape[2:]), self.values
        )


def to_linear_combination(features, coefficients=None) -> LinearCombinationBatch:
    """One combination spanning the given features (linear_combination.hpp);
    idempotent on an existing combination (linear_combination.hpp
    to_linear_combination(LinearCombination) returns it unchanged —
    test_linear_combination.cc:91-103)."""
    if isinstance(features, LinearCombinationBatch):
        if coefficients is not None:
            raise ValueError(
                "cannot re-weight an existing LinearCombinationBatch"
            )
        return features
    leaves = jax.tree_util.tree_leaves(features)
    k = leaves[0].shape[0]
    if coefficients is None:
        coefficients = jnp.ones((k,))
    values = jax.tree_util.tree_map(lambda leaf: leaf[None, ...], features)
    return LinearCombinationBatch(values, jnp.asarray(coefficients)[None, :])


def sum_of(features) -> LinearCombinationBatch:
    return to_linear_combination(features)


def mean_of(features) -> LinearCombinationBatch:
    leaves = jax.tree_util.tree_leaves(features)
    k = leaves[0].shape[0]
    return to_linear_combination(features, jnp.full((k,), 1.0 / k))


def difference_of(a, b) -> LinearCombinationBatch:
    """Elementwise a_i - b_i as N two-term combinations."""
    values = jax.tree_util.tree_map(
        lambda la, lb: jnp.stack([la, lb], axis=1), a, b
    )
    n = jax.tree_util.tree_leaves(values)[0].shape[0]
    coefficients = jnp.tile(jnp.asarray([[1.0, -1.0]]), (n, 1))
    return LinearCombinationBatch(values, coefficients)
