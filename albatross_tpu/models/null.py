"""NullModel: zero mean, huge variance — a fallback/baseline.

JAX re-design of
/root/reference/include/albatross/src/models/null_model.hpp:30-79.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..core.dataset import feature_count
from ..core.distributions import JointDistribution, MarginalDistribution
from .base import FitModel, ModelBase

NULL_VARIANCE = 1e4


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class NullFit:
    def tree_flatten(self):
        return (), None

    @classmethod
    def tree_unflatten(cls, _, children):
        return cls()


class NullModel(ModelBase):
    @property
    def model_name(self):
        return "null_model"

    def _fit_impl(self, features, targets):
        return NullFit()

    def fit_from_prediction(self, features, prediction):
        return FitModel(self, NullFit())

    def _predict_marginal(self, features, fit):
        n = feature_count(features)
        return MarginalDistribution(
            jnp.zeros((n,)), jnp.full((n,), NULL_VARIANCE)
        )

    def _predict_joint(self, features, fit):
        n = feature_count(features)
        return JointDistribution(
            jnp.zeros((n,)), NULL_VARIANCE * jnp.eye(n)
        )
