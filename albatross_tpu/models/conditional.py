"""ConditionalGaussian: a model over index sets of a fixed (prior, truth).

JAX re-design of
/root/reference/include/albatross/src/models/conditional_gaussian.hpp:17-110.

Fit = condition on a subset of indices; predict = conditional at other
indices.  This is the fast inner model for GP-RANSAC: the expensive prior
covariance is computed once, and each candidate fit is a small dense
factorization over the candidate indices — which vmaps across candidate sets
of equal size.
"""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp

from ..core.distributions import JointDistribution, MarginalDistribution
from ..ops.linalg import CholeskyFactor
from .base import FitModel, ModelBase
from .gp import gp_joint_prediction, gp_marginal_prediction, gp_mean_prediction


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class ConditionalFit:
    information: jax.Array
    cov_chol: CholeskyFactor
    indices: jax.Array

    def tree_flatten(self):
        return (self.information, self.cov_chol, self.indices), None

    @classmethod
    def tree_unflatten(cls, _, children):
        return cls(*children)


class ConditionalGaussian(ModelBase):
    def __init__(self, prior: JointDistribution, truth: MarginalDistribution):
        self.prior = prior
        self.truth = truth

    @property
    def model_name(self):
        return "conditional_gaussian"

    def fit_from_indices(self, indices) -> ConditionalFit:
        indices = jnp.asarray(indices)
        train_prior = self.prior.subset(indices)
        train_truth = self.truth.subset(indices)
        deviation = train_truth.mean - train_prior.mean
        cov = train_prior.covariance + jnp.diag(train_truth.get_variance())
        chol = CholeskyFactor.factorize(cov)
        return ConditionalFit(chol.solve(deviation), chol, indices)

    def fit(self, indices, targets=None) -> FitModel:
        return FitModel(self, self.fit_from_indices(indices))

    def get_prior(self, indices) -> JointDistribution:
        return self.prior.subset(jnp.asarray(indices))

    def get_truth(self, indices) -> MarginalDistribution:
        return self.truth.subset(jnp.asarray(indices))

    def _cross(self, fit: ConditionalFit, predict_indices):
        return self.prior.covariance[
            jnp.ix_(fit.indices, jnp.asarray(predict_indices))
        ]

    def _predict_mean(self, predict_indices, fit: ConditionalFit):
        idx = jnp.asarray(predict_indices)
        cross = self._cross(fit, idx)
        return gp_mean_prediction(cross, fit.information) + self.prior.mean[idx]

    def _predict_marginal(self, predict_indices, fit: ConditionalFit):
        idx = jnp.asarray(predict_indices)
        cross = self._cross(fit, idx)
        prior_var = jnp.diagonal(self.prior.covariance)[idx]
        pred = gp_marginal_prediction(
            cross, prior_var, fit.information, fit.cov_chol
        )
        return MarginalDistribution(
            pred.mean + self.prior.mean[idx], pred.variance
        )

    def _predict_joint(self, predict_indices, fit: ConditionalFit):
        idx = jnp.asarray(predict_indices)
        cross = self._cross(fit, idx)
        prior_cov = self.prior.covariance[jnp.ix_(idx, idx)]
        pred = gp_joint_prediction(
            cross, prior_cov, fit.information, fit.cov_chol
        )
        return JointDistribution(pred.mean + self.prior.mean[idx], pred.covariance)
