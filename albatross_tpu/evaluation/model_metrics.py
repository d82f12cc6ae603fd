"""Model metrics: cross-validation-based objective functions.

JAX re-design of
/root/reference/include/albatross/src/evaluation/model_metrics.hpp:18-100.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.dataset import RegressionDataset
from ..core.distributions import JointDistribution
from ..indexing.grouping import LeaveOneOutGrouper
from .metrics import NegativeLogLikelihood, RootMeanSquareError


class ModelMetric:
    """Callable (dataset, model) -> scalar."""

    def __call__(self, dataset: RegressionDataset, model):
        raise NotImplementedError


class LeaveOneOutLikelihood(ModelMetric):
    """Σ fold NLL − prior log-likelihood (model_metrics.hpp:59-73)."""

    def __init__(self, predict_type=JointDistribution):
        self.nll = NegativeLogLikelihood(predict_type)

    def __call__(self, dataset, model):
        scores = model.cross_validate().scores(
            self.nll, dataset, LeaveOneOutGrouper()
        )
        return jnp.sum(scores) - model.prior_log_likelihood()


class LeaveOneGroupOutLikelihood(ModelMetric):
    """LOGO NLL with a custom grouper (model_metrics.hpp:75-94)."""

    def __init__(self, grouper, predict_type=JointDistribution):
        self.grouper = grouper
        self.nll = NegativeLogLikelihood(predict_type)

    def __call__(self, dataset, model):
        scores = model.cross_validate().scores(self.nll, dataset, self.grouper)
        return jnp.sum(scores) - model.prior_log_likelihood()


class LeaveOneOutRMSE(ModelMetric):
    """Mean per-fold RMSE (model_metrics.hpp:96-100)."""

    def __call__(self, dataset, model):
        scores = model.cross_validate().scores(
            RootMeanSquareError(), dataset, LeaveOneOutGrouper()
        )
        return jnp.mean(scores)


class GaussianProcessNegativeLogLikelihood(ModelMetric):
    """−model.log_likelihood(dataset) (gp.hpp:542-550)."""

    def __call__(self, dataset, model):
        return -model.log_likelihood(dataset)
