"""Cross-validation driver.

JAX re-design of
/root/reference/include/albatross/src/evaluation/cross_validation.hpp:29-331.

``model.cross_validate().predict(dataset, grouper)`` yields a CV prediction
whose ``means()/marginals()/joints()`` use the model's fast
``cross_validated_predictions`` (one factorization + inverse blocks for GPs)
when available, falling back to generic per-fold fit+predict otherwise.
"""

from __future__ import annotations

from typing import Type

import jax.numpy as jnp
import numpy as np

from ..core.dataset import RegressionDataset
from ..core.distributions import JointDistribution, MarginalDistribution
from ..indexing.grouping import Grouped, group_by
from .cross_validation_utils import cross_validated_scores
from .folds import folds_from_group_indexer


def predict_fold(model, fold):
    """Generic fallback: fit on the fold's train set, predict its test set
    (cross_validation.hpp:18-45)."""
    return model.fit(fold.train_dataset).predict(fold.test_dataset.features)


class CVPrediction:
    """Grouped lazy CV predictions (cross_validation.hpp:29-203)."""

    def __init__(self, model, dataset: RegressionDataset, indexers: Grouped):
        self.model = model
        self.dataset = dataset
        self.indexers = indexers

    def _folds(self) -> Grouped:
        return folds_from_group_indexer(self.dataset, self.indexers)

    def predictions(self) -> Grouped:
        return self._folds().apply(lambda fold: predict_fold(self.model, fold))

    def _grouped(self, predict_type: Type) -> Grouped:
        if hasattr(self.model, "cross_validated_predictions"):
            return self.model.cross_validated_predictions(
                self.dataset, self.indexers, predict_type
            )
        preds = self.predictions()
        if predict_type is MarginalDistribution:
            return preds.apply(lambda p: p.marginal())
        if predict_type is JointDistribution:
            return preds.apply(lambda p: p.joint())
        return preds.apply(lambda p: p.mean())

    def means(self) -> Grouped:
        return self._grouped(None)

    def marginals(self) -> Grouped:
        return self._grouped(MarginalDistribution)

    def joints(self) -> Grouped:
        return self._grouped(JointDistribution)

    def get(self, predict_type: Type) -> Grouped:
        return self._grouped(predict_type)

    # -- concatenated-in-original-order views -------------------------------
    def _order(self):
        return jnp.asarray(
            np.concatenate([np.asarray(i) for i in self.indexers.values()])
        )

    def _scatter_flat(self, flat_mean, flat_var=None):
        n = self.dataset.size
        order = self._order()
        mean = jnp.zeros(n, dtype=flat_mean.dtype).at[order].set(flat_mean)
        if flat_var is None:
            return mean
        var = jnp.zeros(n, dtype=flat_var.dtype).at[order].set(flat_var)
        return mean, var

    def _scatter(self, grouped_means, grouped_vars=None):
        flat_mean = jnp.concatenate([jnp.atleast_1d(m) for m in grouped_means])
        flat_var = (
            None
            if grouped_vars is None
            else jnp.concatenate([jnp.atleast_1d(v) for v in grouped_vars])
        )
        return self._scatter_flat(flat_mean, flat_var)

    def mean(self) -> jnp.ndarray:
        """Held-out means scattered back to dataset order
        (cross_validation.hpp concatenate_mean_predictions)."""
        from .cross_validation_utils import BatchedGrouped

        means = self.means()
        if isinstance(means, BatchedGrouped):
            # array-backed fast path: one reshape + one scatter, no
            # per-group python objects
            return self._scatter_flat(means.means.reshape(-1))
        return self._scatter([m for m in means.values()])

    def marginal(self) -> MarginalDistribution:
        from .cross_validation_utils import BatchedGrouped

        marginals = self.marginals()
        if isinstance(marginals, BatchedGrouped):
            mean, var = self._scatter_flat(
                marginals.means.reshape(-1),
                marginals.variances.reshape(-1),
            )
            return MarginalDistribution(mean, var)
        mean, var = self._scatter(
            [m.mean for m in marginals.values()],
            [m.get_variance() for m in marginals.values()],
        )
        return MarginalDistribution(mean, var)


class CrossValidation:
    """Entry point from model.cross_validate()
    (cross_validation.hpp:205-331)."""

    def __init__(self, model):
        self.model = model

    def _indexers(self, dataset, grouper) -> Grouped:
        if isinstance(grouper, Grouped):
            return grouper
        return group_by(dataset, grouper).indexers()

    def predict(self, dataset: RegressionDataset, grouper) -> CVPrediction:
        return CVPrediction(self.model, dataset, self._indexers(dataset, grouper))

    def scores(self, metric, dataset: RegressionDataset, grouper):
        """Per-fold metric values (cross_validation.hpp:306-316)."""
        from .cross_validation_utils import (
            BatchedGrouped,
            batched_cross_validated_scores,
        )

        indexers = self._indexers(dataset, grouper)
        cv_pred = CVPrediction(self.model, dataset, indexers)
        required = getattr(metric, "required_predict_type", None)
        predictions = cv_pred.get(required)
        if isinstance(predictions, BatchedGrouped):
            # all fold scores in one vmapped dispatch — no fold objects
            out = batched_cross_validated_scores(
                metric, dataset, indexers, predictions
            )
            if out is not None:
                return out
        folds = folds_from_group_indexer(dataset, indexers)
        return cross_validated_scores(metric, folds, predictions)
