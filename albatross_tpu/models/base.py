"""Model protocol: ModelBase, FitModel, lazy Prediction.

JAX re-design of the reference model core
(/root/reference/include/albatross/src/core/model.hpp:22-168,
 fit_model.hpp:18-114, prediction.hpp:32-224).

The reference's SFINAE dispatch ("use the cheapest _predict_impl the model
offers, downgrading joint→marginal→mean") becomes explicit hasattr-based
dispatch in ``Prediction``.  Models and fits are pytrees, so a fit/predict
pipeline can be jitted end-to-end; the ThreadPool knob disappears — within-
process parallelism is XLA's job, cross-chip parallelism is the mesh layer's
(albatross_tpu.parallel).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax

from ..core.dataset import RegressionDataset
from ..core.distributions import JointDistribution, MarginalDistribution
from ..core.module import Module


class ModelBase(Module):
    """Base model: implement ``_fit_impl(features, targets) -> fit state``
    plus any of ``_predict_mean/_predict_marginal/_predict_joint``."""

    def _fit_impl(self, features, targets: MarginalDistribution):
        raise NotImplementedError

    # -- public fit ---------------------------------------------------------
    def fit(self, features, targets=None) -> "FitModel":
        if targets is None:
            if not isinstance(features, RegressionDataset):
                raise TypeError("fit() needs (features, targets) or a dataset")
            dataset = features
            features, targets = dataset.features, dataset.targets
        elif not isinstance(targets, MarginalDistribution):
            targets = MarginalDistribution.create(targets)
        fit = self._fit_impl(features, targets)
        return FitModel(self, fit)

    def fit_from_prediction(self, features, prediction: JointDistribution):
        raise NotImplementedError(
            f"{type(self).__name__} does not support fit_from_prediction"
        )

    # -- evaluation hooks ---------------------------------------------------
    def cross_validate(self):
        from ..evaluation.cross_validation import CrossValidation

        return CrossValidation(self)

    def ransac(self, strategy, config, **kwargs):
        from .ransac import Ransac

        return Ransac(self, strategy, config, **kwargs)

    @property
    def model_name(self) -> str:
        return type(self).__name__.lower()


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class FitModel:
    """A model bound to its trained state (fit_model.hpp:18-114)."""

    model: ModelBase
    fit: Any

    def tree_flatten(self):
        return (self.model, self.fit), None

    @classmethod
    def tree_unflatten(cls, _, children):
        return cls(*children)

    def predict(self, features) -> "Prediction":
        return Prediction(self.model, self.fit, features)

    def predict_with_measurement_noise(self, features) -> "Prediction":
        from ..kernels.features import as_measurement

        return Prediction(self.model, self.fit, as_measurement(features))

    def update(self, features, targets=None) -> "FitModel":
        """Online update with new observations (fit_model.hpp update)."""
        if targets is None and isinstance(features, RegressionDataset):
            features, targets = features.features, features.targets
        if not isinstance(targets, MarginalDistribution):
            targets = MarginalDistribution.create(targets)
        new_fit = self.model._update_impl(self.fit, features, targets)
        return FitModel(self.model, new_fit)

    def get_fit(self):
        return self.fit

    def for_serving(self) -> "FitModel":
        """Swap the fit's factorization for an explicit inverse: higher
        prediction throughput (solves become GEMMs) at the cost of one
        O(N³) inversion and the usual explicit-inverse accuracy caveats.

        Applies to exact-GP fits only — sparse fits need the factor's
        sqrt_solve at predict time, which an explicit inverse cannot
        provide; those return unchanged.
        """
        import dataclasses

        from .gp import GPFit

        fit = self.fit
        if not isinstance(fit, GPFit):
            return self
        cov = fit.train_covariance
        if not hasattr(cov, "to_direct_inverse"):
            return self
        new_fit = dataclasses.replace(
            fit, train_covariance=cov.to_direct_inverse()
        )
        return FitModel(self.model, new_fit)


class Prediction:
    """Lazy prediction with joint→marginal→mean downgrade
    (prediction.hpp:32-224)."""

    def __init__(self, model: ModelBase, fit: Any, features):
        self.model = model
        self.fit = fit
        self.features = features

    def mean(self):
        if hasattr(self.model, "_predict_mean"):
            return self.model._predict_mean(self.features, self.fit)
        return self.marginal().mean

    def marginal(self) -> MarginalDistribution:
        if hasattr(self.model, "_predict_marginal"):
            return self.model._predict_marginal(self.features, self.fit)
        return self.joint().marginal()

    def joint(self) -> JointDistribution:
        if not hasattr(self.model, "_predict_joint"):
            raise TypeError(
                f"{type(self.model).__name__} cannot produce joint predictions"
            )
        return self.model._predict_joint(self.features, self.fit)

    def get(self, predict_type):
        """Dispatch on requested type (prediction.hpp get<PredictType>)."""
        if predict_type is MarginalDistribution:
            return self.marginal()
        if predict_type is JointDistribution:
            return self.joint()
        return self.mean()

    @property
    def size(self) -> int:
        from ..core.dataset import feature_count
        from ..kernels.features import strip_measurement

        raw, _ = strip_measurement(self.features)
        return feature_count(raw)
