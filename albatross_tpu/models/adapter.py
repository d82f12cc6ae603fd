"""Adapted models: feature conversion in front of any model.

JAX counterpart of the reference's model-adapter pattern
(tests/test_model_adapter.cc TestAdaptedModel: convert features — possibly
using the adapter's own parameters — then delegate fit/predict to a base
model).  Here it is a generic wrapper instead of a CRTP subclass: the
conversion function receives the adapter so it can read adapter parameters,
and it must be traceable so adapted models still jit/grad.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ..core.parameters import Parameter
from .base import ModelBase


class AdaptedModel(ModelBase):
    """Wraps ``sub_model``, converting features first.

    ``convert(adapter, features)`` runs before every fit/predict; adapter
    parameters (e.g. a "center" offset) are ordinary Module attributes, so
    the standard get/set machinery and pytree flattening apply.
    """

    def __init__(
        self,
        sub_model: ModelBase,
        convert: Callable,
        params: Optional[Dict[str, Parameter]] = None,
    ):
        self.sub_model = sub_model
        self.convert = convert
        for name, p in (params or {}).items():
            setattr(self, name, p)

    @property
    def model_name(self):
        return f"adapted[{self.sub_model.model_name}]"

    def _fit_impl(self, features, targets):
        return self.sub_model._fit_impl(self.convert(self, features), targets)

    def _predict_mean(self, features, fit):
        return self.sub_model._predict_mean(self.convert(self, features), fit)

    def _predict_marginal(self, features, fit):
        return self.sub_model._predict_marginal(
            self.convert(self, features), fit
        )

    def _predict_joint(self, features, fit):
        return self.sub_model._predict_joint(self.convert(self, features), fit)

    def log_likelihood(self, dataset):
        from ..core.dataset import RegressionDataset

        converted = RegressionDataset(
            self.convert(self, dataset.features),
            dataset.targets,
            dict(dataset.metadata),
        )
        return self.sub_model.log_likelihood(converted)
