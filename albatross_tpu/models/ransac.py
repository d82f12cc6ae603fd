"""RANSAC outlier rejection as a meta-model.

JAX re-design of
/root/reference/include/albatross/src/models/ransac.hpp:23-526 and
ransac_gp.hpp:21-200.

The control loop (sample → validate → fit → score → consensus) is inherently
sequential host logic and stays in Python; all the *work* inside it — the
candidate fits and per-group inlier metrics — runs through jitted model code.
The GP strategy precomputes one ConditionalGaussian prior so every candidate
fit is a small dense conditioning instead of a full refit
(ransac_gp.hpp:117-180).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, Dict, List, Optional

import jax
import numpy as np

from ..core.dataset import RegressionDataset
from ..core.distributions import JointDistribution, MarginalDistribution
from ..evaluation.entropy import differential_entropy
from ..evaluation.metrics import NegativeLogLikelihood
from ..evaluation.model_metrics import LeaveOneOutLikelihood
from ..indexing.grouping import (
    Grouped,
    LeaveOneOutGrouper,
    group_by,
    indices_from_groups,
)
from ..stats.chi_squared import chi_squared_cdf
from .base import FitModel, ModelBase
from .conditional import ConditionalGaussian

DEFAULT_CHI_SQUARED_THRESHOLD = 0.999


class RansacReturnCode(enum.IntEnum):
    """(ransac.hpp:59-87)"""

    INVALID = -1
    SUCCESS = 0
    NO_CONSENSUS = 1
    INVALID_ARGUMENTS = 2
    EXCEEDED_MAX_FAILED_CANDIDATES = 3
    FAILURE = 4


def ransac_success(return_code: RansacReturnCode) -> bool:
    return return_code == RansacReturnCode.SUCCESS


@dataclasses.dataclass
class RansacConfig:
    """(ransac.hpp:134-152)"""

    inlier_threshold: float = float("nan")
    random_sample_size: int = 0
    min_consensus_size: int = 0
    max_iterations: int = 0
    max_failed_candidates: int = 0


@dataclasses.dataclass(eq=False)
class RansacIteration:
    """Audit trail for one iteration (ransac.hpp:89-118).

    ``eq=False`` keeps default identity hash/eq: the audit trail rides
    pytree AUX data (RansacFit below), where hashability is required for
    jit-cache keys."""

    candidates: List = dataclasses.field(default_factory=list)
    inliers: Dict = dataclasses.field(default_factory=dict)
    outliers: Dict = dataclasses.field(default_factory=dict)
    consensus_metric_value: float = float("nan")

    def consensus(self) -> List:
        return list(self.candidates) + list(self.inliers.keys())


@dataclasses.dataclass(eq=False)
class RansacOutput:
    """(ransac.hpp:120-132); eq=False: see RansacIteration."""

    return_code: RansacReturnCode = RansacReturnCode.INVALID
    best: RansacIteration = dataclasses.field(default_factory=RansacIteration)
    iterations: List[RansacIteration] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class RansacFunctions:
    """fitter/inlier/consensus/validity callbacks (ransac.hpp:23-52)."""

    fitter: Callable  # groups -> fit
    inlier_metric: Callable  # (group, fit) -> float
    consensus_metric: Callable  # groups -> float (lower better)
    is_valid_candidate: Callable = lambda groups: True


def random_without_replacement(values: List, k: int, rng) -> List:
    idx = rng.choice(len(values), size=k, replace=False)
    return [values[int(i)] for i in sorted(idx)]


def ransac(
    functions: RansacFunctions,
    groups: List,
    config: RansacConfig,
    seed: int = 0,
) -> RansacOutput:
    """Core loop (ransac.hpp:172-258)."""
    output = RansacOutput(return_code=RansacReturnCode.FAILURE)

    if (
        config.min_consensus_size >= len(groups)
        or config.min_consensus_size < config.random_sample_size
        or config.random_sample_size >= len(groups)
        or config.random_sample_size <= 0
        or config.max_iterations <= 0
    ):
        output.return_code = RansacReturnCode.INVALID_ARGUMENTS
        return output

    rng = np.random.default_rng(seed)
    i = 0
    failed_candidates = 0
    while i < config.max_iterations:
        iteration = RansacIteration()
        output.iterations.append(iteration)
        iteration.candidates = random_without_replacement(
            groups, config.random_sample_size, rng
        )

        if not functions.is_valid_candidate(iteration.candidates):
            failed_candidates += 1
            if failed_candidates >= config.max_failed_candidates:
                output.return_code = (
                    RansacReturnCode.EXCEEDED_MAX_FAILED_CANDIDATES
                )
                return output
            continue

        fit = functions.fitter(iteration.candidates)

        for group in groups:
            if group in iteration.candidates:
                continue
            value = float(functions.inlier_metric(group, fit))
            if value <= config.inlier_threshold:
                iteration.inliers[group] = value
            else:
                iteration.outliers[group] = value

        consensus = iteration.consensus()
        if len(consensus) >= config.min_consensus_size:
            iteration.consensus_metric_value = float(
                functions.consensus_metric(consensus)
            )
            if math.isnan(output.best.consensus_metric_value) or (
                iteration.consensus_metric_value
                < output.best.consensus_metric_value
            ):
                output.best = iteration
        i += 1

    if output.best.consensus():
        output.return_code = RansacReturnCode.SUCCESS
    else:
        output.return_code = RansacReturnCode.NO_CONSENSUS
    return output


# ---------------------------------------------------------------------------
# Generic strategy (ransac.hpp:282-375)
# ---------------------------------------------------------------------------
class GenericRansacStrategy:
    def __init__(self, inlier_metric, consensus_metric, grouper):
        self.inlier_metric = inlier_metric
        self.consensus_metric = consensus_metric
        self.grouper = grouper

    def get_indexer(self, dataset: RegressionDataset) -> Grouped:
        return group_by(dataset, self.grouper).indexers()

    def __call__(self, model, dataset: RegressionDataset) -> RansacFunctions:
        indexer = self.get_indexer(dataset)

        def fitter(groups):
            inds = indices_from_groups(indexer, groups)
            return model.fit(dataset.subset(inds))

        def inlier_metric(group, fit_model):
            inds = indexer[group]
            pred = fit_model.predict(
                dataset.subset(inds).features
            )
            return self.inlier_metric(pred, dataset.targets.subset(inds))

        def consensus_metric(groups):
            inds = indices_from_groups(indexer, groups)
            return self.consensus_metric(dataset.subset(inds), model)

        return RansacFunctions(fitter, inlier_metric, consensus_metric)


def DefaultRansacStrategy():
    return GenericRansacStrategy(
        NegativeLogLikelihood(JointDistribution),
        LeaveOneOutLikelihood(JointDistribution),
        LeaveOneOutGrouper(),
    )


# ---------------------------------------------------------------------------
# GP strategy with conditional-Gaussian fast path (ransac_gp.hpp)
# ---------------------------------------------------------------------------
class DifferentialEntropyConsensusMetric:
    def __call__(self, prior: JointDistribution, truth) -> float:
        return float(differential_entropy(prior.covariance))


class FeatureCountConsensusMetric:
    def __call__(self, prior, truth: MarginalDistribution) -> float:
        return -float(truth.size)


class ChiSquaredConsensusMetric:
    def __call__(self, prior: JointDistribution, truth) -> float:
        import jax.numpy as jnp

        cov = prior.covariance + jnp.diag(truth.get_variance())
        return float(chi_squared_cdf(prior.mean - truth.mean, cov))


class ChiSquaredIsValidCandidateMetric:
    def __init__(self, threshold: float = DEFAULT_CHI_SQUARED_THRESHOLD):
        self.threshold = threshold

    def __call__(self, pred: JointDistribution, truth) -> bool:
        import jax.numpy as jnp

        cov = pred.covariance + jnp.diag(truth.get_variance())
        p = float(chi_squared_cdf(pred.mean - truth.mean, cov))
        return p <= self.threshold


class AlwaysAcceptCandidateMetric:
    def __call__(self, pred, truth) -> bool:
        return True


class GaussianProcessRansacStrategy:
    def __init__(
        self,
        inlier_metric=None,
        consensus_metric=None,
        is_valid_candidate=None,
        grouper=None,
    ):
        self.inlier_metric = inlier_metric or NegativeLogLikelihood(
            JointDistribution
        )
        self.consensus_metric = consensus_metric or FeatureCountConsensusMetric()
        self.is_valid_candidate = (
            is_valid_candidate or AlwaysAcceptCandidateMetric()
        )
        self.grouper = grouper or LeaveOneOutGrouper()

    def get_indexer(self, dataset: RegressionDataset) -> Grouped:
        return group_by(dataset, self.grouper).indexers()

    def __call__(self, model, dataset: RegressionDataset) -> RansacFunctions:
        indexer = self.get_indexer(dataset)
        prior = model.prior(dataset.features)
        conditional = ConditionalGaussian(prior, dataset.targets)

        def fitter(groups):
            return conditional.fit_from_indices(
                indices_from_groups(indexer, groups)
            )

        def inlier_metric(group, fit):
            inds = indexer[group]
            pred = conditional._predict_joint(inds, fit)
            return self.inlier_metric(pred, conditional.get_truth(inds))

        def consensus_metric(groups):
            inds = indices_from_groups(indexer, groups)
            return self.consensus_metric(
                conditional.get_prior(inds), conditional.get_truth(inds)
            )

        def is_valid(groups):
            inds = indices_from_groups(indexer, groups)
            return self.is_valid_candidate(
                conditional.get_prior(inds), conditional.get_truth(inds)
            )

        return RansacFunctions(fitter, inlier_metric, consensus_metric, is_valid)


def DefaultGPRansacStrategy():
    return GaussianProcessRansacStrategy()


def gp_ransac_strategy(
    inlier_metric, consensus_metric, grouper, is_valid_candidate=None
):
    return GaussianProcessRansacStrategy(
        inlier_metric, consensus_metric, is_valid_candidate, grouper
    )


# ---------------------------------------------------------------------------
# Batched GP-RANSAC: all candidate fits in one vmapped device dispatch
# ---------------------------------------------------------------------------
def _batched_scores(conditional, cand_indices, idx_mat, inlier_metric):
    """(K, G) inlier-metric matrix: every candidate fit is a fixed-shape
    conditioning of the one precomputed prior (ransac_gp.hpp:117-180), so
    all K fits and all K·G group scores run as a single vmapped program —
    batched Cholesky + batched conditionals, replacing the
    reference's serial per-iteration loop (ransac.hpp:172-258)."""
    import jax
    import jax.numpy as jnp

    idx_mat = jnp.asarray(idx_mat)

    def score_one(cinds):
        fit = conditional.fit_from_indices(cinds)

        def group_metric(ginds):
            pred = conditional._predict_joint(ginds, fit)
            return inlier_metric(pred, conditional.get_truth(ginds))

        return jax.vmap(group_metric)(idx_mat)

    return jax.jit(jax.vmap(score_one))(jnp.asarray(cand_indices))


def _batched_validity(conditional, cand_indices, metric):
    """Vectorized candidate-validity pass for the metrics that have a
    traceable core; returns a boolean numpy array or None (→ host loop)."""
    import jax
    import jax.numpy as jnp

    if isinstance(metric, AlwaysAcceptCandidateMetric):
        return np.ones(len(cand_indices), dtype=bool)
    if isinstance(metric, ChiSquaredIsValidCandidateMetric):

        def p_one(cinds):
            pr = conditional.get_prior(cinds)
            tr = conditional.get_truth(cinds)
            cov = pr.covariance + jnp.diag(tr.get_variance())
            return chi_squared_cdf(pr.mean - tr.mean, cov)

        p = jax.jit(jax.vmap(p_one))(jnp.asarray(cand_indices))
        return np.asarray(p) <= metric.threshold
    return None


def ransac_gp_batched(
    strategy: "GaussianProcessRansacStrategy",
    model,
    dataset: RegressionDataset,
    config: RansacConfig,
    seed: int = 0,
) -> Optional[RansacOutput]:
    """Batched core loop for the GP strategy — identical RansacOutput to
    ``ransac()`` (same rng draw sequence, audit trail, and return codes),
    but all candidate fits/scores execute as ~one device dispatch.

    Returns None when the configuration cannot be batched (ragged groups or
    a non-traceable user metric) so the caller falls back to the serial
    path.
    """
    import jax

    indexer = strategy.get_indexer(dataset)
    keys = list(indexer.keys())
    sizes = {len(indexer[k]) for k in keys}
    if len(sizes) != 1:
        return None  # ragged groups: fixed-shape batching impossible
    idx_mat = np.stack([np.asarray(indexer[k]) for k in keys])  # (G, u)

    output = RansacOutput(return_code=RansacReturnCode.FAILURE)
    if (
        config.min_consensus_size >= len(keys)
        or config.min_consensus_size < config.random_sample_size
        or config.random_sample_size >= len(keys)
        or config.random_sample_size <= 0
        or config.max_iterations <= 0
    ):
        output.return_code = RansacReturnCode.INVALID_ARGUMENTS
        return output

    prior = model.prior(dataset.features)
    conditional = ConditionalGaussian(prior, dataset.targets)

    # reproduce the serial rng sequence: one draw per loop pass, up to
    # max_iterations valid + max_failed_candidates invalid draws
    rng = np.random.default_rng(seed)
    n_draws = config.max_iterations + max(config.max_failed_candidates, 0)
    draws = np.stack(
        [
            np.sort(rng.choice(len(keys), size=config.random_sample_size, replace=False))
            for _ in range(n_draws)
        ]
    )  # (D, s) group positions
    cand_indices = idx_mat[draws].reshape(len(draws), -1)  # (D, s·u)

    validity = _batched_validity(
        conditional, cand_indices, strategy.is_valid_candidate
    )
    if validity is None:
        return None  # non-traceable user validity metric

    # host replay of the serial control flow against precomputed validity
    valid: List = []  # (draw row, its RansacIteration)
    failed = 0
    exceeded = False
    for d in range(len(draws)):
        if len(valid) >= config.max_iterations:
            break
        iteration = RansacIteration()
        iteration.candidates = [keys[int(p)] for p in draws[d]]
        output.iterations.append(iteration)
        if not validity[d]:
            failed += 1
            if failed >= config.max_failed_candidates:
                exceeded = True
                break
            continue
        valid.append((d, iteration))
    if exceeded:
        output.return_code = RansacReturnCode.EXCEEDED_MAX_FAILED_CANDIDATES
        return output

    if valid:
        try:
            metrics = np.asarray(
                _batched_scores(
                    conditional,
                    cand_indices[np.asarray([d for d, _ in valid])],
                    idx_mat,
                    strategy.inlier_metric,
                )
            )  # (K, G)
        except (jax.errors.TracerArrayConversionError, TypeError):
            return None  # non-traceable user inlier metric

    fast_count = isinstance(
        strategy.consensus_metric, FeatureCountConsensusMetric
    )
    for k, (d, iteration) in enumerate(valid):
        cand_set = set(iteration.candidates)
        for g, key in enumerate(keys):
            if key in cand_set:
                continue
            value = float(metrics[k, g])
            if value <= config.inlier_threshold:
                iteration.inliers[key] = value
            else:
                iteration.outliers[key] = value
        consensus = iteration.consensus()
        if len(consensus) >= config.min_consensus_size:
            if fast_count:
                inds = indices_from_groups(indexer, consensus)
                iteration.consensus_metric_value = -float(len(inds))
            else:
                inds = indices_from_groups(indexer, consensus)
                iteration.consensus_metric_value = float(
                    strategy.consensus_metric(
                        conditional.get_prior(inds),
                        conditional.get_truth(inds),
                    )
                )
            if math.isnan(output.best.consensus_metric_value) or (
                iteration.consensus_metric_value
                < output.best.consensus_metric_value
            ):
                output.best = iteration

    if output.best.consensus():
        output.return_code = RansacReturnCode.SUCCESS
    else:
        output.return_code = RansacReturnCode.NO_CONSENSUS
    return output


# ---------------------------------------------------------------------------
# Ransac meta-model (ransac.hpp:428-526)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RansacFit:
    """Fit state: audit trail + the sub-model refit on the consensus set.

    Registered as a pytree (fit_model = child, audit trail = static aux)
    so RANSAC fits checkpoint/restore like every other fit
    (serialize/checkpoint.py; the reference serializes its RansacOutput
    through cereal, test_serialize.cc)."""

    ransac_output: RansacOutput
    fit_model: Optional[FitModel]

    def tree_flatten(self):
        return (self.fit_model,), self.ransac_output

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux, children[0])


jax.tree_util.register_pytree_node_class(RansacFit)


class Ransac(ModelBase):
    def __init__(
        self,
        sub_model,
        strategy,
        config: RansacConfig,
        seed: int = 0,
        use_batched: Optional[bool] = None,
    ):
        self.sub_model = sub_model
        self.strategy = strategy
        self.config = config
        self.seed = seed
        # None = auto: batch GP-strategy candidate fits through one vmapped
        # dispatch when groups are uniform and metrics traceable
        self.use_batched = use_batched

    @property
    def model_name(self):
        return f"ransac[{self.sub_model.model_name}]"

    def get_params(self):
        return self.sub_model.get_params()

    def _replace_param(self, name, param):
        return self._replace(sub_model=self.sub_model._replace_param(name, param))

    def _fit_impl(self, features, targets) -> RansacFit:
        dataset = RegressionDataset.create(features, targets)
        indexer = self.strategy.get_indexer(dataset)
        output = None
        batchable = isinstance(self.strategy, GaussianProcessRansacStrategy)
        if self.use_batched is None and batchable or self.use_batched:
            if not batchable:
                raise ValueError(
                    "use_batched requires a GaussianProcessRansacStrategy"
                )
            output = ransac_gp_batched(
                self.strategy, self.sub_model, dataset, self.config,
                seed=self.seed,
            )
        if output is None:
            functions = self.strategy(self.sub_model, dataset)
            output = ransac(
                functions, indexer.keys(), self.config, seed=self.seed
            )
        if not ransac_success(output.return_code):
            return RansacFit(output, None)
        good_inds = indices_from_groups(indexer, output.best.consensus())
        fit_model = self.sub_model.fit(dataset.subset(good_inds))
        return RansacFit(output, fit_model)

    def _predict_marginal(self, features, fit: RansacFit):
        self._check(fit)
        return fit.fit_model.predict(features).marginal()

    def _predict_joint(self, features, fit: RansacFit):
        self._check(fit)
        return fit.fit_model.predict(features).joint()

    def _predict_mean(self, features, fit: RansacFit):
        self._check(fit)
        return fit.fit_model.predict(features).mean()

    @staticmethod
    def _check(fit: RansacFit):
        if fit.fit_model is None:
            raise RuntimeError(
                f"RANSAC failed: {fit.ransac_output.return_code.name}"
            )
