"""Exact Gaussian-process regression.

JAX re-design of
/root/reference/include/albatross/src/models/gp.hpp:42-550.

Semantics mirror the reference:
* fit: wrap the training batch as Measurements, build the Gram matrix, add
  the target (measurement-noise) variance to the diagonal, subtract the mean
  function, factorize, and compute the information vector v = K⁻¹ y
  (gp.hpp:281-294).  The fit stores the *raw* (unwrapped) features, so
  cross-covariances at predict time see unwrapped features on both sides.
* predict mean  : K*ᵀ v                            (gp.hpp:82-86)
* predict marg. : prior_diag − colsum(K⁻¹K* ∘ K*)  (gp.hpp:87-101)
* predict joint : K** − K*ᵀ K⁻¹ K*                 (gp.hpp:103-113)
* log_likelihood: −NLL(y − m(X), K(X,X)) + Σ prior log-pdfs (gp.hpp:420-451);
  note the reference does NOT add target variance here, and neither do we.

The factorization is a blocked Cholesky (ops/blocked_cholesky.py) with an
explicit jitter knob instead of Eigen's pivoted LDLT.  Everything is a
pytree: ``jax.jit``/``jax.grad`` of fit→predict→NLML pipelines work directly,
which is how hyperparameter tuning (albatross_tpu.tuning) gets exact
gradients the reference had to finite-difference.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import jax
import jax.numpy as jnp

from ..core.dataset import RegressionDataset
from ..core.distributions import JointDistribution, MarginalDistribution
from ..core.parameters import map_join
from ..kernels.base import CovarianceFunction
from ..kernels.features import as_measurement
from ..kernels.means import MeanFunction, ZeroMean
from ..ops.linalg import CholeskyFactor, ExplainedCovariance
from .base import FitModel, ModelBase

LOG_2PI = math.log(2.0 * math.pi)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class GPFit:
    """Trained GP state (gp.hpp:42-77): features + factorized train
    covariance + information vector v = K⁻¹ y."""

    train_features: Any
    train_covariance: Any  # CholeskyFactor | BlockSymmetric | ExplainedCovariance
    information: jax.Array

    def tree_flatten(self):
        return (self.train_features, self.train_covariance, self.information), None

    @classmethod
    def tree_unflatten(cls, _, children):
        return cls(*children)


# ---------------------------------------------------------------------------
# Pure prediction math (gp.hpp:82-113)
# ---------------------------------------------------------------------------
def gp_mean_prediction(cross_cov, information):
    return cross_cov.T @ information


def gp_marginal_prediction(
    cross_cov, prior_variance, information, train_covariance
) -> MarginalDistribution:
    pred = gp_mean_prediction(cross_cov, information)
    explained = train_covariance.solve(cross_cov)
    explained_variance = jnp.sum(explained * cross_cov, axis=0)
    # The latent posterior variance at (or next to) a training point is ~0,
    # and in f32 the cancellation prior−explained can round a few ulps
    # negative (measured −2e-5 on a 60-pt sinc fit), NaN-ing downstream
    # sqrts.  True variance is ≥ 0, so clamp — but ONLY rounding-scale
    # negatives (|raw| small relative to the explained magnitude): a grossly
    # negative variance from a genuinely failed factorization passes through
    # so it surfaces (as NaN in any downstream sqrt) instead of silently
    # reading as zero uncertainty.  The reference runs in f64 where the
    # benign case never appears.
    raw = prior_variance - explained_variance
    scale = jnp.abs(prior_variance) + jnp.abs(explained_variance)
    # Window 1e-3·scale, NOT an eps-multiple: ``explained`` carries the
    # triangular-solve's forward error ~ κ(K)·eps — solve-amplified, not
    # plain dot rounding (measured −2e-5 relative on a κ~1e3 60-pt sinc
    # fit, ~200× the n·eps dot bound).  1e-3 covers κ up to ~1e4·(1/eps
    # margin) while still letting a genuinely failed factorization
    # (κ-unbounded, raw ~ −scale) pass through and surface as NaN.
    rounding_negative = raw >= -1e-3 * scale
    return MarginalDistribution(
        pred, jnp.where(rounding_negative, jnp.maximum(raw, 0.0), raw)
    )


def gp_joint_prediction(
    cross_cov, prior_cov, information, train_covariance
) -> JointDistribution:
    pred = gp_mean_prediction(cross_cov, information)
    explained_cov = cross_cov.T @ train_covariance.solve(cross_cov)
    return JointDistribution(pred, prior_cov - explained_cov)


def _nll_from_whitened(log_det, white):
    """½(log|K| + ‖L⁻¹dev‖² + n log 2π) — single source of truth for the
    NLL formula (likelihood.hpp:38-47; note: NO target variance added,
    matching gp.hpp:442-451)."""
    n = white.shape[0]
    return 0.5 * (log_det + jnp.sum(white * white) + n * LOG_2PI)


def negative_log_likelihood(deviation, chol: CholeskyFactor):
    """½(log|K| + devᵀK⁻¹dev + n log 2π)
    (/root/reference/include/albatross/src/evaluation/likelihood.hpp:38-47)."""
    return _nll_from_whitened(
        chol.log_determinant(), chol.sqrt_solve(deviation)
    )


def _make_gram_col_fn(x2, ls, sigma, diag_add, profile):
    """col_fn(j0, b) -> active rows j0..n of training-covariance column
    panel [j0, j0+b), diagonal (noise + jitter) included — the lazy gram
    producer the fused factorizations consume."""
    from ..kernels.distances import squared_distances
    from ..kernels.radial import radial_profile

    def col_fn(j0, b):
        col = radial_profile(
            profile, squared_distances(x2[j0:], x2[j0 : j0 + b]), ls, sigma
        )
        idx = jnp.arange(b)
        return col.at[idx, idx].add(jnp.asarray(diag_add, col.dtype))

    return col_fn


@functools.partial(
    jax.jit,
    static_argnames=(
        "profile",
        "algorithm",
        "panel_precision",
        "trailing_precision",
        "panel_factorizer",
        "block_size",
    ),
)
def _fused_gram_nlml(
    x2,
    ls,
    sigma,
    diag_add,
    rhs,
    *,
    profile: str,
    algorithm: str,
    panel_precision=None,
    trailing_precision=None,
    panel_factorizer=None,
    block_size=None,
):
    """(log|K|, L⁻¹ rhs) with the gram produced INSIDE the factorization
    (no standalone N×N covariance write).  Module-level jit keyed on array
    shapes + static knobs: eager callers get one dispatch (not the
    unrolled panel loop), and repeated calls reuse the trace (a per-call
    closure would retrace every time)."""
    from ..ops.blocked_cholesky import (
        blocked_cholesky_cols_fused,
        blocked_cholesky_left,
    )
    from ..ops.compensated import accurate_sum_of_logs

    n = rhs.shape[0]
    col_fn = _make_gram_col_fn(x2, ls, sigma, diag_add, profile)
    kw = dict(
        rhs=rhs,
        assemble=False,
        dtype=rhs.dtype,
        block_size=block_size,
        panel_precision=panel_precision if panel_precision else "auto",
        trailing_precision=trailing_precision,
        panel_factorizer=panel_factorizer,
    )
    if algorithm == "left":
        diag, white = blocked_cholesky_left(col_fn, n, **kw)
    else:
        diag, white = blocked_cholesky_cols_fused(col_fn, n, **kw)
    return 2.0 * accurate_sum_of_logs(diag), white


def match_fused_training_cov(kernel):
    """Pattern-match ``radial + diag-only terms`` and return
    (radial_leaf, ls, sigma, diag_scalar) or None.

    Recognized diag terms: IndependentNoise/Nugget with assume_unique (an
    equality mask would need the N² comparison the fusion avoids), each
    optionally wrapped in measurement_only — live in the training
    covariance, which is what the lazy-gram NLML builds.
    """
    from ..kernels.base import SumKernel
    from ..kernels.distances import EuclideanDistance
    from ..kernels.measurement import MeasurementOnly
    from ..kernels.noise import _EqualityNoise
    from ..kernels.radial import _RadialKernel

    terms = []

    def flatten(node):
        if isinstance(node, SumKernel):
            flatten(node.lhs)
            flatten(node.rhs)
        else:
            terms.append(node)

    flatten(kernel)
    radial = None
    diag_scalar = 0.0
    for term in terms:
        if isinstance(term, MeasurementOnly):
            term = term.sub
        if isinstance(term, _RadialKernel):
            if radial is not None or not term._profile_name:
                return None
            if not isinstance(term.distance_metric, EuclideanDistance):
                return None
            radial = term
        elif isinstance(term, _EqualityNoise):
            if not getattr(term, "assume_unique", False):
                return None
            diag_scalar = diag_scalar + term._sigma2()
        else:
            return None
    if radial is None:
        return None
    ls, sigma = radial._params_values()
    return radial, ls, sigma, diag_scalar


class GaussianProcess(ModelBase):
    """Exact GP regression model (gp.hpp:170-537)."""

    def __init__(
        self,
        covariance: CovarianceFunction,
        mean: Optional[MeanFunction] = None,
        model_name: Optional[str] = None,
        jitter: float = 0.0,
        safe_factorization: bool = False,
    ):
        self.covariance_function = covariance
        self.mean_function = mean if mean is not None else ZeroMean()
        self._model_name = model_name
        self.jitter = jitter
        # auto-escalating jitter on Cholesky failure (the generalization of
        # the reference's nugget-inflation safeguards, sparse_gp.hpp:348-352)
        self.safe_factorization = safe_factorization

    @property
    def model_name(self) -> str:
        if self._model_name:
            return self._model_name
        return (
            f"mean:{self.mean_function.name}"
            f"cov:{self.covariance_function.name}"
        )

    def get_params(self):
        return map_join(
            self.mean_function.get_params(),
            self.covariance_function.get_params(),
        )

    # -- fit (gp.hpp:281-294) ----------------------------------------------
    def compute_train_covariance(self, features) -> jnp.ndarray:
        measurements = as_measurement(features)
        return self.covariance_function(measurements)

    def _training_covariance(self, measurements, target_variance):
        """(K + diag(target_variance), jitter_applied).  On a GPU, high-D
        features matching the fused pattern take one Triton kernel pass
        that writes the gram, noise σ², target variance and jitter together
        (ops/triton_gram.py training_gram); jitter is then already in."""
        pieces = self._training_cov_fused_pieces(measurements)
        if pieces is not None:
            from ..ops.triton_gram import training_gram, use_triton_gram

            x2, ls, sigma, diag_add, profile = pieces
            if use_triton_gram(x2, x2):
                diag = jnp.full(x2.shape[:1], diag_add, x2.dtype)
                if target_variance is not None:
                    diag = diag + target_variance
                return training_gram(x2, ls, sigma, diag, profile), True
        cov = self.covariance_function(measurements)
        if target_variance is not None:
            cov = cov + jnp.diag(target_variance)
        return cov, False

    def _fit_impl(self, features, targets: MarginalDistribution) -> GPFit:
        measurements = as_measurement(features)
        with jax.named_scope("gp_gram"):
            cov, fused = self._training_covariance(
                measurements, targets.variance
            )
        zero_mean = self.mean_function.remove_from(measurements, targets.mean)
        with jax.named_scope("gp_cholesky"):
            chol = self._factorize(cov, jitter_applied=fused)
        with jax.named_scope("gp_information"):
            information = chol.solve(zero_mean)
        return GPFit(features, chol, information)

    def _factorize(self, cov, jitter_applied: bool = False) -> CholeskyFactor:
        jitter = 0.0 if jitter_applied else self.jitter
        if self.safe_factorization:
            return CholeskyFactor.factorize_safe(cov, initial_jitter=jitter)
        # covariances from the DSL are symmetric by construction (__call__
        # symmetrizes unless symmetric-exact): skip the redundant N² pass
        return CholeskyFactor.factorize(
            cov, jitter=jitter, assume_symmetric=True
        )

    # -- predictions (gp.hpp:305-366) ---------------------------------------
    def _cross(self, fit: GPFit, features):
        return self.covariance_function.matrix_or_none(
            fit.train_features, features
        )

    def _predict_mean(self, features, fit: GPFit):
        cross = self._cross(fit, features)
        pred = gp_mean_prediction(cross, fit.information)
        return self.mean_function.add_to(features, pred)

    def _predict_marginal(self, features, fit: GPFit) -> MarginalDistribution:
        cross = self._cross(fit, features)
        prior_variance = self.covariance_function.diag(features)
        pred = gp_marginal_prediction(
            cross, prior_variance, fit.information, fit.train_covariance
        )
        return MarginalDistribution(
            self.mean_function.add_to(features, pred.mean), pred.variance
        )

    def _predict_joint(self, features, fit: GPFit) -> JointDistribution:
        cross = self._cross(fit, features)
        prior_cov = self.covariance_function(features)
        pred = gp_joint_prediction(
            cross, prior_cov, fit.information, fit.train_covariance
        )
        return JointDistribution(
            self.mean_function.add_to(features, pred.mean), pred.covariance
        )

    # -- online update (gp.hpp:384-414) --------------------------------------
    def _update_impl(self, fit: GPFit, features, targets: MarginalDistribution):
        from ..core.dataset import concatenate_features
        from ..ops.block import build_block_symmetric

        pred = self._predict_joint(features, fit)
        delta = targets.mean - pred.mean
        S = pred.covariance
        if targets.variance is not None:
            S = S + jnp.diag(targets.variance)
        S_chol = CholeskyFactor.factorize(S, jitter=self.jitter)
        cross = self.covariance_function.matrix_or_none(
            fit.train_features, features
        )
        new_covariance = build_block_symmetric(
            fit.train_covariance, cross, S_chol
        )
        Si_delta = S_chol.solve(delta)
        top = fit.information - new_covariance.Ai_B @ Si_delta
        new_information = jnp.concatenate([top, Si_delta])
        new_features = concatenate_features([fit.train_features, features])
        return GPFit(new_features, new_covariance, new_information)

    # -- rebuild from an external prediction (gp.hpp:115-153, 236-245) -------
    def fit_from_prediction(self, features, prediction: JointDistribution):
        # the mean function must be removed from the prediction before
        # building the new fit, or it gets double counted when predictions
        # add it back (gp.hpp:238-240; regression test
        # test_gp.cc:344-371 — caught by the round-3 transcription)
        zero_mean = self.mean_function.remove_from(features, prediction.mean)
        prior = self.covariance_function(features)
        prior_chol = CholeskyFactor.factorize(prior, jitter=self.jitter)
        fit = GPFit(
            features,
            ExplainedCovariance(prior, prior - prediction.covariance),
            prior_chol.solve(zero_mean),
        )
        return FitModel(self, fit)

    # -- priors & likelihood (gp.hpp:420-451) --------------------------------
    def prior(self, features) -> JointDistribution:
        measurements = as_measurement(features)
        return JointDistribution(
            self.mean_function(measurements),
            self.covariance_function(measurements),
        )

    def _training_cov_fused_pieces(self, measurements):
        """Pattern-match the training covariance for the fused-gram NLML
        (config.CHOLESKY_ALGORITHM "left"/"right_fused"): returns
        ``(x2, ls, sigma, diag_add, profile)`` when the kernel is radial +
        diag-only noise over a single array feature batch, else None.  The
        pieces are plain arrays/floats so the jitted wrapper
        ``_fused_gram_nlml`` can take them as arguments (a stable jit cache
        keyed on shapes, not on a fresh closure per call)."""
        from ..kernels.features import Measurement

        if not isinstance(measurements, Measurement):
            return None
        matched = match_fused_training_cov(self.covariance_function)
        if matched is None:
            return None
        radial, ls, sigma, diag_scalar = matched
        leaves = jax.tree_util.tree_leaves(measurements.value)
        if len(leaves) != 1 or leaves[0].ndim > 2:
            return None
        x = leaves[0]
        x2 = x[:, None] if x.ndim == 1 else x
        diag_add = diag_scalar + self.jitter
        return x2, ls, sigma, diag_add, radial._profile_name

    def _training_cov_col_fn(self, measurements):
        """Active-row column-panel builder over the matched pieces (kept
        for the nlml_terms(col_fn=...) API and tests); returns None when
        the pattern does not match."""
        pieces = self._training_cov_fused_pieces(measurements)
        if pieces is None:
            return None
        x2, ls, sigma, diag_add, profile = pieces
        return _make_gram_col_fn(x2, ls, sigma, diag_add, profile)

    def log_likelihood(self, dataset: RegressionDataset):
        measurements = as_measurement(dataset.features)
        zero_mean = self.mean_function.remove_from(
            measurements, dataset.targets.mean
        )
        from .. import config

        algorithm = config.CHOLESKY_ALGORITHM
        if (
            algorithm in ("left", "right_fused")
            and config.CHOLESKY_PRECISION != "double_word"
            and not config.NLML_COMPENSATED
            and not self.safe_factorization
            and zero_mean.shape[0] > 2048
        ):
            pieces = self._training_cov_fused_pieces(measurements)
            if pieces is not None:
                x2, ls, sigma, diag_add, profile = pieces
                trailing = config.CHOLESKY_PRECISION
                if trailing is None and config.CHOLESKY_TRAILING_BF16:
                    trailing = "bf16"
                log_det, white = _fused_gram_nlml(
                    x2,
                    jnp.asarray(ls),
                    jnp.asarray(sigma),
                    jnp.asarray(diag_add),
                    zero_mean,
                    profile=profile,
                    algorithm=algorithm,
                    panel_precision=config.CHOLESKY_PRECISION,
                    trailing_precision=trailing,
                    panel_factorizer=config.PANEL_FACTORIZER,
                    block_size=config.CHOLESKY_BLOCK_SIZE,
                )
                return (
                    -_nll_from_whitened(log_det, white)
                    + self.prior_log_likelihood()
                )
        cov, fused = self._training_covariance(measurements, None)
        jitter = 0.0 if fused else self.jitter

        if config.NLML_COMPENSATED and not self.safe_factorization:
            # accuracy mode: double-word reductions + one refinement step on
            # the quadratic term (ops/compensated.py) — K passed alongside
            # the factor so the residual sees exactly what was factorized
            from ..ops.compensated import compensated_nll

            chol = self._factorize(cov, jitter_applied=fused)
            K_eff = (
                cov
                if not jitter
                else cov + jitter * jnp.eye(cov.shape[0], dtype=cov.dtype)
            )
            ll = -compensated_nll(chol, K_eff, zero_mean)
        elif self.safe_factorization:
            chol = self._factorize(cov, jitter_applied=fused)
            ll = -negative_log_likelihood(zero_mean, chol)
        else:
            # fused factorize+whiten WITHOUT assembling the (n, n) factor:
            # forward substitution reuses the blocked factorization's panel
            # inverses, and the NLML only needs the panel diagonals +
            # whitened vector, so the final O(N²) factor write is skipped
            # (ops/linalg.py nlml_terms).  Gradients go through XLA
            # autodiff: a closed-form custom VJP (potri-style explicit
            # inverse) does n³ backward GEMM flops against autodiff's
            # 2n³/3 and was less accurate; see ops/nlml.py.
            log_det, white = CholeskyFactor.nlml_terms(
                cov, zero_mean, jitter=jitter, assume_symmetric=True
            )
            ll = -_nll_from_whitened(log_det, white)
        return ll + self.prior_log_likelihood()

    # -- fast cross-validation (gp.hpp:465-504) ------------------------------
    def cross_validated_predictions(
        self, dataset: RegressionDataset, indexers, predict_type
    ):
        """Fast LOO/LOGO: fit once, then per-group held-out predictions from
        inverse blocks (gp.hpp:465-482).  The raw target mean is passed —
        the information vector already accounts for the mean function."""
        from ..evaluation.cross_validation_utils import held_out_predictions

        fit_model = self.fit(dataset)
        return held_out_predictions(
            fit_model.fit.train_covariance,
            dataset.targets.mean,
            fit_model.fit.information,
            indexers,
            predict_type,
        )


def gp_from_covariance(
    covariance: CovarianceFunction, model_name: Optional[str] = None, **kwargs
) -> GaussianProcess:
    return GaussianProcess(covariance, model_name=model_name, **kwargs)


def gp_from_covariance_and_mean(
    covariance: CovarianceFunction,
    mean: MeanFunction,
    model_name: Optional[str] = None,
    **kwargs,
) -> GaussianProcess:
    return GaussianProcess(covariance, mean, model_name=model_name, **kwargs)
