"""Sparse Gaussian-process regression (FITC / PITC).

JAX re-design of
/root/reference/include/albatross/src/models/sparse_gp.hpp:20-712.

Method (Snelson & Ghahramani FITC / Quiñonero-Candela & Rasmussen PITC) with
the QR-stabilized formulation of Foster et al. 2009 (math doc comment at
sparse_gp.hpp:126-231):

    A = blockdiag(K_ff − Q_ff) + nugget          per grouper group
    B = [A^{-1/2} K_fu; K_uu^{T/2}] = Q R        (tall QR)
    v = R^{-1} Q_1ᵀ A^{-1/2} y
    predict:  m* = K_*uᵀ v
              C* = K_** − Q_sqrtᵀQ_sqrt + S_sqrtᵀS_sqrt
              with Q_sqrt = K_uu^{-1/2} K_u*, S_sqrt = R^{-ᵀ} K_u*
    NLML via the matrix determinant lemma (sparse_gp.hpp:538-603).

Differences from the reference:
* the per-group block computations (K_ff blocks, Q_ff blocks, block Cholesky,
  block solves) are *batched* over the group axis — one vmapped Cholesky
  instead of a ThreadPool loop (ops/block.py);
* the rank-revealing pivoted QR (ColPivHouseholder / SuiteSparse SPQR) is
  replaced by XLA's blocked Householder QR; the nuggets the reference already
  adds (measurement_nugget on A, inducing_nugget on K_uu) keep B full rank,
  and the reference's own R-diagonal inflation safeguard
  (sparse_gp.hpp:348-352, details::cSparseRNugget) is applied when the
  numerical rank drops.  This matches the reference's SPQR-free behavior
  while staying GEMM-friendly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.linalg import solve_triangular

from ..core.dataset import RegressionDataset, subset_features
from ..core.distributions import JointDistribution, MarginalDistribution
from ..core.parameters import Parameter, map_join
from ..core.priors import LogScaleUniformPrior
from ..indexing.grouping import group_by
from ..kernels.base import CovarianceFunction
from ..kernels.features import as_measurement
from ..kernels.means import MeanFunction, ZeroMean
from ..ops.block import BlockDiagonalCholesky, DiagonalCholesky, pad_blocks
from ..ops.linalg import CholeskyFactor
from .base import FitModel, ModelBase

DEFAULT_NUGGET = 1e-8
SPARSE_R_NUGGET = 1e-10
MEASUREMENT_NUGGET_NAME = "measurement_nugget"
INDUCING_NUGGET_NAME = "inducing_nugget"
PARAMETER_EPSILON = 2.220446049250313e-16
PARAMETER_MAX = 1.7976931348623157e308


# ---------------------------------------------------------------------------
# Inducing point strategies (sparse_gp.hpp:34-70)
# ---------------------------------------------------------------------------
class UniformlySpacedInducingPoints:
    def __init__(self, num_points: int = 10):
        self.num_points = num_points

    def __call__(self, covariance, features):
        # traceable (min/max of traced features is fine; num_points static),
        # so sparse fits can live inside jit
        x = jnp.asarray(features).reshape(-1)
        return jnp.linspace(jnp.min(x), jnp.max(x), self.num_points)


class StateSpaceInducingPointStrategy:
    def __call__(self, covariance, features):
        ssr = covariance.state_space_representation(features)
        if ssr is None:
            raise TypeError(
                "covariance function has no state_space_representation for "
                "these features (_ssr_impl missing in the reference's terms)"
            )
        return ssr


class EveryPointGrouper:
    """Each point its own group => FITC (fully independent)."""

    def __call__(self, features):
        n = jax.tree_util.tree_leaves(features)[0].shape[0]
        return np.arange(n)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class SparseGPFit:
    """Trained sparse-GP state (sparse_gp.hpp:91-124)."""

    train_features: Any  # inducing features u
    train_covariance: CholeskyFactor  # K_uu factorization
    R: jax.Array  # upper-triangular from QR of B
    information: jax.Array  # v
    numerical_rank: int

    def tree_flatten(self):
        return (
            self.train_features,
            self.train_covariance,
            self.R,
            self.information,
        ), self.numerical_rank

    @classmethod
    def tree_unflatten(cls, rank, children):
        return cls(*children, rank)

    def shift_mean(self, mean_shift) -> "SparseGPFit":
        """information += K_uu⁻¹ shift (sparse_gp.hpp:112-115)."""
        return SparseGPFit(
            self.train_features,
            self.train_covariance,
            self.R,
            self.information + self.train_covariance.solve(mean_shift),
            self.numerical_rank,
        )


def _numerical_rank(R: jnp.ndarray, rows: int):
    diag = jnp.abs(jnp.diagonal(R))
    tol = jnp.finfo(R.dtype).eps * rows * jnp.max(diag)
    return jnp.sum(diag > tol)


def _qr_r_and_v(B: jnp.ndarray, y_augmented: jnp.ndarray):
    """QR of tall B; returns (R with safeguard inflation, v = R⁻¹Q₁ᵀy, rank).

    Fully traceable: the reference's rank-deficiency safeguard (inflate R's
    diagonal, sparse_gp.hpp:348-352) applies via a where so sparse fits work
    under jit; the returned rank is a python int eagerly, -1 when traced.
    """
    m = B.shape[1]
    Q, R = jnp.linalg.qr(B, mode="reduced")
    rank_arr = _numerical_rank(R, B.shape[0])
    R = R + jnp.where(rank_arr < m, SPARSE_R_NUGGET, 0.0) * jnp.eye(
        m, dtype=R.dtype
    )
    rank = -1 if isinstance(rank_arr, jax.core.Tracer) else int(rank_arr)
    v = solve_triangular(R, Q.T @ y_augmented, lower=False)
    return R, v, rank


def _r_sqrt_solve(R: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    """R⁻ᵀ rhs (qr_utils.hpp sqrt_solve with identity permutation)."""
    return solve_triangular(R.T, rhs, lower=True)


class SparseGaussianProcessRegression(ModelBase):
    """FITC/PITC sparse GP (sparse_gp.hpp:232-712)."""

    def __init__(
        self,
        covariance: CovarianceFunction,
        mean: Optional[MeanFunction] = None,
        grouper: Optional[Callable] = None,
        inducing_point_strategy: Optional[Callable] = None,
        model_name: Optional[str] = None,
        measurement_nugget: float = DEFAULT_NUGGET,
        inducing_nugget: float = DEFAULT_NUGGET,
    ):
        self.covariance_function = covariance
        self.mean_function = mean if mean is not None else ZeroMean()
        self.grouper = grouper if grouper is not None else EveryPointGrouper()
        self.inducing_point_strategy = (
            inducing_point_strategy
            if inducing_point_strategy is not None
            else UniformlySpacedInducingPoints()
        )
        self._model_name = model_name
        self.measurement_nugget = Parameter(
            measurement_nugget,
            LogScaleUniformPrior(PARAMETER_EPSILON, PARAMETER_MAX),
        )
        self.inducing_nugget = Parameter(
            inducing_nugget,
            LogScaleUniformPrior(PARAMETER_EPSILON, PARAMETER_MAX),
        )

    @property
    def model_name(self) -> str:
        return self._model_name or (
            f"sparse_mean:{self.mean_function.name}"
            f"cov:{self.covariance_function.name}"
        )

    def get_params(self):
        params = map_join(
            self.mean_function.get_params(),
            self.covariance_function.get_params(),
        )
        params[MEASUREMENT_NUGGET_NAME] = self.measurement_nugget
        params[INDUCING_NUGGET_NAME] = self.inducing_nugget
        return params

    def _replace_param(self, name, param):
        if name == MEASUREMENT_NUGGET_NAME:
            return self._replace(measurement_nugget=param)
        if name == INDUCING_NUGGET_NAME:
            return self._replace(inducing_nugget=param)
        return super()._replace_param(name, param)

    def _cross_covariance(self, measurements, inducing_features):
        """K_fu assembly hook — the distributed subclass
        (parallel/sparse.py) overrides this with row-sharded panels."""
        return self.covariance_function.matrix_or_none(
            measurements, inducing_features
        )

    # -- internal components (sparse_gp.hpp:631-706) -------------------------
    def _compute_internal_components(self, inducing_features, features, targets):
        """Returns (A_chol, K_uu_chol, K_fu, y_raw, y_zero_mean, order).

        Features are reordered by group; all per-group work is batched.
        """
        indexers = group_by(features, self.grouper).indexers()
        order = np.concatenate([np.asarray(i) for i in indexers.values()])
        order_j = jnp.asarray(order)

        reordered = subset_features(features, order_j)
        measurements = as_measurement(reordered)
        target_mean = targets.mean[order_j]
        target_var = (
            targets.variance[order_j] if targets.variance is not None else None
        )

        K_fu = self._cross_covariance(measurements, inducing_features)
        K_uu = self.covariance_function(inducing_features)
        K_uu = K_uu + self.inducing_nugget.value * jnp.eye(
            K_uu.shape[0], dtype=K_uu.dtype
        )
        K_uu_chol = CholeskyFactor.factorize(K_uu)
        # P with Q_ff = Pᵀ P
        P = K_uu_chol.sqrt_solve(K_fu.T)

        sizes = [len(idx) for idx in indexers.values()]
        offsets = np.concatenate([[0], np.cumsum(sizes)])

        # FITC fast path: all groups singletons -> A is a plain diagonal,
        # no per-group grams needed (one fused elementwise epilogue).
        if all(s == 1 for s in sizes):
            k_diag = self.covariance_function.diag(measurements)
            if target_var is not None:
                k_diag = k_diag + target_var
            q_diag = jnp.sum(P * P, axis=0)
            raw = k_diag - q_diag
            # The FITC residual k − q is ~0 wherever the inducing set
            # covers a training point (exactly 0 when they coincide), and
            # in f32 the cancellation can round a few ulps negative
            # (measured −3.5e-7 with an endpoint inducing point on a unit
            # kernel), NaN-ing the sqrt.  Clamp ONLY rounding-scale
            # negatives — the same policy as gp_marginal_prediction
            # (models/gp.py) — so a genuinely indefinite residual (bad
            # kernel, broken factorization) still surfaces as NaN instead
            # of being silently floored.  The reference runs f64 LDLT
            # where the benign case stays positive (sparse_gp.hpp nugget).
            # Window 1e-3·scale, NOT an eps-multiple: P carries the K_uu
            # triangular-solve forward error ~ κ(K_uu)·eps, so the k−q
            # cancellation can round κ·eps·scale negative — far past the
            # u·eps dot bound once the inducing gram is even moderately
            # conditioned (the measured −3.5e-7 was a κ~1 unit kernel).
            # 1e-3 covers κ up to ~1e4 while a genuinely indefinite
            # residual (raw ~ −scale) still passes through and NaNs.
            scale = k_diag + q_diag
            raw = jnp.where((raw < 0) & (raw >= -1e-3 * scale), 0.0, raw)
            a_diag = raw + self.measurement_nugget.value
            A_chol = DiagonalCholesky(jnp.sqrt(a_diag))
        else:
            # PITC: per-group residual blocks A_g = K_g − Q_g (+ nuggets),
            # identity-padded to a shared size, factorized as ONE batched
            # Cholesky (the host loop only builds the graph).
            blocks = []
            for g in range(len(sizes)):
                sl = slice(int(offsets[g]), int(offsets[g + 1]))
                sub = subset_features(reordered, jnp.arange(sl.start, sl.stop))
                Kg = self.covariance_function(as_measurement(sub))
                if target_var is not None:
                    Kg = Kg + jnp.diag(target_var[sl])
                P_cols = P[:, sl]
                Ag = Kg - P_cols.T @ P_cols
                Ag = Ag + self.measurement_nugget.value * jnp.eye(
                    Ag.shape[0], dtype=Kg.dtype
                )
                blocks.append(Ag)
            stacked, sizes_arr = pad_blocks(blocks)
            A_chol = BlockDiagonalCholesky(
                jnp.linalg.cholesky(stacked), sizes_arr
            )

        y_raw = target_mean
        y_zero_mean = self.mean_function.remove_from(reordered, target_mean)
        return A_chol, K_uu_chol, K_fu, y_zero_mean, order

    # -- fit (sparse_gp.hpp:377-404) -----------------------------------------
    def _fit_impl(self, features, targets: MarginalDistribution) -> SparseGPFit:
        u = self.inducing_point_strategy(self.covariance_function, features)
        A_chol, K_uu_chol, K_fu, y, _ = self._compute_internal_components(
            u, features, targets
        )
        m = K_uu_chol.L.shape[0]
        B = jnp.concatenate([A_chol.sqrt_solve(K_fu), K_uu_chol.L.T], axis=0)
        y_aug = jnp.concatenate(
            [A_chol.sqrt_solve(y), jnp.zeros((m,), dtype=y.dtype)]
        )
        R, v, rank = _qr_r_and_v(B, y_aug)
        return SparseGPFit(u, K_uu_chol, R, v, rank)

    # -- online update (sparse_gp.hpp:310-357) -------------------------------
    def _update_impl(
        self, fit: SparseGPFit, features, targets: MarginalDistribution
    ) -> SparseGPFit:
        A_chol, _, K_fu, y, _ = self._compute_internal_components(
            fit.train_features, features, targets
        )
        # B = [R_old; A^{-1/2} K_fu],  y_aug = [R_old v_old; A^{-1/2} y]
        B = jnp.concatenate([fit.R, A_chol.sqrt_solve(K_fu)], axis=0)
        y_aug = jnp.concatenate([fit.R @ fit.information, A_chol.sqrt_solve(y)])
        R, v, rank = _qr_r_and_v(B, y_aug)
        return SparseGPFit(
            fit.train_features, fit.train_covariance, R, v, rank
        )

    # -- predictions (sparse_gp.hpp:467-536) ---------------------------------
    def _cross(self, fit: SparseGPFit, features):
        return self.covariance_function.matrix_or_none(
            fit.train_features, features
        )

    def _predict_mean(self, features, fit: SparseGPFit):
        cross = self._cross(fit, features)
        return self.mean_function.add_to(features, cross.T @ fit.information)

    def _predict_marginal(self, features, fit: SparseGPFit):
        cross = self._cross(fit, features)
        mean = self.mean_function.add_to(features, cross.T @ fit.information)
        prior_variance = self.covariance_function.diag(features)
        Q_sqrt = fit.train_covariance.sqrt_solve(cross)
        S_sqrt = _r_sqrt_solve(fit.R, cross)
        variance = (
            prior_variance
            - jnp.sum(Q_sqrt * Q_sqrt, axis=0)
            + jnp.sum(S_sqrt * S_sqrt, axis=0)
        )
        return MarginalDistribution(mean, variance)

    def _predict_joint(self, features, fit: SparseGPFit):
        cross = self._cross(fit, features)
        mean = self.mean_function.add_to(features, cross.T @ fit.information)
        prior_cov = self.covariance_function(features)
        Q_sqrt = fit.train_covariance.sqrt_solve(cross)
        S_sqrt = _r_sqrt_solve(fit.R, cross)
        covariance = prior_cov - Q_sqrt.T @ Q_sqrt + S_sqrt.T @ S_sqrt
        return JointDistribution(mean, covariance)

    # -- NLML via the determinant lemma (sparse_gp.hpp:538-603) --------------
    def log_likelihood(self, dataset: RegressionDataset):
        u = self.inducing_point_strategy(
            self.covariance_function, dataset.features
        )
        A_chol, K_uu_chol, K_fu, y, _ = self._compute_internal_components(
            u, dataset.features, dataset.targets
        )
        m = K_uu_chol.L.shape[0]
        B = jnp.concatenate([A_chol.sqrt_solve(K_fu), K_uu_chol.L.T], axis=0)
        Q, R = jnp.linalg.qr(B, mode="reduced")

        log_det_a = A_chol.log_determinant()
        from ..ops.compensated import accurate_sum_of_logs

        log_det_r = accurate_sum_of_logs(jnp.abs(jnp.diagonal(R)))
        log_det_K_uu = K_uu_chol.log_determinant()
        log_det = log_det_a + 2.0 * log_det_r - log_det_K_uu

        y_a = A_chol.solve(y)
        y_b = _r_sqrt_solve(R, K_fu.T @ y_a)
        log_quadratic = jnp.sum(y * y_a) - jnp.sum(y_b * y_b)

        n = y.shape[0]
        log_dimension = n * jnp.log(2.0 * jnp.pi)
        return (
            -0.5 * (log_det + log_quadratic + log_dimension)
            + self.prior_log_likelihood()
        )

    # -- rebase (sparse_gp.hpp:406-462) --------------------------------------
    def fit_from_prediction(self, new_inducing_points, prediction: JointDistribution):
        K_zz = self.covariance_function(new_inducing_points)
        train_covariance = CholeskyFactor.factorize(K_zz)
        cov = prediction.covariance + DEFAULT_NUGGET * jnp.eye(
            prediction.size, dtype=prediction.covariance.dtype
        )
        information = train_covariance.solve(prediction.mean)
        # Sigma = K_zz^-1 C K_zz^-1 => B_z = C^{-1/2} K_zz
        C_chol = CholeskyFactor.factorize(cov)
        sigma_inv_sqrt = C_chol.sqrt_solve(K_zz)
        Q, R = jnp.linalg.qr(sigma_inv_sqrt, mode="reduced")
        rank_arr = _numerical_rank(R, R.shape[0])
        rank = -1 if isinstance(rank_arr, jax.core.Tracer) else int(rank_arr)
        fit = SparseGPFit(
            new_inducing_points, train_covariance, R, information, rank
        )
        return FitModel(self, fit)


def rebase_inducing_points(fit_model: FitModel, new_inducing_points):
    """Move a sparse fit onto new inducing points (sparse_gp.hpp:714-726):
    predict the joint at the new points, then fit_from_prediction."""
    prediction = fit_model.predict(new_inducing_points).joint()
    return fit_model.model.fit_from_prediction(new_inducing_points, prediction)


def sparse_gp_from_covariance(
    covariance, model_name=None, **kwargs
) -> SparseGaussianProcessRegression:
    return SparseGaussianProcessRegression(
        covariance, model_name=model_name, **kwargs
    )


def sparse_gp_from_covariance_and_mean(
    covariance, mean, model_name=None, **kwargs
) -> SparseGaussianProcessRegression:
    return SparseGaussianProcessRegression(
        covariance, mean, model_name=model_name, **kwargs
    )
