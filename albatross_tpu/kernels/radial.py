"""Radial covariance kernels.

JAX re-design of the reference radial kernels
(/root/reference/include/albatross/src/covariance_functions/radial.hpp:131-529).

Parameter names, defaults, priors and the closed-form covariances match the
reference exactly (kernel-value parity is golden-tested against gpytorch
values, mirroring /root/reference/python/gpytorch_covariance.py).  Gram
evaluation is batched: one fused reduction for the distances, the radial
profile as its elementwise epilogue.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..core.parameters import Parameter
from ..core.priors import NonNegativePrior, PositivePrior
from .base import CovarianceFunction
from .distances import (
    AngularDistance,
    DistanceMetric,
    EuclideanDistance,
    as_matrix,
)

DEFAULT_LENGTH_SCALE = 100000.0
DEFAULT_RADIAL_SIGMA = 10.0

MAX_NEWTON_ITERATIONS = 50
MAX_LENGTH_SCALE_RATIO = 1e7
MIN_LENGTH_SCALE_RATIO = 1e-7


# ---------------------------------------------------------------------------
# Closed-form profiles (traceable; accept arrays)
# ---------------------------------------------------------------------------
def squared_exponential_covariance(distance, length_scale, sigma=1.0):
    safe = jnp.where(length_scale > 0.0, length_scale, 1.0)
    value = sigma * sigma * jnp.exp(-jnp.square(distance / safe))
    return jnp.where(length_scale > 0.0, value, 0.0)


def exponential_covariance(distance, length_scale, sigma=1.0):
    safe = jnp.where(length_scale > 0.0, length_scale, 1.0)
    value = sigma * sigma * jnp.exp(-jnp.abs(distance / safe))
    return jnp.where(length_scale > 0.0, value, 0.0)


def matern_32_covariance(distance, length_scale, sigma=1.0):
    safe = jnp.where(length_scale > 0.0, length_scale, 1.0)
    sqrt_3_d = math.sqrt(3.0) * distance / safe
    value = sigma * sigma * (1.0 + sqrt_3_d) * jnp.exp(-sqrt_3_d)
    return jnp.where(length_scale > 0.0, value, 0.0)


def matern_52_covariance(distance, length_scale, sigma=1.0):
    safe = jnp.where(length_scale > 0.0, length_scale, 1.0)
    sqrt_5_d = math.sqrt(5.0) * distance / safe
    value = (
        sigma * sigma * (1.0 + sqrt_5_d + sqrt_5_d * sqrt_5_d / 3.0)
        * jnp.exp(-sqrt_5_d)
    )
    return jnp.where(length_scale > 0.0, value, 0.0)


def radial_profile(profile: str, d2, length_scale, sigma):
    """Radial profile ``profile`` (a ``_profile_name``) on SQUARED
    distances — the form the lazy-gram factorization builds its columns
    with (d² avoids a sqrt for the squared exponential).  A length scale
    ≤ 0 gives 0, as the distance-based profiles above do."""
    positive = length_scale > 0.0
    ls = jnp.where(positive, length_scale, 1.0)
    s2 = sigma * sigma
    if profile == "squared_exponential":
        value = s2 * jnp.exp(-d2 / (ls * ls))
    elif profile in ("exponential", "matern_32", "matern_52"):
        scaled = jnp.sqrt(jnp.maximum(d2, 0.0)) / ls
        if profile == "exponential":
            value = s2 * jnp.exp(-scaled)
        elif profile == "matern_32":
            sqrt3 = math.sqrt(3.0) * scaled
            value = s2 * (1.0 + sqrt3) * jnp.exp(-sqrt3)
        else:
            sqrt5 = math.sqrt(5.0) * scaled
            value = s2 * (1.0 + sqrt5 + sqrt5 * sqrt5 / 3.0) * jnp.exp(-sqrt5)
    else:
        raise ValueError(f"unknown profile {profile}")
    return jnp.where(positive, value, 0.0)


class _RadialKernel(CovarianceFunction):
    """Shared machinery: distance -> profile, diag, 1-D inducing grids."""

    _length_scale_param: str
    _sigma_param: str
    _profile_name: str = ""  # radial_profile tag ("" = no lazy-gram path)
    _ssr_points_per_length_scale: float = 10.0

    def _profile(self, distance, length_scale, sigma):
        raise NotImplementedError

    def _params_values(self):
        ls = getattr(self, self._length_scale_param).value
        sigma = getattr(self, self._sigma_param).value
        return ls, sigma

    def _matrix(self, X, Y, x_meas, y_meas):
        ls, sigma = self._params_values()
        gram = self._triton_gram(X, Y, ls, sigma)
        if gram is not None:
            return gram
        d = self.distance_metric.pairwise(X, Y)
        return self._profile(d, ls, sigma)

    def _triton_gram(self, X, Y, ls, sigma):
        """The GPU kernel gram (ops/triton_gram.py) for high-D f32 array
        batches under a Euclidean metric, else None."""
        if not self._profile_name or not isinstance(
            self.distance_metric, EuclideanDistance
        ):
            return None
        if not (isinstance(X, jax.Array) and isinstance(Y, jax.Array)):
            return None
        from ..ops.triton_gram import radial_gram, use_triton_gram

        X, Y = as_matrix(X), as_matrix(Y)
        if not use_triton_gram(X, Y):
            return None
        return radial_gram(X, Y, ls, sigma, self._profile_name)

    def _symmetric_exact(self, X):
        from .distances import RadialDistance

        # Euclidean and radial distances are per-pair elementwise formulas;
        # AngularDistance uses a matmul reduction whose transpose-exactness
        # is not guaranteed.
        return isinstance(
            self.distance_metric, (EuclideanDistance, RadialDistance)
        )

    def _diag(self, X, x_meas):
        ls, sigma = self._params_values()
        d = self.distance_metric.diag(X)
        return self._profile(d, ls, sigma)

    def state_space_representation(self, X):
        """Uniform 1-D grid with ~points_per_ls points per length scale
        (radial.hpp:158-168, 257-267).  Host-side: grid size is data- and
        parameter-dependent, so this runs outside jit by design."""
        ls, _ = self._params_values()
        x = np.asarray(X).reshape(-1)
        lo, hi = float(x.min()), float(x.max())
        n = max(
            3,
            int(
                math.ceil(
                    self._ssr_points_per_length_scale * (hi - lo) / float(ls)
                )
            ),
        )
        return jnp.linspace(lo, hi, n)


class SquaredExponential(_RadialKernel):
    """sigma² exp(-(d/ℓ)²)  (radial.hpp:131-189)."""

    _length_scale_param = "squared_exponential_length_scale"
    _sigma_param = "sigma_squared_exponential"
    _profile_name = "squared_exponential"
    _ssr_points_per_length_scale = 10.0

    def __init__(
        self,
        length_scale=DEFAULT_LENGTH_SCALE,
        sigma=DEFAULT_RADIAL_SIGMA,
        distance_metric: DistanceMetric = EuclideanDistance(),
    ):
        if isinstance(distance_metric, AngularDistance):
            # Gneiting: strictly PSD on spheres fails for the Gaussian profile.
            raise TypeError(
                "SquaredExponential covariance with AngularDistance is not PSD."
            )
        self.squared_exponential_length_scale = Parameter(
            length_scale, PositivePrior()
        )
        self.sigma_squared_exponential = Parameter(sigma, NonNegativePrior())
        self.distance_metric = distance_metric

    @property
    def name(self):
        return f"squared_exponential[{self.distance_metric.name}]"

    def _profile(self, distance, length_scale, sigma):
        return squared_exponential_covariance(distance, length_scale, sigma)

    def _matrix(self, X, Y, x_meas, y_meas):
        ls, sigma = self._params_values()
        gram = self._triton_gram(X, Y, ls, sigma)
        if gram is not None:
            return gram
        metric = self.distance_metric
        if isinstance(metric, EuclideanDistance):
            # use d² directly, skipping sqrt+square
            d2 = metric.pairwise_squared(X, Y)
            safe = jnp.where(ls > 0.0, ls, 1.0)
            value = sigma * sigma * jnp.exp(-d2 / (safe * safe))
            return jnp.where(ls > 0.0, value, 0.0)
        return self._profile(metric.pairwise(X, Y), ls, sigma)

    def derive_length_scale(self, reference_distance, sigma, std_dev_increase):
        return derive_squared_exponential_length_scale(
            reference_distance, sigma, std_dev_increase
        )


class Exponential(_RadialKernel):
    """sigma² exp(-|d|/ℓ)  (radial.hpp:239-287)."""

    _length_scale_param = "exponential_length_scale"
    _sigma_param = "sigma_exponential"
    _profile_name = "exponential"
    _ssr_points_per_length_scale = 20.0

    def __init__(
        self,
        length_scale=DEFAULT_LENGTH_SCALE,
        sigma=DEFAULT_RADIAL_SIGMA,
        distance_metric: DistanceMetric = EuclideanDistance(),
    ):
        self.exponential_length_scale = Parameter(length_scale, PositivePrior())
        self.sigma_exponential = Parameter(sigma, NonNegativePrior())
        self.distance_metric = distance_metric

    @property
    def name(self):
        return f"exponential[{self.distance_metric.name}]"

    def _profile(self, distance, length_scale, sigma):
        return exponential_covariance(distance, length_scale, sigma)

    def derive_length_scale(self, reference_distance, sigma, std_dev_increase):
        return derive_exponential_length_scale(
            reference_distance, sigma, std_dev_increase
        )


class Matern32(_RadialKernel):
    """sigma² (1+√3 d/ℓ) exp(-√3 d/ℓ)  (radial.hpp:421-459)."""

    _length_scale_param = "matern_32_length_scale"
    _sigma_param = "sigma_matern_32"
    _profile_name = "matern_32"

    def __init__(
        self,
        length_scale=DEFAULT_LENGTH_SCALE,
        sigma=DEFAULT_RADIAL_SIGMA,
        distance_metric: DistanceMetric = EuclideanDistance(),
    ):
        if isinstance(distance_metric, AngularDistance):
            raise TypeError("Matern32 covariance with AngularDistance is not PSD.")
        self.matern_32_length_scale = Parameter(length_scale, PositivePrior())
        self.sigma_matern_32 = Parameter(sigma, NonNegativePrior())
        self.distance_metric = distance_metric

    @property
    def name(self):
        return f"matern_32[{self.distance_metric.name}]"

    def _profile(self, distance, length_scale, sigma):
        return matern_32_covariance(distance, length_scale, sigma)

    def state_space_representation(self, X):
        return None

    def derive_length_scale(self, reference_distance, sigma, std_dev_increase):
        return _derive_length_scale_newton(
            reference_distance,
            sigma,
            std_dev_increase,
            lambda ratio: float(matern_32_covariance(1.0, ratio, 1.0)),
            lambda ratio: (
                math.sqrt(3)
                * (1 + math.sqrt(3) / ratio)
                * math.exp(-math.sqrt(3) / ratio)
                / ratio**2
                - math.sqrt(3) * math.exp(-math.sqrt(3) / ratio) / ratio**2
            ),
        )


class Matern52(_RadialKernel):
    """sigma² (1+√5 d/ℓ+5d²/3ℓ²) exp(-√5 d/ℓ)  (radial.hpp:491-529)."""

    _length_scale_param = "matern_52_length_scale"
    _sigma_param = "sigma_matern_52"
    _profile_name = "matern_52"

    def __init__(
        self,
        length_scale=DEFAULT_LENGTH_SCALE,
        sigma=DEFAULT_RADIAL_SIGMA,
        distance_metric: DistanceMetric = EuclideanDistance(),
    ):
        if isinstance(distance_metric, AngularDistance):
            raise TypeError("Matern52 covariance with AngularDistance is not PSD.")
        self.matern_52_length_scale = Parameter(length_scale, PositivePrior())
        self.sigma_matern_52 = Parameter(sigma, NonNegativePrior())
        self.distance_metric = distance_metric

    @property
    def name(self):
        return f"matern_52[{self.distance_metric.name}]"

    def _profile(self, distance, length_scale, sigma):
        return matern_52_covariance(distance, length_scale, sigma)

    def state_space_representation(self, X):
        return None

    def derive_length_scale(self, reference_distance, sigma, std_dev_increase):
        return _derive_length_scale_newton(
            reference_distance,
            sigma,
            std_dev_increase,
            lambda ratio: float(matern_52_covariance(1.0, ratio, 1.0)),
            lambda ratio: (
                (-math.sqrt(5) / ratio**2 - 10.0 / 3.0 / ratio**3)
                * math.exp(-math.sqrt(5) / ratio)
                + math.sqrt(5)
                * (1 + math.sqrt(5) / ratio + 10.0 / 6.0 / ratio**2)
                * math.exp(-math.sqrt(5) / ratio)
                / ratio**2
            ),
        )


# ---------------------------------------------------------------------------
# Decorrelation-distance -> length-scale back-solvers (radial.hpp:51-419)
# ---------------------------------------------------------------------------
def process_noise_equivalent(func, distance: float) -> float:
    """STD[f_d | f_0] = sqrt(k(0) - k(d)²/k(0)) (radial.hpp:35-49)."""
    k0 = func(0.0)
    kd = func(distance)
    return math.sqrt(k0 - kd * kd / k0)


def _valid_args(reference_distance, prior_sigma, std_dev_increase) -> bool:
    assert reference_distance > 0.0
    return 0.0 < std_dev_increase < prior_sigma and prior_sigma > 0.0


def _fallback_length_scale(reference_distance, prior_sigma, std_dev_increase):
    if std_dev_increase <= 0.0 or prior_sigma <= 0.0:
        return MAX_LENGTH_SCALE_RATIO * reference_distance
    if std_dev_increase / prior_sigma >= 1.0:
        return MIN_LENGTH_SCALE_RATIO * reference_distance
    raise AssertionError("unreachable")


def derive_squared_exponential_length_scale(
    reference_distance, prior_sigma, std_dev_increase
):
    """Closed form (radial.hpp:91-125)."""
    if not _valid_args(reference_distance, prior_sigma, std_dev_increase):
        return _fallback_length_scale(
            reference_distance, prior_sigma, std_dev_increase
        )
    ratio = std_dev_increase / prior_sigma
    return (
        math.sqrt(2.0) * reference_distance / math.sqrt(-math.log(1.0 - ratio**2))
    )


def derive_exponential_length_scale(
    reference_distance, prior_sigma, std_dev_increase
):
    """Closed form (radial.hpp:200-233)."""
    if not _valid_args(reference_distance, prior_sigma, std_dev_increase):
        return _fallback_length_scale(
            reference_distance, prior_sigma, std_dev_increase
        )
    ratio = std_dev_increase / prior_sigma
    return -2.0 * reference_distance / math.log(1.0 - ratio**2)


def _newton_solve(guess, target, func, grad, lower, upper, tolerance=1e-12):
    """Bounded scalar Newton iteration (radial.hpp:302-330); host-side float
    math — this runs at model-configuration time, not in the compute path."""
    for _ in range(MAX_NEWTON_ITERATIONS):
        f_i = func(guess)
        error = target - f_i
        if not math.isfinite(error):
            break
        # IEEE division (C++ semantics): error/0 -> ±inf, which the bounded
        # step below turns into a bisection toward the violated bound.
        with np.errstate(divide="ignore", invalid="ignore"):
            delta = float(np.float64(error) / np.float64(grad(guess)))
        if abs(error) < tolerance:
            break
        if guess - delta <= lower:
            guess = 0.5 * (guess + lower)
        elif guess - delta >= upper:
            guess = 0.5 * (guess + upper)
        else:
            guess -= delta
        guess = min(upper, max(lower, guess))
    return guess


def _derive_length_scale_newton(
    reference_distance, prior_sigma, std_dev_increase, func, grad
):
    """Generic log-space Newton back-solve (radial.hpp:332-399)."""
    if not _valid_args(reference_distance, prior_sigma, std_dev_increase):
        return _fallback_length_scale(
            reference_distance, prior_sigma, std_dev_increase
        )

    def log_f(ratio):
        cov = func(ratio)
        if cov * cov >= 1.0:
            return math.log(1e-16)
        return math.log(prior_sigma) + 0.5 * math.log(1.0 - cov * cov)

    def log_g(ratio):
        cov = func(ratio)
        denom = 1.0 - cov * cov
        assert denom > 0
        return grad(ratio) * cov / denom

    log_target = math.log(std_dev_increase)
    max_increase = log_f(MIN_LENGTH_SCALE_RATIO)
    if max_increase <= log_target:
        return MIN_LENGTH_SCALE_RATIO * reference_distance
    min_increase = log_f(MAX_LENGTH_SCALE_RATIO)
    if min_increase >= log_target:
        return MAX_LENGTH_SCALE_RATIO * reference_distance

    alpha = (max_increase - log_target) / (max_increase - min_increase)
    guess = math.exp(
        math.log(MIN_LENGTH_SCALE_RATIO)
        + alpha * (math.log(MAX_LENGTH_SCALE_RATIO) - math.log(MIN_LENGTH_SCALE_RATIO))
    )
    solution = _newton_solve(
        guess, log_target, log_f, log_g, MIN_LENGTH_SCALE_RATIO, MAX_LENGTH_SCALE_RATIO
    )
    return solution * reference_distance
