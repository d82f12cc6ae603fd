"""Parameter priors.

JAX re-design of the reference prior hierarchy
(/root/reference/include/albatross/src/core/priors.hpp:29-253).

Each prior provides ``log_pdf`` (JAX-traceable, so prior terms participate in
autodiff of the log-likelihood objective), bounds, and the ``is_fixed`` /
``is_log_scale`` flags that drive the tunable-vector round trip
(see albatross_tpu.core.parameters).

Priors are immutable, hashable python dataclasses: they are *static* metadata
attached to dynamic parameter values, so changing a prior re-specializes any
jitted computation (which is the correct granularity — priors change rarely,
values change every optimizer step).
"""

from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp

LOG_2 = 0.6931471805599453
LOG_2PI = 1.8378770664093453
LARGE_VAL = float("inf")
# Matches std::numeric_limits<double>::epsilon() used as the PositivePrior
# lower bound in the reference (priors.hpp:62-64).
EPSILON = 2.220446049250313e-16


@dataclasses.dataclass(frozen=True)
class Prior:
    """Base prior: uninformative, unbounded."""

    def log_pdf(self, x):
        return jnp.zeros_like(jnp.asarray(x, dtype=jnp.result_type(x, float)))

    @property
    def lower_bound(self) -> float:
        return -LARGE_VAL

    @property
    def upper_bound(self) -> float:
        return LARGE_VAL

    @property
    def is_log_scale(self) -> bool:
        return False

    @property
    def is_fixed(self) -> bool:
        return False

    @property
    def name(self) -> str:
        return "uninformative"


class UninformativePrior(Prior):
    pass


class FixedPrior(Prior):
    @property
    def is_fixed(self) -> bool:
        return True

    @property
    def name(self) -> str:
        return "fixed"


class PositivePrior(Prior):
    """log_pdf 0 for x>0, -inf otherwise; lower bound = machine epsilon."""

    def log_pdf(self, x):
        x = jnp.asarray(x, dtype=jnp.result_type(x, float))
        return jnp.where(x > 0.0, 0.0, -LARGE_VAL)

    @property
    def lower_bound(self) -> float:
        return EPSILON

    @property
    def name(self) -> str:
        return "positive"


class NonNegativePrior(Prior):
    def log_pdf(self, x):
        x = jnp.asarray(x, dtype=jnp.result_type(x, float))
        return jnp.where(x >= 0.0, 0.0, -LARGE_VAL)

    @property
    def lower_bound(self) -> float:
        return 0.0

    @property
    def name(self) -> str:
        return "non_negative"


@dataclasses.dataclass(frozen=True)
class UniformPrior(Prior):
    lower: float = 0.0
    upper: float = 1.0

    def __post_init__(self):
        if not self.upper > self.lower:
            raise ValueError("UniformPrior requires upper > lower")

    def log_pdf(self, x):
        x = jnp.asarray(x, dtype=jnp.result_type(x, float))
        # stage the bounds clamped to the dtype's finite range: the
        # reference's PARAMETER_MAX (1.8e308, parameters.hpp) overflows an
        # f32 literal to inf and numpy emits a RuntimeWarning on every
        # trace in pure-f32 mode; the comparison result is unchanged
        finfo = jnp.finfo(x.dtype)
        lo = max(self.lower, float(-finfo.max))
        hi = min(self.upper, float(finfo.max))
        inside = (x >= lo) & (x <= hi)
        return jnp.where(inside, -math.log(self.upper - self.lower), -LARGE_VAL)

    @property
    def lower_bound(self) -> float:
        return self.lower

    @property
    def upper_bound(self) -> float:
        return self.upper

    @property
    def name(self) -> str:
        return f"uniform[{self.lower},{self.upper}]"


@dataclasses.dataclass(frozen=True)
class LogScaleUniformPrior(UniformPrior):
    """Uniform prior whose parameter is tuned in log space."""

    lower: float = 1e-12
    upper: float = 1e12

    def __post_init__(self):
        super().__post_init__()
        if not (self.lower > 0.0 and self.upper > 0.0):
            raise ValueError("LogScaleUniformPrior requires positive bounds")

    @property
    def is_log_scale(self) -> bool:
        return True

    @property
    def name(self) -> str:
        return f"log_scale_uniform[{self.lower},{self.upper}]"


@dataclasses.dataclass(frozen=True)
class GaussianPrior(Prior):
    mu: float = 0.0
    sigma: float = 1.0

    def log_pdf(self, x):
        x = jnp.asarray(x, dtype=jnp.result_type(x, float))
        deviation = (x - self.mu) / self.sigma
        # Mirrors the reference expression (priors.hpp:135-138) exactly,
        # including its idiosyncratic normalization constant.
        return -0.5 * (LOG_2PI * 2.0 * math.log(self.sigma) + deviation * deviation)

    @property
    def name(self) -> str:
        return f"gaussian[{self.mu},{self.sigma}]"


@dataclasses.dataclass(frozen=True)
class PositiveGaussianPrior(Prior):
    """Half-normal: gaussian log-pdf + log(2), bounds [0, 10 sigma]."""

    mu: float = 0.0
    sigma: float = 1.0

    def log_pdf(self, x):
        x = jnp.asarray(x, dtype=jnp.result_type(x, float))
        deviation = (x - self.mu) / self.sigma
        return (
            -0.5 * (LOG_2PI * 2.0 * math.log(self.sigma) + deviation * deviation)
            + LOG_2
        )

    @property
    def lower_bound(self) -> float:
        return 0.0

    @property
    def upper_bound(self) -> float:
        return 10.0 * self.sigma

    @property
    def name(self) -> str:
        return f"positive_gaussian[{self.mu},{self.sigma}]"


@dataclasses.dataclass(frozen=True)
class LogNormalPrior(Prior):
    mu: float = 0.0
    sigma: float = 1.0

    def log_pdf(self, x):
        x = jnp.asarray(x, dtype=jnp.result_type(x, float))
        deviation = (jnp.log(x) - self.mu) / self.sigma
        return (
            -0.5 * LOG_2PI
            - math.log(self.sigma)
            - jnp.log(x)
            - deviation * deviation
        )

    @property
    def name(self) -> str:
        return f"log_normal[{self.mu},{self.sigma}]"


# Serialization tag order mirrors the reference variant order
# (priors.hpp:195-199) for cross-compatible checkpoints.
PRIOR_TYPES = (
    UninformativePrior,
    FixedPrior,
    NonNegativePrior,
    PositivePrior,
    UniformPrior,
    LogScaleUniformPrior,
    GaussianPrior,
    LogNormalPrior,
    PositiveGaussianPrior,
)
