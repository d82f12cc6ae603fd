"""albatross_tpu — a Gaussian-process inference framework for accelerators.

A from-scratch JAX/XLA re-design with the modelling capabilities of
swift-nav/albatross (see SURVEY.md at the repo root): a composable
covariance/mean-function DSL with parameter+prior handling, exact and sparse
(FITC/PITC) Gaussian-process regression, fast leave-one-out/-group-out
cross-validation, gradient-based and MCMC hyperparameter inference, RANSAC
outlier rejection, and pytree checkpointing — built accelerator-first:
batched Gram assembly, GEMM-rich blocked Cholesky, mesh-sharded scaling via
pjit/shard_map, and vmapped fold/walker parallelism.
"""

from . import (
    config,
    core,
    evaluation,
    indexing,
    kernels,
    models,
    ops,
    parallel,
    samplers,
    serialize,
    stats,
    tuning,
    utils,
)
from .core import (
    FixedPrior,
    GaussianPrior,
    JointDistribution,
    LogNormalPrior,
    LogScaleUniformPrior,
    MarginalDistribution,
    NonNegativePrior,
    Parameter,
    PositiveGaussianPrior,
    PositivePrior,
    RegressionDataset,
    UniformPrior,
    UninformativePrior,
    concatenate_datasets,
)
from .kernels import (
    AngularDistance,
    ForTag,
    TaggedBatch,
    Constant,
    ConstantTerm,
    EuclideanDistance,
    Exponential,
    IndependentNoise,
    LinearMean,
    Matern32,
    Matern52,
    MeanFunction,
    Measurement,
    Nugget,
    Polynomial,
    RadialDistance,
    ScalingFunction,
    ScalingTerm,
    SquaredExponential,
    ZeroMean,
    as_measurement,
    measurement_only,
)
from .models import (
    ConditionalGaussian,
    DefaultGPRansacStrategy,
    DefaultRansacStrategy,
    FitModel,
    GaussianProcess,
    LeastSquares,
    LinearRegression,
    NullModel,
    Ransac,
    RansacConfig,
    SparseGaussianProcessRegression,
    StateSpaceInducingPointStrategy,
    UniformlySpacedInducingPoints,
    gp_from_covariance,
    gp_from_covariance_and_mean,
    rebase_inducing_points,
    sparse_gp_from_covariance,
    sparse_gp_from_covariance_and_mean,
)

__version__ = "0.1.0"
__all__ = [k for k in dir() if not k.startswith("_")]
