"""Property-based sanity: PSD-ness of composed kernels, pytree round trips,
jit-cache stability — the analog of the reference's trait/compile-time
suites (tests/test_traits_*.cc) for a runtime-typed design."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from albatross_tpu import (
    Constant,
    Exponential,
    IndependentNoise,
    Matern32,
    Matern52,
    Nugget,
    Polynomial,
    SquaredExponential,
    as_measurement,
)

KERNEL_FACTORIES = [
    lambda: SquaredExponential(1.5, 1.0),
    lambda: Exponential(2.0, 0.7),
    lambda: Matern32(1.0, 1.2),
    lambda: Matern52(3.0, 0.5),
    lambda: Constant(2.0),
    lambda: Polynomial(2, 0.5),
    lambda: IndependentNoise(0.3),
    lambda: Nugget(),
    lambda: SquaredExponential(1.0, 1.0) + Constant(1.0),
    lambda: Matern32(2.0, 1.0) * Exponential(1.0, 1.0),
    lambda: (SquaredExponential(0.5, 2.0) + IndependentNoise(0.1))
    * Constant(0.5),
]


@pytest.mark.parametrize("i", range(len(KERNEL_FACTORIES)))
def test_gram_is_psd(i, rng):
    """Every kernel and composition must produce a PSD gram on random
    inputs (the mathematical contract behind every downstream Cholesky)."""
    k = KERNEL_FACTORIES[i]()
    X = jnp.asarray(np.sort(rng.uniform(-5, 5, 25)))
    K = np.asarray(k(as_measurement(X)))
    np.testing.assert_allclose(K, K.T, atol=1e-12)
    eigs = np.linalg.eigvalsh(K)
    assert eigs.min() > -1e-8 * max(1.0, eigs.max()), k.name


@pytest.mark.parametrize("i", range(len(KERNEL_FACTORIES)))
def test_kernel_pytree_round_trip(i):
    k = KERNEL_FACTORIES[i]()
    leaves, treedef = jax.tree_util.tree_flatten(k)
    k2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert k2.name == k.name
    assert sorted(k2.get_params()) == sorted(k.get_params())
    # structure (treedef) is stable: same class+config -> same treedef, so
    # jit caches hit across functional updates
    k3 = k.set_tunable_params(k.get_tunable_parameters().values)
    _, treedef3 = jax.tree_util.tree_flatten(k3)
    assert treedef3 == treedef


def test_param_update_does_not_retrigger_trace(rng):
    """Changing parameter *values* must reuse the compiled computation."""
    traces = []

    k = SquaredExponential(1.0, 1.0) + IndependentNoise(0.2)
    X = jnp.asarray(np.sort(rng.uniform(0, 5, 10)))

    @jax.jit
    def gram_sum(kern, X):
        traces.append(1)
        return jnp.sum(kern(X))

    gram_sum(k, X)
    gram_sum(k.set_param_value("squared_exponential_length_scale", 2.0), X)
    gram_sum(k.set_param_value("sigma_independent_noise", 0.5), X)
    assert len(traces) == 1  # one trace, three executions


def test_vmapped_fleet_of_gps(rng):
    """Fit/predict a fleet of independent GPs in one vmapped call — a
    batched capability with no reference analog (batched gram + batched
    Cholesky across the fleet axis)."""
    from albatross_tpu import (
        RegressionDataset,
        gp_from_covariance,
        measurement_only,
    )

    n_fleet, n = 5, 16
    xs_batch = jnp.asarray(np.sort(rng.uniform(0, 10, (n_fleet, n)), axis=1))
    ys_batch = jnp.sin(xs_batch) + 0.1 * jnp.asarray(
        rng.standard_normal((n_fleet, n))
    )
    query = jnp.linspace(0.0, 10.0, 7)
    model = gp_from_covariance(
        SquaredExponential(1.5, 1.0) + measurement_only(IndependentNoise(0.2))
    )

    def fit_predict(x, y):
        data = RegressionDataset.create(x, y)
        marg = model.fit(data).predict(query).marginal()
        return marg.mean, marg.variance

    means, variances = jax.vmap(fit_predict)(xs_batch, ys_batch)
    assert means.shape == (n_fleet, 7)
    # each fleet member matches its individual fit
    for i in range(n_fleet):
        data = RegressionDataset.create(xs_batch[i], ys_batch[i])
        single = model.fit(data).predict(query).marginal()
        np.testing.assert_allclose(
            np.asarray(means[i]), np.asarray(single.mean), rtol=1e-9
        )
        np.testing.assert_allclose(
            np.asarray(variances[i]), np.asarray(single.variance), rtol=1e-7
        )


def test_extending_doc_examples(rng):
    """The EXTENDING.md examples must actually work."""
    import dataclasses

    from albatross_tpu.core import Parameter, PositivePrior
    from albatross_tpu.kernels import CovarianceFunction
    from albatross_tpu.models import ModelBase
    from albatross_tpu import RegressionDataset, gp_from_covariance

    @jax.tree_util.register_pytree_node_class
    @dataclasses.dataclass(frozen=True)
    class MeanOnlyFit:
        mean_value: jax.Array

        def tree_flatten(self):
            return (self.mean_value,), None

        @classmethod
        def tree_unflatten(cls, _, children):
            return cls(*children)

    class GlobalMeanModel(ModelBase):
        def _fit_impl(self, features, targets):
            return MeanOnlyFit(jnp.mean(targets.mean))

        def _predict_mean(self, features, fit):
            from albatross_tpu.core.dataset import feature_count

            return jnp.full((feature_count(features),), fit.mean_value)

    data = RegressionDataset.create(jnp.arange(4.0), jnp.asarray([1.0, 2.0, 3.0, 4.0]))
    pred = GlobalMeanModel().fit(data).predict(jnp.zeros(2)).mean()
    np.testing.assert_allclose(np.asarray(pred), [2.5, 2.5])

    class Periodic(CovarianceFunction):
        def __init__(self, period=1.0, length_scale=1.0, sigma=1.0):
            self.periodic_period = Parameter(period, PositivePrior())
            self.periodic_length_scale = Parameter(length_scale, PositivePrior())
            self.sigma_periodic = Parameter(sigma, PositivePrior())

        @property
        def name(self):
            return "periodic"

        def _matrix(self, X, Y, x_meas, y_meas):
            d = jnp.abs(jnp.asarray(X)[:, None] - jnp.asarray(Y)[None, :])
            s = jnp.sin(jnp.pi * d / self.periodic_period.value)
            s2 = self.sigma_periodic.value ** 2
            return s2 * jnp.exp(
                -2.0 * (s / self.periodic_length_scale.value) ** 2
            )

        def _diag(self, X, x_meas):
            n = jnp.asarray(X).shape[0]
            return jnp.full((n,), self.sigma_periodic.value ** 2)

    k = Periodic(period=2.0) + IndependentNoise(0.1)
    x = jnp.asarray(np.sort(rng.uniform(0, 8, 20)))
    y = jnp.sin(np.pi * x)  # period-2 signal
    data = RegressionDataset.create(x, y)
    model = gp_from_covariance(k, jitter=1e-10)
    pred = model.fit(data).predict(x + 4.0).mean()  # two periods ahead
    np.testing.assert_allclose(
        np.asarray(pred), np.sin(np.pi * np.asarray(x)), atol=0.1
    )
    # PSD check for the custom kernel
    K = np.asarray(k(x))
    assert np.linalg.eigvalsh(K).min() > -1e-8
