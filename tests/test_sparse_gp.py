"""Sparse GP tests: convergence to dense GP, likelihood parity, online
update, rebase (reference: tests/test_sparse_gp.cc:115-520)."""

import jax.numpy as jnp
import numpy as np
import pytest

from albatross_tpu import (
    IndependentNoise,
    RegressionDataset,
    SquaredExponential,
    UniformlySpacedInducingPoints,
    StateSpaceInducingPointStrategy,
    gp_from_covariance,
    measurement_only,
    rebase_inducing_points,
    sparse_gp_from_covariance,
)
from albatross_tpu.indexing import KFoldGrouper
from albatross_tpu.models.sparse_gp import EveryPointGrouper


def make_data(rng, n=40):
    x = np.sort(rng.uniform(0.0, 10.0, n))
    y = np.sin(x) + 0.1 * rng.standard_normal(n)
    return RegressionDataset.create(
        jnp.asarray(x), jnp.asarray(y), variance=jnp.full((n,), 0.01)
    )


def kernel():
    return SquaredExponential(2.0, 1.0) + measurement_only(
        IndependentNoise(0.1)
    )


def dense_model():
    return gp_from_covariance(kernel())


def sparse_model(num_inducing=8, grouper=None):
    return sparse_gp_from_covariance(
        kernel(),
        grouper=grouper or EveryPointGrouper(),
        inducing_point_strategy=UniformlySpacedInducingPoints(num_inducing),
    )


def test_sparse_converges_to_dense(rng):
    """With inducing points ~ the training set, FITC ≈ exact GP
    (test_sparse_gp.cc:115-180)."""
    data = make_data(rng, 30)
    xs = jnp.linspace(0.5, 9.5, 11)

    dense_pred = dense_model().fit(data).predict(xs).marginal()

    errors = []
    for m in (5, 15, 60):
        pred = sparse_model(m).fit(data).predict(xs).marginal()
        errors.append(
            float(jnp.max(jnp.abs(pred.mean - dense_pred.mean)))
        )
    # monotone-ish improvement and near-exact at m >> n
    assert errors[-1] < errors[0]
    assert errors[-1] < 5e-3
    pred = sparse_model(60).fit(data).predict(xs).marginal()
    np.testing.assert_allclose(
        np.asarray(pred.variance), np.asarray(dense_pred.variance), atol=5e-3
    )


def _fix_priors(model):
    """Exclude prior terms from LL comparisons, mirroring the reference
    (test_sparse_gp.cc:144-148: FixedPrior on every param)."""
    from albatross_tpu.core import FixedPrior

    for name in model.get_params():
        model = model.set_param_prior(name, FixedPrior())
    return model


def test_sparse_log_likelihood_approaches_dense(rng):
    data = make_data(rng, 25)
    dense_ll = float(_fix_priors(dense_model()).log_likelihood(data))
    sparse_ll = float(_fix_priors(sparse_model(50)).log_likelihood(data))
    # the sparse LL includes target variance + nuggets the dense one doesn't,
    # so agreement is approximate but should be close
    assert sparse_ll == pytest.approx(dense_ll, abs=5.0)
    worse_ll = float(_fix_priors(sparse_model(4)).log_likelihood(data))
    assert abs(worse_ll - dense_ll) >= abs(sparse_ll - dense_ll) - 1e-6


def test_pitc_grouped_blocks(rng):
    """PITC with k-fold groups runs and improves over FITC with the same
    inducing points when correlations within groups matter."""
    data = make_data(rng, 24)
    xs = jnp.linspace(0.5, 9.5, 7)
    fitc = sparse_model(6).fit(data).predict(xs).marginal()
    pitc = sparse_model(6, grouper=KFoldGrouper(6)).fit(data).predict(xs).marginal()
    assert np.all(np.isfinite(np.asarray(pitc.mean)))
    assert np.all(np.asarray(pitc.variance) > 0)
    assert np.all(np.asarray(fitc.variance) > 0)


def test_sparse_update_matches_full_fit(rng):
    """fit(first) then update(second) == fit(all)
    (test_sparse_gp.cc:237-320)."""
    data = make_data(rng, 30)
    first = data[jnp.arange(20)]
    second = data[jnp.arange(20, 30)]

    class FixedInducing:
        """Same grid for both fits — UniformlySpacedInducingPoints would
        derive different grids from the different feature ranges."""

        def __call__(self, cov, features):
            return jnp.linspace(0.0, 10.0, 10)

    model = sparse_gp_from_covariance(
        kernel(),
        grouper=EveryPointGrouper(),
        inducing_point_strategy=FixedInducing(),
    )

    full = model.fit(data)
    split = model.fit(first).update(second)

    xs = jnp.linspace(0.5, 9.5, 9)
    p_full = full.predict(xs).marginal()
    p_split = split.predict(xs).marginal()
    np.testing.assert_allclose(
        np.asarray(p_split.mean), np.asarray(p_full.mean), rtol=1e-6, atol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(p_split.variance),
        np.asarray(p_full.variance),
        rtol=1e-5,
        atol=1e-8,
    )


def test_rebase_inducing_points(rng):
    """Rebasing onto a denser grid approximately preserves predictions
    (test_sparse_gp.cc:370-520)."""
    data = make_data(rng, 25)
    model = sparse_model(12)
    fit_model = model.fit(data)
    xs = jnp.linspace(1.0, 9.0, 9)
    before = fit_model.predict(xs).marginal()

    new_u = jnp.linspace(0.0, 10.0, 15)
    rebased = rebase_inducing_points(fit_model, new_u)
    after = rebased.predict(xs).marginal()

    np.testing.assert_allclose(
        np.asarray(after.mean), np.asarray(before.mean), atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(after.variance), np.asarray(before.variance), atol=5e-3
    )


def test_shift_mean(rng):
    data = make_data(rng, 20)
    model = sparse_model(8)
    fit_model = model.fit(data)
    shift = 2.0 * jnp.ones(8)
    shifted_fit = fit_model.fit.shift_mean(shift)
    xs = jnp.linspace(1.0, 9.0, 5)
    from albatross_tpu.models.base import FitModel, Prediction

    base_mean = np.asarray(fit_model.predict(xs).mean())
    shifted_mean = np.asarray(
        Prediction(model, shifted_fit, xs).mean()
    )
    # shifting the information by K_uu^-1*c shifts predictions by ~c where
    # cross-covariances are strong
    assert np.all(shifted_mean > base_mean)


def test_state_space_inducing_strategy(rng):
    data = make_data(rng, 20)
    model = sparse_gp_from_covariance(
        SquaredExponential(3.0, 1.0) + measurement_only(IndependentNoise(0.1)),
        inducing_point_strategy=StateSpaceInducingPointStrategy(),
    )
    fit_model = model.fit(data)
    # ssr grid: ~10 points per length scale over the range + constant merge
    u = np.asarray(fit_model.fit.train_features)
    assert u.shape[0] >= 3
    pred = fit_model.predict(jnp.linspace(1, 9, 5)).marginal()
    assert np.all(np.isfinite(np.asarray(pred.mean)))


def test_sparse_nuggets_params(rng):
    model = sparse_model(6)
    params = model.get_params()
    assert "measurement_nugget" in params
    assert "inducing_nugget" in params
    m2 = model.set_param_value("measurement_nugget", 1e-4)
    assert float(m2.get_params()["measurement_nugget"].value) == 1e-4
    # still fits fine
    data = make_data(rng, 15)
    pred = m2.fit(data).predict(jnp.linspace(1, 9, 4)).marginal()
    assert np.all(np.isfinite(np.asarray(pred.mean)))


def test_sparse_with_duplicate_inducing_information(rng):
    """Rank-deficiency safeguard: inducing points far outside the data make
    columns of B nearly dependent — must not produce NaNs
    (sparse_gp.hpp:348-352 nugget safeguards)."""
    data = make_data(rng, 15)

    class BadStrategy:
        def __call__(self, cov, features):
            # clustered, nearly-duplicate inducing points
            return jnp.asarray([5.0, 5.0 + 1e-12, 5.0 + 2e-12, 50.0])

    model = sparse_gp_from_covariance(
        kernel(), inducing_point_strategy=BadStrategy()
    )
    pred = model.fit(data).predict(jnp.linspace(1, 9, 5)).marginal()
    assert np.all(np.isfinite(np.asarray(pred.mean)))


def test_sparse_fit_predict_under_jit(rng):
    """Sparse fit/predict must be jittable end-to-end (the rank safeguard
    applies via where; the stored rank degrades to -1 under tracing)."""
    import jax

    data = make_data(rng, 20)
    model = sparse_model(8)
    xs = jnp.linspace(0.5, 9.5, 5)

    @jax.jit
    def fit_predict(m, d, q):
        fm = m.fit(d)
        marg = fm.predict(q).marginal()
        return marg.mean, marg.variance

    mean, var = fit_predict(model, data, xs)
    eager = model.fit(data).predict(xs).marginal()
    np.testing.assert_allclose(np.asarray(mean), np.asarray(eager.mean), rtol=1e-9)
    np.testing.assert_allclose(
        np.asarray(var), np.asarray(eager.variance), rtol=1e-9
    )


def test_sparse_fitc_f32_coincident_inducing_point_finite(rng):
    """In pure f32 (the accelerator default), an inducing point that coincides with
    a training point cancels the FITC residual k − q to ~0, and the f32
    rounding can land a few ulps negative — sqrt(a_diag) then NaN'd the
    whole fit (measured −3.5e-7 with UniformlySpacedInducingPoints, whose
    endpoints always coincide with min/max of the training inputs).  The
    rounding-scale clamp (same policy as gp_marginal_prediction) must keep
    NLML/fit/predict finite without masking genuinely indefinite
    residuals."""
    import jax
    import albatross_tpu as ab

    with jax.enable_x64(False):  # the accelerator-default f32 mode
        x = jnp.asarray(np.sort(rng.uniform(0, 10, 300)), jnp.float32)
        data = ab.RegressionDataset.create(x, jnp.sin(x))
        model = sparse_gp_from_covariance(
            ab.SquaredExponential(2.0, 1.0) + ab.IndependentNoise(0.1),
            inducing_point_strategy=ab.UniformlySpacedInducingPoints(32),
        )
        ll = float(model.log_likelihood(data))
        assert np.isfinite(ll)
        xs = jnp.linspace(0, 10, 20, dtype=jnp.float32)
        pred = model.fit(data).predict(xs).marginal()
        assert pred.mean.dtype == jnp.float32
        assert np.all(np.isfinite(np.asarray(pred.mean)))
        assert np.all(np.isfinite(np.asarray(pred.variance)))
        rmse = float(jnp.sqrt(jnp.mean((pred.mean - jnp.sin(xs)) ** 2)))
        assert rmse < 0.05
