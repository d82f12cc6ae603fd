"""The reference's own benchmark cases, measured on this framework.

swift-nav/albatross defines google_benchmark cases (sizes only — it
publishes no numbers, SURVEY.md §6) in /root/reference/benchmarks/:

  bench_gram.cc:22-75        BM_gp_joint_prediction(256,512),
                             BM_sparse_gp_fit(1024,2048; 64 inducing),
                             BM_sparse_gp_predict_joint(512,1024)
  bench_predict.cc:29-95     BM_gp_fit / BM_gp_predict_{joint,marginal,mean}
                             (n=512, m=512; thread counts 0/4/8)
  bench_loo_cv.cc:24-100     BM_inverse_diagonal(256,512,1024),
                             BM_leave_one_out_conditional(256,512,1024),
                             BM_leave_one_group_out_marginals(256,512,1024;
                             16 groups)
  bench_block_symmetric.cc   BM_block_symmetric_{construct,solve_vector,
                             solve_matrix}(256,512)

This script runs the same cases (same covariance: SquaredExponential(1,1) +
IndependentNoise(0.1); same feature distribution U[0,10]; same sizes) through
albatross_tpu and prints one JSON line per case, plus a summary file
``benchmarks/REFERENCE_CASES.json``.  The reference binaries cannot be built
in this image (its third_party/ submodules are empty), so the comparison
basis is the case *definitions*; thread-count variants collapse to one
(parallelism here is XLA/mesh, not a ThreadPool).

Measurement notes: jit-able cases chain R data-dependent calls and sync
once (same technique as bench.py); host-loop cases (model.fit with
grouping) are timed eagerly and marked "eager".  Run on CPU with
``env JAX_PLATFORMS=cpu``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import albatross_tpu as ab
from albatross_tpu.evaluation.cross_validation_utils import (
    leave_one_group_out_conditional,
    leave_one_out_conditional,
)
from albatross_tpu.indexing import group_by
from albatross_tpu.models.gp import gp_joint_prediction
from albatross_tpu.ops.block import build_block_symmetric
from albatross_tpu.ops.linalg import CholeskyFactor

R = 8  # chained repetitions per jit-able case
RESULTS = []


def bench_covariance():
    """bench_utils.h:59-64."""
    return ab.SquaredExponential(1.0, 1.0) + ab.IndependentNoise(0.1)


def random_features(n, seed):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.uniform(0.0, 10.0, n))


def random_psd(n, seed):
    """bench_utils.h:67-72: a real covariance gram, not iid noise."""
    return bench_covariance()(random_features(n, seed))


def random_dataset(n, seed):
    rng = np.random.default_rng(seed)
    x = random_features(n, seed)
    y = jnp.sin(x) + 0.1 * jnp.asarray(rng.standard_normal(n))
    return ab.RegressionDataset.create(x, y)


def emit(metric, ms, mode):
    rec = {
        "metric": metric,
        "value": round(ms, 4),
        "unit": f"ms/op ({mode})",
    }
    RESULTS.append(rec)
    print(json.dumps(rec), flush=True)


def time_chained(metric, step, state0):
    """step(prev_scalar) -> scalar; R async-chained dispatches, one sync."""
    prev = step(jnp.asarray(state0))
    float(prev)  # compile + sync
    best = None
    for _ in range(3):
        p = jnp.asarray(state0)
        t0 = time.perf_counter()
        for _ in range(R):
            p = step(p)
        float(p)
        dt = (time.perf_counter() - t0) / R
        best = dt if best is None else min(best, dt)
    emit(metric, best * 1e3, "chained")


def time_eager(metric, fn, reps=3):
    """Host-loop case: time full calls, sync by pulling a scalar."""
    float(fn())  # warm (compiles inner jits)
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        float(fn())
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    emit(metric, best * 1e3, "eager")


# ---------------------------------------------------------------------------
# bench_gram.cc
# ---------------------------------------------------------------------------
def bench_gp_joint_prediction():
    for n in (256, 512):
        chol = CholeskyFactor.factorize(random_psd(n, 41), jitter=1e-8)
        cross = jnp.asarray(
            np.random.default_rng(42).standard_normal((n, n))
        )
        prior = random_psd(n, 43)
        info = jnp.asarray(np.random.default_rng(44).standard_normal(n))

        @jax.jit
        def step(prev, chol=chol, cross=cross, prior=prior, info=info):
            pred = gp_joint_prediction(
                cross + 1e-30 * prev, prior, info, chol
            )
            return pred.mean[0] + pred.covariance[0, 0]

        time_chained(f"gp_joint_prediction_n{n}", step, 0.0)


def bench_sparse_gp():
    def make_model():
        return ab.sparse_gp_from_covariance(
            bench_covariance(),
            grouper=lambda f: np.asarray(f).astype(np.int64),
            inducing_point_strategy=ab.UniformlySpacedInducingPoints(64),
        )

    for n in (1024, 2048):
        data = random_dataset(n, 45)
        model = make_model()
        time_eager(
            f"sparse_gp_fit_n{n}",
            lambda: float(model.fit(data).fit.information[0]),
        )

    data = random_dataset(1024, 46)
    fit_model = make_model().fit(data)
    for m in (512, 1024):
        xs = random_features(m, 47)

        @jax.jit
        def step(prev, fit=fit_model, xs=xs):
            pred = fit.predict(xs + 1e-30 * prev).joint()
            return pred.mean[0] + pred.covariance[0, 0]

        time_chained(f"sparse_gp_predict_joint_m{m}", step, 0.0)


# ---------------------------------------------------------------------------
# bench_predict.cc (thread-count args collapse: parallelism is XLA's)
# ---------------------------------------------------------------------------
def bench_gp_fit_predict():
    n, m = 512, 512
    data = random_dataset(n, 31)
    model = ab.gp_from_covariance(bench_covariance(), jitter=1e-8)

    @jax.jit
    def fit_step(prev, model=model, data=data):
        d = ab.RegressionDataset(
            data.features + 1e-30 * prev, data.targets, data.metadata
        )
        return model.fit(d).fit.information[0]

    time_chained(f"gp_fit_n{n}", fit_step, 0.0)

    fit_model = model.fit(data)
    xs = random_features(m, 33)

    @jax.jit
    def joint_step(prev, fit=fit_model, xs=xs):
        pred = fit.predict(xs + 1e-30 * prev).joint()
        return pred.mean[0] + pred.covariance[0, 0]

    @jax.jit
    def marginal_step(prev, fit=fit_model, xs=xs):
        pred = fit.predict(xs + 1e-30 * prev).marginal()
        return pred.mean[0] + pred.variance[0]

    @jax.jit
    def mean_step(prev, fit=fit_model, xs=xs):
        return fit.predict(xs + 1e-30 * prev).mean()[0]

    time_chained(f"gp_predict_joint_n{n}_m{m}", joint_step, 0.0)
    time_chained(f"gp_predict_marginal_n{n}_m{m}", marginal_step, 0.0)
    time_chained(f"gp_predict_mean_n{n}_m{m}", mean_step, 0.0)


# ---------------------------------------------------------------------------
# bench_loo_cv.cc
# ---------------------------------------------------------------------------
def bench_loo_cv():
    for n in (256, 512, 1024):
        chol = CholeskyFactor.factorize(random_psd(n, 21), jitter=1e-8)

        @jax.jit
        def diag_step(prev, chol=chol):
            L = chol.L + 1e-30 * prev
            return CholeskyFactor(L).inverse_diagonal()[0]

        time_chained(f"inverse_diagonal_n{n}", diag_step, 0.0)

    for n in (256, 512, 1024):
        cov = random_psd(n, 22)
        rng = np.random.default_rng(23)
        prior = ab.JointDistribution(jnp.zeros(n), cov)
        truth = ab.MarginalDistribution(
            jnp.asarray(rng.standard_normal(n)), jnp.ones(n)
        )

        @jax.jit
        def loo_step(prev, prior=prior, truth=truth):
            t = ab.MarginalDistribution(
                truth.mean + 1e-30 * prev, truth.variance
            )
            loo = leave_one_out_conditional(prior, t)
            return loo.mean[0] + loo.variance[0]

        time_chained(f"leave_one_out_conditional_n{n}", loo_step, 0.0)

    for n in (256, 512, 1024):
        feats = random_features(n, 24)
        indexers = group_by(
            np.asarray(feats), lambda f: np.asarray(f).astype(np.int64) % 16
        ).indexers()
        cov = random_psd(n, 25)
        rng = np.random.default_rng(26)
        prior = ab.JointDistribution(jnp.zeros(n), cov)
        truth = ab.MarginalDistribution(
            jnp.asarray(rng.standard_normal(n)), jnp.ones(n)
        )
        # group sizes are ragged → host loop over groups: time eagerly
        time_eager(
            f"leave_one_group_out_marginals_n{n}",
            lambda prior=prior, truth=truth, indexers=indexers: float(
                next(
                    iter(
                        leave_one_group_out_conditional(
                            prior, truth, indexers
                        ).values()
                    )
                ).mean[0]
            ),
        )


# ---------------------------------------------------------------------------
# bench_block_symmetric.cc
# ---------------------------------------------------------------------------
def bench_block_symmetric():
    for total in (256, 512):
        na = 3 * total // 4
        nb = total - na
        A = CholeskyFactor.factorize(random_psd(na, 11), jitter=1e-8)
        B = jnp.asarray(
            np.random.default_rng(12).standard_normal((na, nb))
        )
        C_raw = random_psd(nb, 13)
        C = C_raw + 10.0 * B.T @ A.solve(B)

        @jax.jit
        def construct_step(prev, A=A, B=B, C=C):
            S = CholeskyFactor.factorize(C - (B + 1e-30 * prev).T @ A.solve(B))
            block = build_block_symmetric(A, B, S)
            return block.log_determinant()

        time_chained(f"block_symmetric_construct_n{total}", construct_step, 0.0)

        S = CholeskyFactor.factorize(C - B.T @ A.solve(B))
        block = build_block_symmetric(A, B, S)
        rhs_v = jnp.asarray(np.random.default_rng(14).standard_normal(total))
        rhs_m = jnp.asarray(
            np.random.default_rng(15).standard_normal((total, 32))
        )

        @jax.jit
        def solve_v_step(prev, block=block, rhs=rhs_v):
            return block.solve(rhs + 1e-30 * prev)[0]

        @jax.jit
        def solve_m_step(prev, block=block, rhs=rhs_m):
            return block.solve(rhs + 1e-30 * prev)[0, 0]

        time_chained(f"block_symmetric_solve_vector_n{total}", solve_v_step, 0.0)
        time_chained(f"block_symmetric_solve_matrix_n{total}", solve_m_step, 0.0)


def main():
    print(
        json.dumps(
            {
                "metric": "reference_cases_backend",
                "unit": jax.default_backend(),
            }
        ),
        flush=True,
    )
    bench_gp_joint_prediction()
    bench_gp_fit_predict()
    bench_loo_cv()
    bench_block_symmetric()
    bench_sparse_gp()
    out = os.path.join(os.path.dirname(__file__) or ".", "REFERENCE_CASES.json")
    with open(out, "w") as fh:
        json.dump(
            {"backend": jax.default_backend(), "results": RESULTS}, fh, indent=1
        )


if __name__ == "__main__":
    main()
