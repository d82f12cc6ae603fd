"""Batched-vs-serial GP-RANSAC wall time (VERDICT r3 next #5).

The GP strategy's candidate fits are fixed-size conditionings of ONE
precomputed ConditionalGaussian (models/ransac.py ransac_gp_batched), so
all max_iterations candidate fits + all K·G inlier scores execute as a
single vmapped device dispatch, where the reference's loop
(/root/reference/include/albatross/src/models/ransac.hpp:172-258 +
ransac_gp.hpp:117-180) is serial per-iteration, per-group.

This measures both paths at max_iterations=100, N=512 (LOO groups) on the
identical RansacOutput (asserted equal) and writes benchmarks/RANSAC_BENCH.json.

Run from the repo root:
    env JAX_PLATFORMS=cpu \
        python -m benchmarks.exp_ransac
"""

from __future__ import annotations

import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np


def main() -> None:
    import jax.numpy as jnp

    import albatross_tpu as ab
    from albatross_tpu.models.ransac import RansacConfig

    n = 512
    rng = np.random.default_rng(3)
    x = jnp.asarray(np.sort(rng.uniform(0.0, 10.0, n)), jnp.float32)
    y = jnp.sin(x) + 0.1 * jnp.asarray(
        rng.standard_normal(n), jnp.float32
    )
    # plant outliers
    out_idx = rng.choice(n, size=12, replace=False)
    y = y.at[jnp.asarray(out_idx)].add(
        jnp.asarray(5.0 + rng.uniform(0, 3, 12), jnp.float32)
    )
    data = ab.RegressionDataset.create(
        x, y, variance=jnp.full((n,), 0.01, jnp.float32)
    )
    model = ab.gp_from_covariance(
        ab.SquaredExponential(1.5, 1.0) + ab.IndependentNoise(0.1),
        jitter=1e-5,
    )
    from albatross_tpu.models.ransac import DefaultGPRansacStrategy

    strategy = DefaultGPRansacStrategy()
    config = RansacConfig(
        inlier_threshold=1.0,
        random_sample_size=16,
        min_consensus_size=400,
        max_iterations=100,
        max_failed_candidates=10,
    )

    def run(use_batched: bool):
        m = model.ransac(strategy, config, use_batched=use_batched)
        t0 = time.perf_counter()
        fit = m.fit(data)
        dt = time.perf_counter() - t0
        return dt, fit.fit.ransac_output

    # warm the jit caches so compile time is excluded from BOTH arms.  The
    # batched program's shapes depend on max_iterations (n_draws), so it
    # must warm at the REAL config (review finding, round 4); the serial
    # loop's per-candidate jits key only on (s·u)/(G,u) shapes, which a
    # 2-iteration config already produces.
    model.ransac(strategy, config, use_batched=True).fit(data)
    warm = RansacConfig(1.0, 16, 400, 2, 10)
    model.ransac(strategy, warm, use_batched=False).fit(data)

    t_batched, out_b = run(True)
    t_serial, out_s = run(False)

    assert out_b.return_code == out_s.return_code
    assert out_b.best.candidates == out_s.best.candidates
    assert set(out_b.best.inliers) == set(out_s.best.inliers)

    rec = {
        "metric": "ransac_batched_speedup_n512_iters100",
        "value": round(t_serial / t_batched, 2),
        "unit": (
            f"x (serial {t_serial:.1f}s vs batched {t_batched:.2f}s; "
            f"identical RansacOutput, rc={out_b.return_code.name}, "
            f"{len(out_b.best.consensus())} consensus groups)"
        ),
    }
    print(json.dumps(rec))
    with open(
        os.path.join(os.path.dirname(__file__), "RANSAC_BENCH.json"), "w"
    ) as fh:
        json.dump(rec, fh, indent=1)


if __name__ == "__main__":
    main()
