"""NLML accuracy-mode walkthrough.

The reference gets 1e-15-class NLML accuracy for free from Eigen's f64
LDLT (serializable_ldlt.hpp:19-80); an f32 pipeline does not, so
albatross_tpu ships an accuracy ladder (ops/compensated.py, config knobs):

  1. plain f32             — fastest; ~1e-4-class relative NLML error at
                             GP conditioning (f32 solve/reduction floor);
  2. NLML_COMPENSATED      — double-word (two-float) reductions + one
                             iterative-refinement step with a double-word
                             residual on the quadratic term;
  3. CHOLESKY_PRECISION    — "high"/"highest": that matmul precision on
                             every factorization GEMM (on a GPU "highest"
                             is full FP32, the default may be TF32);
                             "double_word": double-word-carry trailing
                             matrix + exact-product GEMMs.

This example builds a moderately ill-conditioned GP covariance, computes
the NLML in every mode, and prints each mode's relative error against an
f64 oracle.  chip_smoke.py's phase f runs the accuracy mode on the GPU.

Run:  python examples/accuracy.py [--n 3000]
"""

from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

import albatross_tpu as ab
from albatross_tpu import config


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=3000)
    args = parser.parse_args()

    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0.0, 100.0, args.n))
    y = np.sin(0.3 * x) + 0.1 * rng.standard_normal(args.n)
    data = ab.RegressionDataset.create(
        jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)
    )
    kernel = ab.SquaredExponential(5.0, 1.0) + ab.measurement_only(
        ab.IndependentNoise(0.1, assume_unique=True)
    )
    model = ab.gp_from_covariance(kernel)

    # f64 oracle on the SAME f32 covariance the device sees
    from albatross_tpu.kernels import as_measurement

    K32 = kernel(as_measurement(data.features))
    K64 = np.asarray(K32, np.float64)
    y64 = np.asarray(data.targets.mean, np.float64)
    L64 = np.linalg.cholesky(K64)
    w64 = np.linalg.solve(L64, y64)
    ll64 = -0.5 * (
        2.0 * np.sum(np.log(np.diag(L64)))
        + w64 @ w64
        + args.n * math.log(2.0 * math.pi)
    )
    print(f"f64 oracle log-likelihood: {ll64:.6f}")

    modes = [
        ("plain f32", None, False, False),
        ("compensated", None, True, False),
        ("compensated + chol=highest", "highest", True, False),
        # XLA:CPU's fusion codegen breaks error-free transformations under
        # jit (see tests/test_compensated.py's canary), so the double-word
        # row runs eagerly on CPU to show the mode's true accuracy
        ("compensated + chol=double_word", "double_word", True, True),
    ]
    import contextlib

    on_cpu = jax.default_backend() == "cpu"
    for name, chol_mode, compensated, eager_on_cpu in modes:
        ctx = (
            jax.disable_jit()
            if (eager_on_cpu and on_cpu)
            else contextlib.nullcontext()
        )
        try:
            config.CHOLESKY_PRECISION = chol_mode
            config.NLML_COMPENSATED = compensated
            with ctx:
                ll = float(model.log_likelihood(data))
        finally:
            config.CHOLESKY_PRECISION = None
            config.NLML_COMPENSATED = False
        rel = abs(ll - ll64) / abs(ll64)
        print(f"{name:32s} ll={ll:+.6f}  rel error vs f64 = {rel:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
