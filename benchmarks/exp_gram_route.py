"""High-D radial gram: the Pallas-Triton kernel against XLA's fused form.

The training covariance K_ij = σ² exp(−Σ_k (x_ik − x_jk)²/ℓ²) + diag_i·[i=j]
of an (N, D) f32 batch, two ways:

* ``xla``: the plain form (``ops/triton_gram.py`` _xla_gram — exact
  per-pair differences that XLA fuses into one reduction — plus the
  diagonal add);
* ``triton``: the library's GPU kernel (``training_gram``), one tile per
  program with the diagonal add fused in.

Measured at N=8192 for each D of ``--dims`` (the gram alone, checked
against f64), and with ``--fit`` inside a fit at N=28672/D=32 (gram +
blocked Cholesky + solve); each time is the median of 5 timed calls ending
in ``block_until_ready``.  Records go to ``chiprun_out/gram_route.json``.
On an H100, XLA compiled its form for 7m40s at D=64 and had not finished
D=256 some minutes later, so the default list leaves both out.

    python -m benchmarks.exp_gram_route [--dims 9,16,32,128] [--fit]
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _median_time(fn, *args, reps=5):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--dims", default="4,8,9,12,16,24,32,128")
    parser.add_argument("--fit", action="store_true")
    args = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from albatross_tpu.ops.linalg import CholeskyFactor
    from albatross_tpu.ops.triton_gram import _xla_gram, training_gram
    from albatross_tpu.utils.compile_cache import enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("exp_gram_route: needs a GPU", file=sys.stderr)
        return 2
    enable_compilation_cache()
    ls, sigma, diag_value = 150.0, 1.0, 0.09 + 1e-4
    profile = "squared_exponential"
    rng = np.random.default_rng(2)
    records = []

    def emit(**rec):
        rec.update(device=dev.device_kind)
        print(json.dumps(rec), flush=True)
        records.append(rec)

    grams = {
        "xla": lambda x, dg: _xla_gram(x, x, ls, sigma, profile) + jnp.diag(dg),
        "triton": lambda x, dg: training_gram(x, ls, sigma, dg, profile),
    }
    n = 8192
    for d in (int(v) for v in args.dims.split(",")):
        X = rng.uniform(0.0, 100.0 * (32 / d) ** 0.5, (n, d)).astype(np.float32)
        X64 = X.astype(np.float64)
        sq = np.sum(X64 * X64, axis=1)
        d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * X64 @ X64.T, 0.0)
        K64 = sigma**2 * np.exp(-d2 / ls**2) + diag_value * np.eye(n)
        Xj, dg = jnp.asarray(X), jnp.full((n,), diag_value, jnp.float32)
        for route, gram in grams.items():
            fn = jax.jit(gram)
            try:
                K = np.asarray(fn(Xj, dg))
            except Exception as exc:  # a route that fails at this D is a finding
                emit(route=route, what=f"gram n={n} d={d}",
                     error=f"{type(exc).__name__}: {str(exc)[:300]}")
                continue
            emit(route=route, what=f"gram n={n} d={d}",
                 ms=_median_time(fn, Xj, dg) * 1e3,
                 max_abs_err=float(np.max(np.abs(K - K64))),
                 symmetric=bool(np.array_equal(K, K.T)))
            del K
    if not args.fit:
        return _write(records)

    d = 32
    n = 28672
    X = jnp.asarray(rng.uniform(0.0, 100.0, (n, d)), jnp.float32)
    y = jnp.sin(0.05 * X[:, 0]) + 0.1 * jnp.asarray(
        rng.standard_normal(n), jnp.float32
    )
    dg = jnp.full((n,), diag_value, jnp.float32)
    for route, gram in grams.items():
        fit = jax.jit(lambda x, v, gram=gram: CholeskyFactor.factorize(
            gram(x, dg), assume_symmetric=True).solve(v))
        emit(route=route, what=f"fit n={n} d={d}",
             ms=_median_time(fit, X, y) * 1e3)
    return _write(records)


def _write(records) -> int:
    out = os.path.join(os.path.dirname(__file__), "..", "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "gram_route.json"), "w") as fh:
        json.dump(records, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
