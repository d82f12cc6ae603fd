"""Benchmark: exact-GP NLML-evaluation throughput on one NVIDIA GPU.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "device": {...}}

Workload: R full NLML evaluations (gram → blocked Cholesky → whitening →
log-det) at perturbed hyperparameters — the inner loop of marginal-likelihood
optimization/MCMC and the reference's hot path
(/root/reference/benchmarks/bench_gram.cc defines the equivalent cases; no
numbers are published).  Each timed call chains on the previous result, so
the R calls run back to back on the device; every window ends in
``block_until_ready``.

The card's name and power limit go to stderr first, as do the secondary
rows (serving, sampler, value+grad, high-D gram, accuracy, scale ladder),
which are also written to ``chiprun_out/bench_detail.json``.  Opt out of
them with ALBATROSS_BENCH_EXTRAS=0.  The script refuses to run without a
GPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

N = int(os.environ.get("ALBATROSS_BENCH_N", "28672"))
R = 8  # chained NLML evaluations per timed batch


def nlml_flops(n: int) -> float:
    cholesky = n**3 / 3.0
    whiten = n * n
    gram = 8.0 * n * n
    return cholesky + whiten + gram


def _device_record():
    import jax

    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }


def _measure_nlml(n: int, r: int, algorithm: str = "right"):
    """Best per-eval seconds for the full NLML pipeline at size n (r chained
    dispatches per timed batch).  ``algorithm`` selects the factorization
    loop order: "right" (the materialized covariance) or "right_fused"
    (lazy gram columns, the memory-lean mode)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import albatross_tpu as ab
    from albatross_tpu import config as _cfg

    rng = np.random.default_rng(0)
    x = jnp.asarray(np.sort(rng.uniform(0.0, 100.0, n)), dtype=jnp.float32)
    y = jnp.sin(0.3 * x) + 0.1 * jnp.asarray(
        rng.standard_normal(n), dtype=jnp.float32
    )

    kernel = ab.SquaredExponential(0.5, 1.0) + ab.measurement_only(
        ab.IndependentNoise(0.3, assume_unique=True)
    )
    model = ab.gp_from_covariance(kernel, jitter=1e-4)
    data = ab.RegressionDataset.create(x, y)

    prev_alg = _cfg.CHOLESKY_ALGORITHM
    _cfg.CHOLESKY_ALGORITHM = algorithm
    try:
        # fresh jit per call: the trace reads the algorithm knob eagerly
        # and threads it as a static arg into the inner program
        @jax.jit
        def nlml_step(model, data, prev):
            # perturb the length scale by an invisible function of the
            # previous result: each call depends on the last
            eps = 1e-30 * prev
            m = model.set_param_value(
                "squared_exponential_length_scale",
                jnp.float32(0.5) + eps,
            )
            return -m.log_likelihood(data)

        first = float(nlml_step(model, data, jnp.float32(0.0)))
        if not np.isfinite(first):
            raise RuntimeError(f"non-finite NLML at n={n}: {first}")

        def timed_batch():
            p = jnp.float32(0.0)
            t0 = time.perf_counter()
            for _ in range(r):
                p = nlml_step(model, data, p)
            jax.block_until_ready(p)
            return time.perf_counter() - t0

        timed_batch()  # one more warm batch
        best = min(timed_batch() for _ in range(3))
        return best / r
    finally:
        _cfg.CHOLESKY_ALGORITHM = prev_alg


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX found {dev.platform!r})", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    device = _device_record()
    print(json.dumps({"device": device, "nvidia_smi": smi}),
          file=sys.stderr, flush=True)
    from albatross_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()

    per_eval = _measure_nlml(N, R)
    tflops = nlml_flops(N) / per_eval / 1e12
    result = {
        "metric": f"exact_gp_nlml_tflops_n{N}",
        "value": round(tflops, 4),
        "unit": f"TFLOP/s ({1.0 / per_eval:.2f} NLML evals/s)",
        "device": device,
    }

    if os.environ.get("ALBATROSS_BENCH_EXTRAS", "1") != "0":
        details = [result] + _extra_benchmarks()
        out = os.path.join(os.path.dirname(__file__) or ".", "chiprun_out")
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "bench_detail.json"), "w") as fh:
            json.dump(details, fh, indent=1)
    print(json.dumps(result), flush=True)
    return 0


def _extra_benchmarks():
    """Serving-predict throughput, sampler walker-steps/s, value+grad, the
    high-D gram, the accuracy row and the scale ladder (each echoed to
    stderr as one JSON line)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import albatross_tpu as ab

    out = []

    def emit(metric, value, unit):
        rec = {"metric": metric, "value": value, "unit": unit}
        print(json.dumps(rec), file=sys.stderr, flush=True)
        out.append(rec)

    rng = np.random.default_rng(1)
    # -- serving predict: for_serving() marginal predictions ----------------
    n, m = 8192, 4096
    x = jnp.asarray(np.sort(rng.uniform(0.0, 100.0, n)), dtype=jnp.float32)
    y = jnp.sin(0.3 * x)
    xs = jnp.asarray(np.sort(rng.uniform(0.0, 100.0, m)), dtype=jnp.float32)
    kernel = ab.SquaredExponential(2.0, 1.0) + ab.measurement_only(
        ab.IndependentNoise(0.3, assume_unique=True)
    )
    model = ab.gp_from_covariance(kernel, jitter=1e-4)
    fit = model.fit(ab.RegressionDataset.create(x, y)).for_serving()
    R = 64  # batches chained inside one jit

    @jax.jit
    def predict_chain(fit, xs):
        def body(prev, _):
            p = fit.predict(xs + 1e-30 * prev).marginal()
            # the carry must consume EVERY output element, or XLA slices
            # the batch GEMMs down to the one column it needs
            carry = p.mean[0] + 1e-30 * (
                jnp.sum(p.mean) + jnp.sum(p.variance)
            )
            return carry, carry

        last, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=R)
        return last

    jax.block_until_ready(predict_chain(fit, xs))

    def one_run():
        t0 = time.perf_counter()
        jax.block_until_ready(predict_chain(fit, xs))
        return (time.perf_counter() - t0) / R

    times = sorted(one_run() for _ in range(5))
    dt = times[2]
    emit(
        f"serving_predict_points_per_s_n{n}_m{m}",
        m / dt / 1e6,
        f"Mpts/s ({dt * 1000:.3f} ms/batch, median of 5; "
        f"min {times[0] * 1000:.3f}, max {times[-1] * 1000:.3f})",
    )

    # -- sampler: walker-steps/s ---------------------------------------------
    ns, w, iters = 1024, 32, 64
    xsamp = jnp.asarray(np.sort(rng.uniform(0.0, 10.0, ns)), dtype=jnp.float32)
    data = ab.RegressionDataset.create(xsamp, jnp.sin(xsamp))
    smodel = ab.gp_from_covariance(
        ab.SquaredExponential(1.5, 1.0) + ab.IndependentNoise(0.1),
        jitter=1e-5,
    )
    from albatross_tpu.core.parameters import set_tunable_params
    from albatross_tpu.samplers import (
        ensemble_sampler,
        initial_params_from_jitter,
    )

    # one stable log_prob_fn so the warmup chain's compiled scan is reused
    # by the timed chain (the module-level _run_chunk jit keys on it)
    params0 = smodel.get_params()

    def single_log_prob(t):
        return smodel.set_params(set_tunable_params(params0, t)).log_likelihood(data)

    log_prob_fn = jax.jit(jax.vmap(single_log_prob))
    init = initial_params_from_jitter(
        jax.random.PRNGKey(0), smodel.get_tunable_parameters().values, w
    )
    ensemble_sampler(log_prob_fn, init, iters, jax.random.PRNGKey(1))
    t0 = time.perf_counter()
    ensemble_sampler(log_prob_fn, init, iters, jax.random.PRNGKey(1))
    dt = time.perf_counter() - t0
    emit(
        f"sampler_walker_steps_per_s_n{ns}_w{w}",
        w * iters / dt,
        f"walker-steps/s ({iters} iters in {dt:.3f}s)",
    )

    # -- NLML value+grad: the tuning hot loop --------------------------------
    gmodel = ab.gp_from_covariance(
        ab.SquaredExponential(0.5, 1.0)
        + ab.measurement_only(ab.IndependentNoise(0.3, assume_unique=True)),
        jitter=1e-4,
    )

    @jax.jit
    def value_and_grad_step(model, data, prev):
        m = model.set_param_value(
            "squared_exponential_length_scale", jnp.float32(0.5) + 1e-30 * prev
        )
        v, g = jax.value_and_grad(lambda mm: -mm.log_likelihood(data))(m)
        # the returned scalar must CONSUME every gradient leaf: returning v
        # alone lets XLA dead-code-eliminate the whole backward pass
        gsum = sum(jnp.sum(leaf) for leaf in jax.tree_util.tree_leaves(g))
        return v + 1e-30 * gsum

    for ng, reps in ((8192, 8), (N, 4)):
        xg = jnp.asarray(np.sort(rng.uniform(0.0, 100.0, ng)), dtype=jnp.float32)
        gdata = ab.RegressionDataset.create(xg, jnp.sin(0.3 * xg))
        v0 = float(value_and_grad_step(gmodel, gdata, jnp.float32(0.0)))
        if not np.isfinite(v0):
            raise RuntimeError(f"non-finite value+grad NLML at n={ng}: {v0}")
        t0 = time.perf_counter()
        p = jnp.float32(0.0)
        for _ in range(reps):
            p = value_and_grad_step(gmodel, gdata, p)
        jax.block_until_ready(p)
        dt = (time.perf_counter() - t0) / reps
        emit(
            f"nlml_value_and_grad_evals_per_s_n{ng}",
            1.0 / dt,
            f"evals/s ({dt * 1e3:.3f} ms/eval)",
        )

    # -- high-D gram: the exact per-pair form at N=8192, D=32 -----------------
    ng, d = 8192, 32
    Xg = jnp.asarray(rng.uniform(0.0, 100.0, (ng, d)), dtype=jnp.float32)
    gram = jax.jit(lambda X: ab.SquaredExponential(150.0, 1.0)(X))
    jax.block_until_ready(gram(Xg))
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(gram(Xg))
        ts.append(time.perf_counter() - t0)
    emit(f"gram_highd_ms_n{ng}_d{d}", sorted(ts)[2] * 1e3, "ms (median of 5)")

    # -- accuracy: NLML vs an f64 host oracle, four variants ------------------
    # Build K on device through the library gram path, compute the f64
    # oracle on the host, then evaluate each variant in ITS OWN jitted
    # program.  The seed-0 draw is fixed so variants compare across runs.
    from albatross_tpu import config
    from albatross_tpu.kernels import as_measurement
    from albatross_tpu.ops.compensated import compensated_nll_dw
    from albatross_tpu.ops.linalg import CholeskyFactor

    na = int(os.environ.get("ALBATROSS_BENCH_ACC_N", "8192"))
    rng_acc = np.random.default_rng(0)
    xa = jnp.asarray(np.sort(rng_acc.uniform(0.0, 100.0, na)), dtype=jnp.float32)
    ya = jnp.sin(0.3 * xa) + 0.1 * jnp.asarray(
        rng_acc.standard_normal(na), dtype=jnp.float32
    )
    akern = ab.SquaredExponential(5.0, 1.0) + ab.measurement_only(
        ab.IndependentNoise(0.1, assume_unique=True)
    )
    Ka = jax.jit(lambda x: akern(as_measurement(x)))(xa)
    log2pi = float(np.log(2.0 * np.pi))

    @jax.jit
    def plain_nll(K, y):
        chol, white = CholeskyFactor.factorize_whiten(K, y, assume_symmetric=True)
        return 0.5 * (
            chol.log_determinant() + jnp.sum(white * white) + na * log2pi
        )

    @jax.jit
    def comp_nll(K, y):
        chol = CholeskyFactor.factorize(K, assume_symmetric=True)
        return compensated_nll_dw(chol, K, y)

    prev_precision = config.CHOLESKY_PRECISION
    vals = {}
    try:
        for name, precision, comp in (
            ("plain_default", None, False),
            ("plain_highest", "highest", False),
            ("comp", "highest", True),
            ("comp_dw", "double_word", True),
        ):
            config.CHOLESKY_PRECISION = precision
            if comp:
                ch, cl = comp_nll(Ka, ya)
                # combine the double word in f64 on the host
                vals[name] = float(ch) + float(cl)
            else:
                vals[name] = float(plain_nll(Ka, ya))
            # jit caches key on the traced closure, not the config value
            plain_nll.clear_cache()
            comp_nll.clear_cache()
    finally:
        config.CHOLESKY_PRECISION = prev_precision
    K64 = np.asarray(Ka, np.float64)
    L64 = np.linalg.cholesky(K64)
    w64 = np.linalg.solve(L64, np.asarray(ya, np.float64))
    nll64 = 0.5 * (2.0 * np.sum(np.log(np.diag(L64))) + w64 @ w64 + na * log2pi)

    def rel(name):
        v = vals[name]
        return abs(v - nll64) / abs(nll64) if np.isfinite(v) else float("nan")

    emit(
        f"nlml_rel_err_compensated_n{na}",
        rel("comp"),
        "rel vs f64 oracle (plain_default: "
        f"{rel('plain_default'):.3e}; plain_highest: "
        f"{rel('plain_highest'):.3e}; comp_dw: {rel('comp_dw'):.3e}; "
        "target 1e-6)",
    )

    # -- scale ladder on the materialized path, then the lazy-gram mode -------
    if os.environ.get("ALBATROSS_BENCH_SCALE", "1") != "0":
        max_n = int(os.environ.get("ALBATROSS_BENCH_SCALE_MAX", "57344"))
        for n_scale in (32768, 40960, 49152, 57344):
            if n_scale > max_n:
                break
            try:
                per_eval = _measure_nlml(n_scale, 2)
            except Exception as exc:  # the first failing N is the finding
                emit(f"exact_gp_nlml_n{n_scale}_error", 0.0, str(exc)[:200])
                break
            emit(
                f"exact_gp_nlml_tflops_n{n_scale}",
                nlml_flops(n_scale) / per_eval / 1e12,
                f"TFLOP/s ({1.0 / per_eval:.3f} NLML evals/s)",
            )
        n_big = int(os.environ.get("ALBATROSS_BENCH_SCALE_100K", "102400"))
        if n_big:
            per_eval = _measure_nlml(n_big, 2, algorithm="right_fused")
            emit(
                f"exact_gp_nlml_tflops_n{n_big}_right_fused",
                nlml_flops(n_big) / per_eval / 1e12,
                f"TFLOP/s ({per_eval:.3f} s/NLML eval, lazy-gram mode)",
            )
    return out


if __name__ == "__main__":
    sys.exit(main())
