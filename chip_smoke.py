"""Smoke test of the exact-GP main path on an NVIDIA GPU.

    python chip_smoke.py               # one card: phases a-i
    python chip_smoke.py --multi       # four cards: sharded NLML + gradient

Every phase drives the public API (``gp_from_covariance``,
``RegressionDataset.create``, ``log_likelihood``, ``jax.value_and_grad``,
``fit(...).for_serving().predict(...)``, ``ensemble_sampler``,
``parallel.distributed_gp_from_covariance``) at deployment sizes with
weights and data drawn from fixed seeds, and compares the result with a
plain float64 reference that shares no code with the path under test
(``jnp.linalg.cholesky`` under ``jax.enable_x64``, or scipy on the host).
Each phase prints one line: result, error against the reference,
tolerance, matmul precision, median time (``block_until_ready``) and
``peak_bytes_in_use``.  Any failed check exits non-zero; the last line of
a passing run is ``{"ok": true, "device": {...}}``.

The script refuses to run without a GPU.  ``--rehearse`` runs the same
phases at small sizes on whatever device JAX has (the CPU, for checking
the control flow) and prints no result line for a GPU.

Dense f64 references are built and factorized on the card, up to
N=57344 (two 26 GB f64 matrices).  Phases past that (N=102400 on one
card, N=131072 on four) use data made of separate clusters: clusters lie
farther apart than the covariance reaches (exp(−d²/ℓ²) underflows to an
exact 0), so the covariance is exactly block diagonal, the path under test
still factorizes the whole dense matrix, and the f64 reference is the sum
of the clusters' NLMLs.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

LOG_2PI = math.log(2.0 * math.pi)

FULL = dict(
    probe=4096,
    headline=28672,
    materialized_big=57344,
    grad=(8192, 28672),
    serve=(8192, 4096),
    highd=(8192, 32),
    accuracy=8192,
    big=102400,
    sampler=(1024, 32, 16),
    cluster=4096,
    multi=32768,
    multi_big=131072,
)
REHEARSE = dict(
    probe=256,
    headline=3072,
    materialized_big=4096,
    grad=(1024, 3072),
    serve=(1024, 256),
    highd=(512, 32),
    accuracy=1024,
    big=6144,
    sampler=(128, 8, 4),
    cluster=1024,
    multi=2048,
    multi_big=4096,
)


# Gradient tolerance: largest component difference over the largest
# component.  An H100 read 2.9e-6 at N=8192 and 2.5e-5 at N=28672 (PERF.md).
GRAD_TOL = 1e-4


class PhaseFailure(AssertionError):
    pass


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def peak_bytes(device=None):
    import jax

    stats = (device or jax.devices()[0]).memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


def compiled_bytes(compiled) -> int:
    m = compiled.memory_analysis()
    return int(
        m.temp_size_in_bytes + m.argument_size_in_bytes
        + m.output_size_in_bytes - m.alias_size_in_bytes
    )


def timed(fn, *args, reps: int = 3, warm: bool = True):
    """(output, median seconds) over ``reps`` calls, after one warm call
    unless ``fn`` is already compiled (``warm=False``)."""
    import jax

    out = jax.block_until_ready(fn(*args)) if warm else None
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times)


def report(phase: str, name: str, *, result, err, tol, precision,
           seconds, extra: str = "", ok: bool | None = None):
    if ok is None:
        ok = bool(np.isfinite(err)) and err <= tol
    fields = [
        f"[{phase}] {name}",
        f"result={result}",
        f"err={err:.3e}",
        f"tol={tol:.1e}",
        f"precision={precision}",
        f"median_s={seconds:.6f}" if seconds is not None else "median_s=-",
        f"peak_bytes_in_use={peak_bytes()}",
    ]
    if extra:
        fields.append(extra)
    fields.append("PASS" if ok else "FAIL")
    print(" ".join(fields), flush=True)
    if not ok:
        raise PhaseFailure(f"phase {phase} {name}: err={err:.3e} tol={tol:.1e}")


def rel(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / abs(b) if np.isfinite(a) else float("inf")


# ---------------------------------------------------------------------------
# Workloads (seeded) and their f64 references
# ---------------------------------------------------------------------------
def _points(rng, n: int, width: float, unique: bool):
    """n sorted points on [0, width): uniform draws, or with ``unique`` a
    jittered grid (one point per cell of width/n), which keeps every
    point distinct in f32.  Sharded grams compare feature VALUES for
    IndependentNoise, so repeated f32 values (which uniform draws of this
    size produce) would make them a different matrix from the single
    card's."""
    if unique:
        return width * (np.arange(n) + rng.uniform(0.0, 0.5, n)) / n
    return np.sort(rng.uniform(0.0, width, n))


def headline_data(n: int, seed: int = 0, unique: bool = False):
    """bench.py's headline draw: x ~ U[0, 100] sorted, y = sin(0.3x) + noise."""
    rng = np.random.default_rng(seed)
    x = _points(rng, n, 100.0, unique).astype(np.float32)
    y = (np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return x, y


def clustered_data(n: int, cluster: int, seed: int = 0, unique: bool = False):
    """n/cluster clusters, each the headline draw at N=cluster rescaled to
    the headline's density, 20 apart: the SE covariance at ℓ=0.5 between
    clusters is exp(−1600) = 0 exactly."""
    assert n % cluster == 0
    rng = np.random.default_rng(seed)
    width = 100.0 * cluster / FULL["headline"]
    xs = []
    for c in range(n // cluster):
        xs.append(c * (width + 20.0) + _points(rng, cluster, width, unique))
    x = np.concatenate(xs).astype(np.float32)
    y = (np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return x, y


def se_model(ls: float, sigma: float, noise: float, jitter: float):
    import albatross_tpu as ab

    kernel = ab.SquaredExponential(ls, sigma) + ab.measurement_only(
        ab.IndependentNoise(noise, assume_unique=True)
    )
    return ab.gp_from_covariance(kernel, jitter=jitter)


def sqdist64(x, z=None):
    """Exact f64 squared distances on the host (scipy, not the library)."""
    from scipy.spatial.distance import cdist

    x = np.asarray(x, np.float64).reshape(len(x), -1)
    z = x if z is None else np.asarray(z, np.float64).reshape(len(z), -1)
    return cdist(x, z, "sqeuclidean")


def se_cov64(d2, ls, sigma):
    return sigma * sigma * np.exp(-d2 / (ls * ls))


def nlml64(K, y):
    """(NLML, log|K|) in float64 via jnp.linalg.cholesky (batched over a
    leading axis when K is 3-D), summed over the batch."""
    import jax
    import jax.numpy as jnp

    with jax.enable_x64(True):
        nll, logdet = _nlml64_arrays(
            jnp.asarray(K, jnp.float64), jnp.asarray(y, jnp.float64)
        )
        return float(nll), float(logdet)


def _nlml64_arrays(K, y):
    import jax.numpy as jnp
    from jax.scipy.linalg import solve_triangular

    L = jnp.linalg.cholesky(K)
    w = solve_triangular(L, y[..., None], lower=True)[..., 0]
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)))
    return 0.5 * (logdet + jnp.sum(w * w) + y.size * LOG_2PI), logdet


def _se_cov64_device(x, ls, sigma, diag):
    """σ² exp(−(xᵢ − xⱼ)²/ℓ²) + diag·I in f64, built on the device."""
    import jax.numpy as jnp

    d2 = (x[:, None] - x[None, :]) ** 2
    eye = jnp.arange(x.size)[:, None] == jnp.arange(x.size)[None, :]
    return sigma * sigma * jnp.exp(-d2 / (ls * ls)) + jnp.where(eye, diag, 0.0)


def _run64(fn, *args):
    """fn(*args) in float64 on the device.  Compiled without autotuning:
    the autotuner times each fusion on buffers of its own, outside the
    allocator's pool, and an N=57344 f64 matrix (26 GB) twice does not fit
    beside the pool."""
    import jax
    import jax.numpy as jnp

    with jax.enable_x64(True):
        args = [jnp.asarray(a, jnp.float64) for a in args]
        compiled = jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_gpu_autotune_level": 0}
        )
        return jax.tree_util.tree_map(float, compiled(*args))


def headline_nlml64(x, y, ls, sigma, diag):
    """(NLML, log|K|) of the 1-D SE covariance in f64: the matrix is built
    and factorized inside one program on the device, so the host never
    holds it."""
    return tuple(_run64(
        lambda x, y: _nlml64_arrays(_se_cov64_device(x, ls, sigma, diag), y),
        x, y,
    ))


def clustered_nlml64(x, y, cluster, ls, sigma, diag):
    g = len(x) // cluster
    xb = np.asarray(x, np.float64).reshape(g, cluster)
    d2 = (xb[:, :, None] - xb[:, None, :]) ** 2
    K = se_cov64(d2, ls, sigma) + diag * np.eye(cluster)[None]
    return nlml64(K, np.asarray(y).reshape(g, cluster))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------
def phase_a_device(rehearse: bool):
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not rehearse:
        print(
            f"chip_smoke: no GPU (JAX found {dev.platform!r}); refusing to run",
            file=sys.stderr,
        )
        sys.exit(2)
    smi = "n/a" if rehearse and dev.platform != "gpu" else nvidia_smi(
        "name,power.limit"
    )
    print(
        f"[a] device platform={dev.platform} kind={dev.device_kind!r} "
        f"count={len(jax.devices())} jax={jax.__version__}",
        flush=True,
    )
    print(f"[a] nvidia-smi name,power.limit: {smi}", flush=True)
    return dev


def phase_a_precision(n: int):
    """What None / HIGH / HIGHEST compute for an f32 product here."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.max(np.abs(ref))
    A, B = jnp.asarray(a), jnp.asarray(b)
    errs = {}
    for name, prec in (
        ("default", None),
        ("high", jax.lax.Precision.HIGH),
        ("highest", jax.lax.Precision.HIGHEST),
    ):
        f = jax.jit(lambda p, q, prec=prec: jnp.matmul(p, q, precision=prec))
        out, t = timed(f, A, B)
        errs[name] = float(np.max(np.abs(np.asarray(out, np.float64) - ref)) / scale)
        print(
            f"[a] matmul n={n} precision={name} rel_err={errs[name]:.3e} "
            f"median_s={t:.6f} tflops={2 * n**3 / t / 1e12:.1f}",
            flush=True,
        )
    from albatross_tpu.ops.compensated import EXACT_PRODUCT_PRECISION

    assert EXACT_PRODUCT_PRECISION == jax.lax.Precision.HIGHEST
    report(
        "a", "exact_product_precision", result="HIGHEST",
        err=errs["highest"], tol=1e-5, precision="highest", seconds=None,
    )
    return errs


def _nlml_compiled(model, data):
    import jax

    f = jax.jit(lambda m, d: -m.log_likelihood(d))
    return f.lower(model, data).compile()


def phase_b_headline(sizes, state):
    import albatross_tpu as ab

    n = sizes["headline"]
    x, y = headline_data(n)
    model = se_model(0.5, 1.0, 0.3, 1e-4)
    data = ab.RegressionDataset.create(x, y)
    compiled = _nlml_compiled(model, data)
    mem = compiled_bytes(compiled)
    nll, t = timed(compiled, model, data)
    ref, logdet = headline_nlml64(x, y, 0.5, 1.0, 0.09 + 1e-4)
    state["headline"] = dict(x=x, y=y, nll64=ref, logdet64=logdet)
    report(
        "b", f"nlml n={n}", result=f"{float(nll):.6f}", err=rel(nll, ref),
        tol=1e-3, precision="default", seconds=t,
        extra=f"ref64={ref:.6f} compiled_bytes={mem} "
        f"peak_matrices={mem / (n * n * 4):.3f}",
    )

    # past N=32768, where the panels' trailing products are dense: the
    # same headline draw, compared with a dense f64 factorization
    n = sizes["materialized_big"]
    x, y = headline_data(n)
    data = ab.RegressionDataset.create(x, y)
    compiled = _nlml_compiled(model, data)
    mem = compiled_bytes(compiled)
    nll, t = timed(compiled, model, data, reps=1, warm=False)
    del compiled
    ref, _ = headline_nlml64(x, y, 0.5, 1.0, 0.09 + 1e-4)
    report(
        "b", f"nlml n={n}", result=f"{float(nll):.6f}", err=rel(nll, ref),
        tol=1e-3, precision="default", seconds=t,
        extra=f"ref64={ref:.6f} compiled_bytes={mem} "
        f"peak_matrices={mem / (n * n * 4):.3f}",
    )


def _grad_reference(x, y, ls, sigma, noise, jitter):
    """Closed-form f64 gradient of the NLML, ½ Σᵢⱼ (K⁻¹ − ααᵀ)ᵢⱼ ∂Kᵢⱼ,
    built on the device; each ∂K is formed inside its own reduction."""
    import jax
    import jax.numpy as jnp

    def grads(x, y):
        n = x.size
        K = _se_cov64_device(x, ls, sigma, noise**2 + jitter)
        L = jnp.linalg.cholesky(K)
        Kinv = jax.scipy.linalg.cho_solve((L, True), jnp.eye(n, dtype=K.dtype))
        alpha = Kinv @ y
        M = Kinv - alpha[:, None] * alpha[None, :]
        d2 = (x[:, None] - x[None, :]) ** 2
        E = jnp.exp(-d2 / (ls * ls))
        return {
            "squared_exponential_length_scale":
                0.5 * jnp.sum(M * (sigma**2 * E * 2.0 * d2 / ls**3)),
            "sigma_squared_exponential": 0.5 * jnp.sum(M * (2.0 * sigma * E)),
            # ∂K/∂σ_noise = 2σ_noise I
            "sigma_independent_noise": noise * jnp.trace(M),
        }

    return _run64(grads, x, y)


def phase_c_value_and_grad(sizes, state):
    import jax

    import albatross_tpu as ab

    model = se_model(0.5, 1.0, 0.3, 1e-4)

    @jax.jit
    def value_and_grad(m, d):
        # returning the whole gradient pytree consumes every leaf
        return jax.value_and_grad(lambda mm: -mm.log_likelihood(d))(m)

    for n in sizes["grad"]:
        if n == sizes["headline"] and "headline" in state:
            x, y = state["headline"]["x"], state["headline"]["y"]
            ref_v = state["headline"]["nll64"]
        else:
            x, y = headline_data(n)
            ref_v = headline_nlml64(x, y, 0.5, 1.0, 0.09 + 1e-4)[0]
        data = ab.RegressionDataset.create(x, y)
        (v, g), t = timed(value_and_grad, model, data)
        grads = {k: float(p.value) for k, p in g.get_params().items()}
        finite = all(np.isfinite(list(grads.values()))) and np.isfinite(float(v))
        ref = _grad_reference(x, y, 0.5, 1.0, 0.3, 1e-4)
        scale = max(abs(r) for r in ref.values())
        err = max(abs(grads[k] - ref[k]) for k in ref) / scale
        err = err if finite else float("inf")
        report(
            "c", f"value_and_grad n={n}",
            result=f"{float(v):.6f} {json.dumps(grads)}",
            err=err, tol=GRAD_TOL, precision="default", seconds=t,
            extra=f"value_err={rel(v, ref_v):.3e} value_tol=1.0e-03 "
            f"grad_ref64={json.dumps(ref)}",
            ok=err <= GRAD_TOL and rel(v, ref_v) <= 1e-3,
        )


def phase_d_serving(sizes):
    import jax
    import jax.numpy as jnp

    import albatross_tpu as ab

    n, m = sizes["serve"]
    rng = np.random.default_rng(1)
    x = np.sort(rng.uniform(0.0, 100.0, n)).astype(np.float32)
    y = np.sin(0.3 * x).astype(np.float32)
    xs = np.sort(rng.uniform(0.0, 100.0, m)).astype(np.float32)
    model = se_model(2.0, 1.0, 0.3, 1e-4)
    fit = model.fit(ab.RegressionDataset.create(x, y)).for_serving()
    predict = jax.jit(lambda f, q: f.predict(q).marginal())
    pred, t = timed(predict, fit, jnp.asarray(xs))
    mean, var = np.asarray(pred.mean), np.asarray(pred.variance)

    K = se_cov64(sqdist64(x), 2.0, 1.0) + (0.09 + 1e-4) * np.eye(n)
    Ks = se_cov64(sqdist64(x, xs), 2.0, 1.0)
    with jax.enable_x64(True):
        c = jax.scipy.linalg.cho_factor(jnp.asarray(K))
        alpha = jax.scipy.linalg.cho_solve(c, jnp.asarray(y, jnp.float64))
        mean64 = np.asarray(jnp.asarray(Ks).T @ alpha)
        var64 = 1.0 - np.asarray(
            jnp.sum(jnp.asarray(Ks) * jax.scipy.linalg.cho_solve(c, jnp.asarray(Ks)), 0)
        )
    err_mean = float(np.max(np.abs(mean - mean64)))
    err_var = float(np.max(np.abs(var - var64)))
    from albatross_tpu.ops.linalg import DirectInverse

    prec = DirectInverse.solve_precision
    report(
        "d", f"serving mean n={n} m={m}", result=f"{mean[:3].tolist()}",
        err=err_mean, tol=1e-3, precision=f"solve={prec}", seconds=t,
        extra=f"points_per_s={m / t:.1f}",
    )
    report(
        "d", f"serving variance n={n} m={m}", result=f"{var[:3].tolist()}",
        err=err_var, tol=1e-3, precision=f"solve={prec}", seconds=t,
    )


def phase_e_highd(sizes):
    import jax
    import jax.numpy as jnp

    import albatross_tpu as ab

    n, d = sizes["highd"]
    ls, sigma = 150.0, 1.0
    rng = np.random.default_rng(2)
    X = rng.uniform(0.0, 100.0, (n, d)).astype(np.float32)
    y = (np.sin(0.05 * X[:, 0]) + np.cos(0.03 * X[:, 1])
         + 0.1 * rng.standard_normal(n)).astype(np.float32)
    kernel = ab.SquaredExponential(ls, sigma)
    gram = jax.jit(lambda k, x: k(x)).lower(kernel, jnp.asarray(X)).compile()
    K, t = timed(gram, kernel, jnp.asarray(X))
    K = np.asarray(K)
    d2 = sqdist64(X)
    K64 = se_cov64(d2, ls, sigma)
    err = float(np.max(np.abs(K - K64)))
    symmetric = bool(np.array_equal(K, K.T))
    diag_exact = bool(np.all(np.diag(K) == np.float32(sigma * sigma)))
    mem = compiled_bytes(gram)
    from albatross_tpu.ops.triton_gram import _xla_gram, use_triton_gram

    route = "triton" if use_triton_gram(jnp.asarray(X), jnp.asarray(X)) else "xla"
    report(
        "e", f"gram n={n} d={d}", result=f"{K[0, 1]:.7f}", err=err,
        tol=1e-5 * sigma**2, precision="exact differences", seconds=t,
        extra=f"route={route} symmetric={symmetric} diag_exact={diag_exact} "
        f"compiled_bytes={mem} n2_f32_bytes={n * n * 4}",
        ok=err <= 1e-5 * sigma**2 and symmetric and diag_exact
        and mem < 2 * n * n * 4,
    )
    # the plain XLA form the kernel replaces, on the same inputs
    plain = jax.jit(
        lambda x: _xla_gram(x, x, ls, sigma, "squared_exponential")
    )
    Kx, tx = timed(plain, jnp.asarray(X))
    report(
        "e", f"gram vs plain xla n={n} d={d}", result=f"xla_s={tx:.6f}",
        err=float(np.max(np.abs(K - np.asarray(Kx)))), tol=1e-5 * sigma**2,
        precision="exact differences", seconds=t,
        extra=f"route={route} xla_err64={np.max(np.abs(np.asarray(Kx) - K64)):.3e}",
    )

    model = ab.gp_from_covariance(
        kernel + ab.measurement_only(ab.IndependentNoise(0.3, assume_unique=True)),
        jitter=1e-4,
    )
    data = ab.RegressionDataset.create(jnp.asarray(X), jnp.asarray(y))
    nll, t = timed(jax.jit(lambda m, dd: -m.log_likelihood(dd)), model, data)
    ref, _ = nlml64(K64 + (0.09 + 1e-4) * np.eye(n), y)
    report(
        "e", f"nlml n={n} d={d}", result=f"{float(nll):.6f}",
        err=rel(nll, ref), tol=1e-3, precision="default", seconds=t,
        extra=f"ref64={ref:.6f}",
    )

    Xq = rng.uniform(0.0, 100.0, (1024, d)).astype(np.float32)
    fit_predict = jax.jit(
        lambda m, dd, q: m.fit(dd).predict(q).mean()
    )
    mean, t = timed(fit_predict, model, data, jnp.asarray(Xq))
    Ks = se_cov64(sqdist64(X, Xq), ls, sigma)
    with jax.enable_x64(True):
        c = jax.scipy.linalg.cho_factor(
            jnp.asarray(K64 + (0.09 + 1e-4) * np.eye(n))
        )
        mean64 = np.asarray(
            jnp.asarray(Ks).T
            @ jax.scipy.linalg.cho_solve(c, jnp.asarray(y, jnp.float64))
        )
    err = float(np.max(np.abs(np.asarray(mean) - mean64)) / np.max(np.abs(mean64)))
    report(
        "e", f"fit+predict n={n} d={d} m=1024", result=f"{float(mean[0]):.6f}",
        err=err, tol=1e-2, precision="default", seconds=t,
    )


def phase_f_accuracy(sizes):
    import jax

    import albatross_tpu as ab
    from albatross_tpu import config

    n = sizes["accuracy"]
    rng = np.random.default_rng(0)  # bench.py's accuracy draw
    x = np.sort(rng.uniform(0.0, 100.0, n)).astype(np.float32)
    y = (np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    model = se_model(5.0, 1.0, 0.1, 0.0)
    data = ab.RegressionDataset.create(x, y)
    prev = config.NLML_COMPENSATED, config.CHOLESKY_PRECISION
    config.NLML_COMPENSATED, config.CHOLESKY_PRECISION = True, "highest"
    try:
        f = jax.jit(lambda m, d: -m.log_likelihood(d))
        nll, t = timed(f, model, data)
    finally:
        config.NLML_COMPENSATED, config.CHOLESKY_PRECISION = prev
    ref, _ = headline_nlml64(x, y, 5.0, 1.0, 0.01)
    report(
        "f", f"compensated nlml n={n}", result=f"{float(nll):.7f}",
        err=rel(nll, ref), tol=1e-6, precision="highest+compensated",
        seconds=t, extra=f"ref64={ref:.7f}",
    )


def phase_g_big(sizes):
    import albatross_tpu as ab
    from albatross_tpu import config

    n = sizes["big"]
    x, y = clustered_data(n, sizes["cluster"])
    model = se_model(0.5, 1.0, 0.3, 1e-4)
    data = ab.RegressionDataset.create(x, y)
    prev = config.CHOLESKY_ALGORITHM
    config.CHOLESKY_ALGORITHM = "right_fused"
    try:
        compiled = _nlml_compiled(model, data)
        nll, t = timed(compiled, model, data, reps=1, warm=False)
    finally:
        config.CHOLESKY_ALGORITHM = prev
    ref, _ = clustered_nlml64(x, y, sizes["cluster"], 0.5, 1.0, 0.09 + 1e-4)
    report(
        "g", f"nlml right_fused n={n}", result=f"{float(nll):.6f}",
        err=rel(nll, ref), tol=1e-3, precision="default", seconds=t,
        extra=f"ref64={ref:.6f} compiled_bytes={compiled_bytes(compiled)} "
        f"peak_matrices={compiled_bytes(compiled) / (n * n * 4):.3f}",
    )


def phase_h_sampler(sizes):
    import jax
    import jax.numpy as jnp

    import albatross_tpu as ab
    from albatross_tpu.core.parameters import set_tunable_params
    from albatross_tpu.samplers import (
        ensemble_sampler,
        initial_params_from_jitter,
    )

    n, w, iters = sizes["sampler"]
    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(0.0, 10.0, n)).astype(np.float32)
    # noisy observations: the posterior keeps the walkers' noise σ near
    # 0.3, so every covariance the chain visits is well conditioned
    y = (np.sin(x) + 0.3 * rng.standard_normal(n)).astype(np.float32)
    data = ab.RegressionDataset.create(x, y)
    model = ab.gp_from_covariance(
        ab.SquaredExponential(1.5, 1.0) + ab.IndependentNoise(0.3),
        jitter=1e-5,
    )
    params0 = model.get_params()

    def single_log_prob(t):
        return model.set_params(set_tunable_params(params0, t)).log_likelihood(data)

    log_prob_fn = jax.jit(jax.vmap(single_log_prob))
    init = initial_params_from_jitter(
        jax.random.PRNGKey(0), model.get_tunable_parameters().values, w
    )
    ensemble_sampler(log_prob_fn, init, iters, jax.random.PRNGKey(1))
    t0 = time.perf_counter()
    chain = ensemble_sampler(log_prob_fn, init, iters, jax.random.PRNGKey(1))
    jax.block_until_ready(chain.params)
    t = time.perf_counter() - t0
    params, lp = np.asarray(chain.params), np.asarray(chain.log_prob)
    finite = bool(np.all(np.isfinite(params)) and np.all(np.isfinite(lp)))
    # reference: the final walkers' log-probabilities in f64 from the
    # closed-form NLML (tunable order: noise σ, SE σ, SE ℓ; none
    # log-scaled; walkers are clamped into the parameter bounds)
    tunable = model.get_tunable_parameters()
    assert tunable.names == [
        "sigma_independent_noise",
        "sigma_squared_exponential",
        "squared_exponential_length_scale",
    ], tunable.names
    last = np.clip(
        params[-1].astype(np.float64),
        np.asarray(tunable.lower_bounds, np.float64),
        np.asarray(tunable.upper_bounds, np.float64),
    )
    d2 = sqdist64(x)
    errs = []
    for k in range(min(w, 4)):
        noise, sigma, ls = (float(v) for v in last[k])
        K = se_cov64(d2, ls, sigma) + (noise**2 + 1e-5) * np.eye(n)
        ref, _ = nlml64(K, y)
        errs.append(rel(-lp[-1, k], ref))
    report(
        "h", f"ensemble_sampler n={n} walkers={w} iters={iters}",
        result=f"lp_last={lp[-1, :3].tolist()}",
        err=max(errs) if finite else float("inf"), tol=1e-3,
        precision="default", seconds=t,
        extra=f"walker_steps_per_s={w * iters / t:.1f} (incl. host sync)",
    )


def phase_i_blocked_vs_builtin(sizes, state):
    import jax
    import jax.numpy as jnp

    import albatross_tpu as ab
    from albatross_tpu.kernels import as_measurement
    from albatross_tpu.ops.blocked_cholesky import blocked_cholesky_cols

    n = sizes["headline"]
    if "headline" in state:
        x, logdet64 = state["headline"]["x"], state["headline"]["logdet64"]
    else:
        x, y = headline_data(n)
        _, logdet64 = headline_nlml64(x, y, 0.5, 1.0, 0.09 + 1e-4)
    kernel = ab.SquaredExponential(0.5, 1.0)
    K = jax.jit(
        lambda k, v: k(as_measurement(v))
        + (0.09 + 1e-4) * jnp.eye(v.shape[0], dtype=v.dtype)
    )(kernel, jnp.asarray(x))
    logdet = jax.jit(lambda L: 2.0 * jnp.sum(jnp.log(jnp.diagonal(L))))
    for name, fn in (
        ("blocked_cholesky_cols", jax.jit(blocked_cholesky_cols)),
        ("jnp.linalg.cholesky", jax.jit(jnp.linalg.cholesky)),
    ):
        L, t = timed(fn, K)
        ld = float(logdet(L))
        del L
        report(
            "i", f"{name} n={n}", result=f"logdet={ld:.4f}",
            err=rel(ld, logdet64), tol=1e-3, precision="default", seconds=t,
            extra=f"tflops={n**3 / 3 / t / 1e12:.2f}",
        )


def phase_multi(sizes):
    """Sharded NLML + gradient on four cards against the single card."""
    import jax

    import albatross_tpu as ab
    from albatross_tpu.parallel import distributed_gp_from_covariance, make_mesh

    ndev = len(jax.devices())
    if ndev < 4:
        raise PhaseFailure(f"--multi needs 4 devices, found {ndev}")
    kernel = ab.SquaredExponential(0.5, 1.0) + ab.measurement_only(
        ab.IndependentNoise(0.3, assume_unique=True)
    )
    single = ab.gp_from_covariance(kernel, jitter=1e-4)
    mesh1 = make_mesh(4, ("data",))
    mesh2 = make_mesh(4, ("data", "model"), shape=(2, 2))
    variants = {
        "1d": distributed_gp_from_covariance(
            kernel, mesh1, axis="data", jitter=1e-4
        ),
        "2d": distributed_gp_from_covariance(
            kernel, mesh2, axis="data", col_axis="model", jitter=1e-4
        ),
    }

    def value_and_grad_fn(model):
        # the model (and its mesh) is closed over; its gradient is taken
        # inside the jitted function and returned whole
        return jax.jit(
            lambda d: jax.value_and_grad(lambda m: -m.log_likelihood(d))(model)
        ).lower(data).compile()

    n = sizes["multi"]
    x, y = headline_data(n, unique=True)
    data = ab.RegressionDataset.create(x, y)
    # equivalence at full FP32 on both sides, so the comparison sees the
    # sharding and not TF32 rounding; the single-card reference uses
    # n/4-wide panels, which keeps its unrolled program quick to compile
    from albatross_tpu import config

    prev_block = config.CHOLESKY_BLOCK_SIZE
    config.CHOLESKY_BLOCK_SIZE = n // 4
    try:
        with jax.default_matmul_precision("highest"):
            (v0, g0), t0 = timed(value_and_grad_fn(single), data, reps=1,
                                 warm=False)
    finally:
        config.CHOLESKY_BLOCK_SIZE = prev_block
    with jax.default_matmul_precision("highest"):
        g0 = {k: float(p.value) for k, p in g0.get_params().items()}
        report(
            "multi", f"single-card value_and_grad n={n}",
            result=f"{float(v0):.6f} {json.dumps(g0)}", err=0.0, tol=0.0,
            precision="highest", seconds=t0,
        )
        for name, model in variants.items():
            (v, g), t = timed(value_and_grad_fn(model), data, reps=1,
                              warm=False)
            g = {k: float(p.value) for k, p in g.get_params().items()}
            err = max(
                [rel(v, v0)]
                + [abs(g[k] - g0[k]) / max(abs(r) for r in g0.values()) for k in g0]
            )
            report(
                "multi", f"{name} value_and_grad n={n}",
                result=f"{float(v):.6f} {json.dumps(g)}", err=err, tol=1e-4,
                precision="highest", seconds=t,
            )

    n = sizes["multi_big"]
    x, y = clustered_data(n, sizes["cluster"], unique=True)
    data = ab.RegressionDataset.create(x, y)
    model = variants["2d"]
    compiled = jax.jit(lambda d: -model.log_likelihood(d)).lower(data).compile()
    temp = compiled.memory_analysis().temp_size_in_bytes
    nll, t = timed(compiled, data, reps=1, warm=False)
    del compiled
    ref, _ = clustered_nlml64(x, y, sizes["cluster"], 0.5, 1.0, 0.09 + 1e-4)
    peaks = [peak_bytes(dv) for dv in jax.devices()[:4]]
    report(
        "multi", f"2d nlml n={n}", result=f"{float(nll):.6f}",
        err=rel(nll, ref), tol=1e-3, precision="default", seconds=t,
        extra=f"ref64={ref:.6f} per_device_peak_bytes={peaks} "
        f"per_device_temp_bytes={temp} tile_bytes={n * n * 4 // 4} "
        f"covariance_bytes={n * n * 4}",
    )


PHASES = "bcdefghi"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--multi", action="store_true",
                        help="run only the four-card sharded path")
    parser.add_argument("--phases", default=PHASES,
                        help=f"subset of the one-card phases {PHASES}")
    parser.add_argument("--keep-going", action="store_true",
                        help="run every phase before failing")
    parser.add_argument("--rehearse", action="store_true",
                        help="small sizes on any device; prints no result")
    args = parser.parse_args(argv)

    import jax

    dev = phase_a_device(args.rehearse)
    from albatross_tpu.utils.compile_cache import enable_compilation_cache

    print(f"[a] compilation cache: {enable_compilation_cache()}", flush=True)
    sizes = REHEARSE if args.rehearse else FULL

    state: dict = {}
    runs = []
    if args.multi:
        runs.append(("multi", lambda: phase_multi(sizes)))
    else:
        runs.append(("a", lambda: phase_a_precision(sizes["probe"])))
        table = {
            "b": lambda: phase_b_headline(sizes, state),
            "c": lambda: phase_c_value_and_grad(sizes, state),
            "d": lambda: phase_d_serving(sizes),
            "e": lambda: phase_e_highd(sizes),
            "f": lambda: phase_f_accuracy(sizes),
            "g": lambda: phase_g_big(sizes),
            "h": lambda: phase_h_sampler(sizes),
            "i": lambda: phase_i_blocked_vs_builtin(sizes, state),
        }
        runs += [(p, table[p]) for p in PHASES if p in args.phases]

    failed = []
    for name, run in runs:
        t0 = time.perf_counter()
        try:
            run()
        except Exception as exc:
            if not args.keep_going:
                raise
            failed.append(name)
            print(f"[{name}] ERROR {type(exc).__name__}: {exc}", flush=True)
        print(f"[{name}] wall_s={time.perf_counter() - t0:.1f}", flush=True)
    if failed:
        print(f"chip_smoke: phases failed: {failed}", file=sys.stderr)
        return 1
    if args.rehearse and dev.platform != "gpu":
        print("chip_smoke: rehearsal passed (no result for a non-GPU device)")
        return 0
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
