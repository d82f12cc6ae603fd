"""Double-word compensated arithmetic (ops/compensated.py): error-free
transformations vs f64 ground truth, the refined-quadratic NLML ladder on an
emulated-f32 pipeline, and the config wiring.

Backend caveat (measured, round 3): XLA:CPU's fusion codegen applies
value-changing float optimizations (LLVM fast-math inside fused kernels —
--xla_cpu_enable_fast_math=false does not disable it; only
--xla_disable_hlo_passes=fusion does), which degrades EFT chains under jit
from ~1e-15 to ~1e-6 relative.  The primitives therefore get their exactness
asserted EAGERLY here, plus a jit canary that records the backend behavior;
the end-to-end NLML accuracy claim is asserted for both eager and jit since
the dominant gain (the refined solve) survives fusion.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from albatross_tpu.ops.compensated import (
    compensated_nll,
    dot2,
    dw_log_determinant,
    dw_matvec,
    dw_sum,
    refined_quadratic,
    two_prod,
    two_sum,
)
from albatross_tpu.ops.linalg import CholeskyFactor


def test_eft_primitives_exact(rng):
    a = jnp.asarray(rng.standard_normal(512) * 1e3, jnp.float32)
    b = jnp.asarray(rng.standard_normal(512), jnp.float32)
    s, e = two_sum(a, b)
    exact = np.asarray(a, np.float64) + np.asarray(b, np.float64)
    np.testing.assert_array_equal(
        np.asarray(s, np.float64) + np.asarray(e, np.float64), exact
    )
    p, e = two_prod(a, b)
    exact = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    np.testing.assert_array_equal(
        np.asarray(p, np.float64) + np.asarray(e, np.float64), exact
    )


def test_dot2_beats_plain_dot(rng):
    n = 100001  # odd: exercises the pad-to-power-of-two path
    x = jnp.asarray(rng.standard_normal(n) * 1e3, jnp.float32)
    y = jnp.asarray(rng.standard_normal(n), jnp.float32)
    exact = np.asarray(x, np.float64) @ np.asarray(y, np.float64)
    h, l = dot2(x, y)
    comp_err = abs((float(h) + float(l)) - exact) / abs(exact)
    plain_err = abs(float(jnp.dot(x, y)) - exact) / abs(exact)
    assert comp_err < 1e-12
    assert comp_err < plain_err / 100.0


def test_dw_sum_axis_and_matvec(rng):
    M = jnp.asarray(rng.standard_normal((8, 1000)) * 1e3, jnp.float32)
    v = jnp.asarray(rng.standard_normal(1000), jnp.float32)
    p, e = two_prod(M, v[None, :])
    hh, hl = dw_sum(p, e, axis=1)
    exact = np.asarray(M, np.float64) @ np.asarray(v, np.float64)
    got = np.asarray(hh, np.float64) + np.asarray(hl, np.float64)
    np.testing.assert_allclose(got, exact, rtol=1e-12)
    # chunked driver path (chunk divides rows).  lax.map jits its body, so
    # on XLA:CPU the fusion fast-math caveat (module docstring) caps the
    # achievable accuracy — assert a strict improvement over the plain f32
    # mat-vec instead of exactness (the single-block eager path above is
    # the exactness witness).
    M2 = jnp.asarray(rng.standard_normal((2048, 256)), jnp.float32)
    v2 = jnp.asarray(rng.standard_normal(256) * 100, jnp.float32)
    K32dev = M2.T @ M2
    hh, hl = dw_matvec(K32dev, v2, chunk=128)
    exact = np.asarray(K32dev, np.float64) @ np.asarray(v2, np.float64)
    got = np.asarray(hh, np.float64) + np.asarray(hl, np.float64)
    plain = np.asarray(jnp.matmul(K32dev, v2), np.float64)
    err = np.linalg.norm(got - exact) / np.linalg.norm(exact)
    plain_err = np.linalg.norm(plain - exact) / np.linalg.norm(exact)
    # this mat-vec has no cancellation, so plain f32 is already ~1e-7;
    # the chunked dw path must never be worse (on clean backends it is
    # ~1e-15 — the canary test tracks backend cleanliness)
    assert err <= plain_err, (err, plain_err)


def _f32_gp_problem(rng, n):
    x = np.sort(rng.uniform(0, 100, n))
    d = np.abs(x[:, None] - x[None, :])
    K64 = np.exp(-0.5 * (d / 5.0) ** 2) + np.diag(np.full(n, 1e-3))
    y64 = np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)
    K32 = jnp.asarray(K64, jnp.float32)
    y32 = jnp.asarray(y64, jnp.float32)
    K64q = np.asarray(K32, np.float64)
    y64q = np.asarray(y32, np.float64)
    L64 = np.linalg.cholesky(K64q)
    w64 = np.linalg.solve(L64, y64q)
    nll64 = 0.5 * (
        2.0 * np.sum(np.log(np.diag(L64)))
        + w64 @ w64
        + n * math.log(2.0 * math.pi)
    )
    return K32, y32, K64q, y64q, nll64


def test_compensated_nll_beats_plain_f32(rng):
    """The emulated-f32 ladder from CLAUDE.md #3 at test scale: compensated
    (dw reductions + 2 refinement steps) must land ≥10× closer to the f64
    oracle than the plain f32 pipeline."""
    n = 1024
    K32, y32, K64q, y64q, nll64 = _f32_gp_problem(rng, n)
    chol = CholeskyFactor.factorize(K32, assume_symmetric=True)
    white = chol.sqrt_solve(y32)
    plain = float(
        0.5
        * (
            chol.log_determinant()
            + jnp.sum(white * white)
            + n * math.log(2.0 * math.pi)
        )
    )
    comp_eager = float(compensated_nll(chol, K32, y32))
    comp_jit = float(jax.jit(compensated_nll)(chol, K32, y32))
    plain_err = abs(plain - nll64) / abs(nll64)
    for name, got in [("eager", comp_eager), ("jit", comp_jit)]:
        err = abs(got - nll64) / abs(nll64)
        assert err < 2e-6, (name, err)
        assert err < plain_err / 10.0, (name, err, plain_err)


def test_refined_quadratic_converges(rng):
    n = 1024
    K32, y32, K64q, y64q, _ = _f32_gp_problem(rng, n)
    chol = CholeskyFactor.factorize(K32, assume_symmetric=True)
    q_exact = y64q @ np.linalg.solve(K64q, y64q)
    errs = []
    for steps in (0, 2):
        qh, ql = refined_quadratic(chol, K32, y32, refine_steps=steps)
        errs.append(abs((float(qh) + float(ql)) - q_exact) / q_exact)
    assert errs[1] < 1e-6
    assert errs[1] < errs[0] / 5.0


def test_dw_log_determinant(rng):
    n = 512
    K32, _, K64q, _, _ = _f32_gp_problem(rng, n)
    chol = CholeskyFactor.factorize(K32, assume_symmetric=True)
    h, l = dw_log_determinant(chol.L)
    # vs exact logs of the SAME f32 factor (isolates the reduction)
    exact = 2.0 * np.sum(np.log(np.diagonal(np.asarray(chol.L, np.float64))))
    assert abs((float(h) + float(l)) - exact) / abs(exact) < 1e-9


def test_nlml_compensated_config_wiring(rng):
    """config.NLML_COMPENSATED routes GaussianProcess.log_likelihood through
    the compensated path; in x64 it agrees with the plain path tightly."""
    import albatross_tpu as ab
    from albatross_tpu import config

    x = jnp.asarray(np.sort(rng.uniform(0, 10, 64)))
    y = jnp.sin(x)
    data = ab.RegressionDataset.create(x, y)
    kernel = ab.SquaredExponential(1.5, 1.0) + ab.IndependentNoise(0.1)
    model = ab.gp_from_covariance(kernel, jitter=1e-8)
    plain = float(model.log_likelihood(data))
    try:
        config.NLML_COMPENSATED = True
        comp = float(model.log_likelihood(data))
        comp_jit = float(
            jax.jit(lambda m: m.log_likelihood(data))(model)
        )
    finally:
        config.NLML_COMPENSATED = False
    assert comp == pytest.approx(plain, rel=1e-12)
    assert comp_jit == pytest.approx(plain, rel=1e-12)


def test_jit_eft_canary():
    """Record whether this backend's fused codegen preserves EFT chains under
    jit (XLA:CPU: known no — fusion fast-math).  The test asserts only that
    the jit result is never WORSE than the plain dot — exactness under jit
    is asserted when the canary shows the backend is clean, so a run on a
    clean backend would catch a regression."""
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal(4096) * 1e3, jnp.float32)
    y = jnp.asarray(rng.standard_normal(4096), jnp.float32)
    exact = np.asarray(x, np.float64) @ np.asarray(y, np.float64)
    h, l = jax.jit(dot2)(x, y)
    jit_err = abs((float(h) + float(l)) - exact) / abs(exact)
    plain_err = abs(float(jnp.dot(x, y)) - exact) / abs(exact)
    assert jit_err <= plain_err
    he, le = dot2(x, y)
    eager_err = abs((float(he) + float(le)) - exact) / abs(exact)
    clean = jit_err < 10 * max(eager_err, 1e-15)
    if jax.default_backend() not in ("cpu",):
        assert clean, (
            f"EFTs corrupted under jit on {jax.default_backend()}: "
            f"{jit_err:.3e} vs eager {eager_err:.3e}"
        )


def _sqexp_nugget_f32(n, rng, ls=5.0, nugget=1e-2):
    x = np.sort(rng.uniform(0.0, 100.0, n))
    K64 = np.exp(-0.5 * ((x[:, None] - x[None, :]) / ls) ** 2)
    K64 += nugget * np.eye(n)
    return jnp.asarray(K64.astype(np.float32))


def test_blocked_cholesky_dw_factor_and_logdet(rng):
    """blocked_cholesky_dw (double-word-carry + exact-product GEMMs): the
    factor reproduces K and the log-det error vs the f64 oracle is at the
    single-rounding level (measured CPU N=8192/b=2048: plain blocked
    1.2e-8; the mode must stay in that class, not regress toward the
    ~1e-6-class accumulated error the carry exists to prevent)."""
    from albatross_tpu.ops.compensated import blocked_cholesky_dw

    K32 = _sqexp_nugget_f32(1024, rng)
    K64 = np.asarray(K32, np.float64)
    oracle = 2.0 * np.sum(np.log(np.diag(np.linalg.cholesky(K64))))

    L, z = blocked_cholesky_dw(
        K32, block_size=256, rhs=jnp.ones(1024, jnp.float32)
    )
    L64 = np.asarray(L, np.float64)
    resid = np.linalg.norm(K64 - L64 @ L64.T) / np.linalg.norm(K64)
    assert resid < 1e-6
    ld = 2.0 * np.sum(np.log(np.diag(L64)))
    assert abs(ld - oracle) / abs(oracle) < 1e-7
    # fused whiten agrees with an f64 solve of the same factor
    z64 = np.linalg.solve(np.tril(L64), np.ones(1024))
    np.testing.assert_allclose(
        np.asarray(z, np.float64), z64, rtol=1e-3, atol=1e-4
    )


def test_cholesky_precision_double_word_wiring(rng):
    """config.CHOLESKY_PRECISION='double_word' routes factorize/nlml_terms
    through the dw factorization and stays consistent with the plain
    path."""
    from albatross_tpu import config

    K32 = _sqexp_nugget_f32(4096, rng)
    y = jnp.asarray(rng.standard_normal(4096), jnp.float32)
    ld_plain, w_plain = CholeskyFactor.nlml_terms(
        K32, y, assume_symmetric=True
    )
    try:
        config.CHOLESKY_PRECISION = "double_word"
        ld_dw, w_dw = CholeskyFactor.nlml_terms(K32, y, assume_symmetric=True)
        chol = CholeskyFactor.factorize(K32, assume_symmetric=True)
    finally:
        config.CHOLESKY_PRECISION = None
    K64 = np.asarray(K32, np.float64)
    oracle = 2.0 * np.sum(np.log(np.diag(np.linalg.cholesky(K64))))
    assert abs(float(ld_dw) - oracle) / abs(oracle) < 1e-7
    assert float(ld_plain) == pytest.approx(float(ld_dw), rel=1e-5)
    np.testing.assert_allclose(
        np.asarray(w_dw), np.asarray(w_plain), rtol=2e-3, atol=2e-3
    )
    assert chol.L.shape == (4096, 4096)


def test_double_word_mode_is_differentiable(rng):
    """The dw factorization must stay autodiff-compatible so the accuracy
    mode is usable inside the tuning loop."""
    from albatross_tpu import config
    import albatross_tpu as ab

    x = np.sort(rng.uniform(0.0, 100.0, 2304))
    y = np.sin(0.3 * x)
    data = ab.RegressionDataset.create(
        jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)
    )
    model = ab.gp_from_covariance(
        ab.SquaredExponential(5.0, 1.0)
        + ab.measurement_only(ab.IndependentNoise(0.1, assume_unique=True))
    )
    try:
        config.CHOLESKY_PRECISION = "double_word"
        config.NLML_COMPENSATED = True
        grads = jax.grad(lambda m: -m.log_likelihood(data))(model)
    finally:
        config.CHOLESKY_PRECISION = None
        config.NLML_COMPENSATED = False
    leaves = jax.tree_util.tree_leaves(grads)
    assert leaves and all(np.isfinite(np.asarray(g)).all() for g in leaves)


def test_accurate_log_sub_ulp_and_unbiased(rng):
    """accurate_log stands in for a builtin f32 log whose per-element
    error may be biased, and a biased error survives the N-term log-det
    sum.  The replacement must be sub-ulp per element and bias-free in
    the aggregate."""
    from albatross_tpu.ops.compensated import accurate_log

    vals = rng.uniform(0.05, 2.0, 50000).astype(np.float32)
    h, l = accurate_log(jnp.asarray(vals))
    got = np.asarray(h, np.float64) + np.asarray(l, np.float64)
    exact = np.log(vals.astype(np.float64))
    ulp = np.finfo(np.float32).eps * np.maximum(np.abs(exact), 1.0)
    assert np.max(np.abs(got - exact) / ulp) < 1.0
    assert abs(got.sum() - exact.sum()) / abs(exact.sum()) < 1e-9
    # wide range incl. large exponents (two_prod e*ln2 exactness)
    wide = np.exp(rng.uniform(-30, 30, 20000)).astype(np.float32)
    h, l = accurate_log(jnp.asarray(wide))
    got = np.asarray(h, np.float64) + np.asarray(l, np.float64)
    exact = np.log(wide.astype(np.float64))
    ulp_w = np.finfo(np.float32).eps * np.maximum(np.abs(exact), 1.0)
    assert np.max(np.abs(got - exact) / ulp_w) < 1.0
    # custom_jvp: d log x = 1/x
    g = jax.grad(
        lambda v: jnp.sum(accurate_log(v)[0] + accurate_log(v)[1])
    )(jnp.asarray([0.5, 2.0], jnp.float32))
    np.testing.assert_allclose(np.asarray(g), [2.0, 0.5], rtol=1e-6)


def test_accurate_sum_of_logs_masked_and_grad(rng):
    """accurate_sum_of_logs serves every log-det site (single-chip,
    shard_map-local, batched block-diagonal): masked entries contribute
    exactly zero, the f32 result matches the f64 sum to the final f32
    rounding (the return is a single word, so ~eps(f32) relative is the
    floor — the double-word internals remove the O(√N·eps) accumulation
    on top), f64 inputs pass through, and gradients flow (zero on masked
    slots)."""
    from albatross_tpu.ops.compensated import accurate_sum_of_logs

    vals = rng.uniform(0.1, 3.0, (64, 32)).astype(np.float32)
    mask = rng.uniform(size=(64, 32)) > 0.3
    got = float(accurate_sum_of_logs(jnp.asarray(vals), where=jnp.asarray(mask)))
    exact = np.sum(np.log(vals.astype(np.float64))[mask])
    assert abs(got - exact) / abs(exact) < 1.2e-7  # one f32 ulp
    # garbage (non-positive) masked entries must not poison the sum
    vals_bad = vals.copy()
    vals_bad[~mask] = -7.0
    got_bad = float(
        accurate_sum_of_logs(jnp.asarray(vals_bad), where=jnp.asarray(mask))
    )
    assert got_bad == got
    # f64 passthrough
    v64 = rng.uniform(0.1, 3.0, 100)
    got64 = float(accurate_sum_of_logs(jnp.asarray(v64, jnp.float64)))
    assert got64 == pytest.approx(np.sum(np.log(v64)), rel=1e-14)
    # gradient: d/dv sum log v = 1/v on kept entries, 0 on masked
    v = jnp.asarray([0.5, 2.0, 4.0], jnp.float32)
    m = jnp.asarray([True, False, True])
    g = jax.grad(lambda v: accurate_sum_of_logs(v, where=m))(v)
    np.testing.assert_allclose(np.asarray(g), [2.0, 0.0, 0.25], rtol=1e-6)


def test_accurate_log_guarded_invalid_inputs_propagate():
    """Advisor round-3 medium: accurate_log's bitwise reduction returns
    finite garbage for 0/negative/NaN inputs, and accurate_sum_of_logs
    feeds every log-det site — a failed factorization must still surface
    as -inf/NaN (the surface-as-NaN policy), not a finite wrong value."""
    from albatross_tpu.ops.compensated import (
        accurate_log_guarded,
        accurate_sum_of_logs,
    )

    x = jnp.asarray([2.0, 0.0, -0.5, np.nan, np.inf], jnp.float32)
    h, l = accurate_log_guarded(x)
    got = np.asarray(h) + np.asarray(l)
    assert got[0] == pytest.approx(math.log(2.0), rel=1e-7)
    assert got[1] == -np.inf
    assert np.isnan(got[2])
    assert np.isnan(got[3])
    assert got[4] == np.inf
    # the sum-of-logs contract: one bad entry poisons the total
    assert np.isnan(float(accurate_sum_of_logs(jnp.asarray([1.0, -0.5, 2.0], jnp.float32))))
    assert float(accurate_sum_of_logs(jnp.asarray([1.0, 0.0, 2.0], jnp.float32))) == -np.inf
    # ...and the entropy route the advisor exercised
    from albatross_tpu.evaluation.entropy import differential_entropy

    assert np.isnan(float(differential_entropy(jnp.asarray([1.0, -0.5, 2.0], jnp.float32))))
    # masked invalid entries still contribute exactly zero
    s = float(
        accurate_sum_of_logs(
            jnp.asarray([1.0, -0.5, 2.0], jnp.float32),
            where=jnp.asarray([True, False, True]),
        )
    )
    assert s == pytest.approx(math.log(2.0), rel=1e-6)


def test_accurate_sum_of_logs_f64_invalid_inputs_propagate():
    """Round-4 review finding: the f64 branch must keep the same domain
    semantics as the guarded f32 path — 0 → -inf, negative → NaN — instead
    of the dw reduction's two_sum(-inf, x) = NaN."""
    from albatross_tpu.ops.compensated import (
        accurate_sum_of_logs,
        dw_log_determinant,
    )

    f64 = jnp.float64
    assert float(accurate_sum_of_logs(jnp.asarray([1.0, 0.0, 2.0], f64))) == -np.inf
    assert np.isnan(float(accurate_sum_of_logs(jnp.asarray([1.0, -0.5], f64))))
    ok = float(accurate_sum_of_logs(jnp.asarray([0.5, 2.0, 4.0], f64)))
    assert ok == pytest.approx(math.log(4.0), rel=1e-14)
    # dw_log_determinant f64 path: a zero diagonal is a -inf log-det
    L = jnp.diag(jnp.asarray([1.0, 0.0, 2.0], f64))
    h, l = dw_log_determinant(L)
    assert float(h) + float(l) == -np.inf
