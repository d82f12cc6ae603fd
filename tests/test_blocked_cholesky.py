"""Blocked-Cholesky variants and the fused factorize+whiten path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.scipy.linalg import solve_triangular

from albatross_tpu.ops.blocked_cholesky import (
    blocked_cholesky,
    blocked_cholesky_cols,
)
from albatross_tpu.ops.linalg import CholeskyFactor


def _spd(rng, n):
    A = rng.standard_normal((n, n))
    return jnp.asarray(A @ A.T + n * np.eye(n))


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.mark.parametrize("n,b", [(96, 32), (100, 32), (256, 64)])
def test_blocked_matches_builtin(rng, n, b):
    K = _spd(rng, n)
    L_ref = jnp.linalg.cholesky(K)
    np.testing.assert_allclose(blocked_cholesky(K, b), L_ref, atol=1e-8)
    np.testing.assert_allclose(
        blocked_cholesky(K, b, use_inverse=False), L_ref, atol=1e-8
    )
    if n % b == 0:
        np.testing.assert_allclose(
            blocked_cholesky_cols(K, b), L_ref, atol=1e-8
        )


@pytest.mark.parametrize("n,b", [(96, 32), (100, 32), (32, 64)])
def test_fused_whiten_matches_triangular_solve(rng, n, b):
    K = _spd(rng, n)
    y = jnp.asarray(rng.standard_normal(n))
    L, z = blocked_cholesky(K, b, rhs=y)
    z_ref = solve_triangular(jnp.linalg.cholesky(K), y[:, None], lower=True)
    np.testing.assert_allclose(z, z_ref[:, 0], atol=1e-8)
    Lc, zc = blocked_cholesky_cols(K, b, rhs=y)
    np.testing.assert_allclose(zc, z_ref[:, 0], atol=1e-8)
    np.testing.assert_allclose(Lc, jnp.linalg.cholesky(K), atol=1e-8)


def test_factorize_whiten_small_and_large_agree(rng):
    # n > 2048 exercises the blocked fused path inside factorize_whiten
    n = 2176
    x = np.sort(rng.uniform(0, 10, n))
    d = x[:, None] - x[None, :]
    K = jnp.asarray(np.exp(-0.5 * d**2) + 0.5 * np.eye(n))
    y = jnp.asarray(rng.standard_normal(n))
    chol, white = CholeskyFactor.factorize_whiten(K, y)
    ref = chol.sqrt_solve(y)
    np.testing.assert_allclose(white, ref, atol=1e-7)
    # quadratic form matches a dense solve
    np.testing.assert_allclose(
        jnp.sum(white * white), y @ chol.solve(y), rtol=1e-9
    )


def test_gp_log_likelihood_fused_matches_safe(rng):
    import albatross_tpu as ab

    x = jnp.asarray(np.sort(rng.uniform(0, 10, 64)))
    y = jnp.sin(x) + 0.1 * jnp.asarray(rng.standard_normal(64))
    kernel = ab.SquaredExponential(1.0, 1.0) + ab.IndependentNoise(0.1)
    data = ab.RegressionDataset.create(x, y)
    fused = ab.gp_from_covariance(kernel, jitter=1e-8)
    safe = ab.gp_from_covariance(
        kernel, jitter=1e-8, safe_factorization=True
    )
    np.testing.assert_allclose(
        fused.log_likelihood(data), safe.log_likelihood(data), rtol=1e-10
    )


def test_blocked_tri_inverse(rng):
    from albatross_tpu.ops.blocked_cholesky import blocked_tri_inverse

    for n, sub in [(128, 32), (96, 32), (100, 32), (64, 128)]:
        K = _spd(rng, n)
        L = jnp.linalg.cholesky(K)
        W = blocked_tri_inverse(L, sub)
        np.testing.assert_allclose(W @ L, np.eye(n), atol=1e-8)
        assert np.allclose(np.triu(np.asarray(W), 1), 0.0)


def test_two_level_cols_matches_builtin(rng):
    n, b, sub = 256, 64, 32
    K = _spd(rng, n)
    y = jnp.asarray(rng.standard_normal(n))
    L_ref = jnp.linalg.cholesky(K)
    L, z = blocked_cholesky_cols(K, b, rhs=y, panel_sub=sub)
    np.testing.assert_allclose(L, L_ref, atol=1e-8)
    z_ref = solve_triangular(L_ref, y[:, None], lower=True)[:, 0]
    np.testing.assert_allclose(z, z_ref, atol=1e-8)


def test_no_assemble_nlml_path(rng):
    """assemble=False returns (diag(L), whitened) identical to the
    assembled factor — the NLML hot loop skips the O(N²) factor write."""
    from albatross_tpu.ops.blocked_cholesky import blocked_cholesky_cols

    n = 3072  # > one block: exercises the column-panel diag gather
    A = rng.standard_normal((n, n))
    K = jnp.asarray(A @ A.T + n * np.eye(n))
    y = jnp.asarray(rng.standard_normal(n))
    L, z = blocked_cholesky_cols(K, rhs=y)
    diag, z2 = blocked_cholesky_cols(K, rhs=y, assemble=False)
    np.testing.assert_array_equal(np.asarray(diag), np.diagonal(np.asarray(L)))
    np.testing.assert_array_equal(np.asarray(z), np.asarray(z2))
    with pytest.raises(ValueError, match="requires rhs"):
        blocked_cholesky_cols(K, assemble=False)


def test_fused_panel_factorizer_matches_builtin(rng):
    """panel_factorizer="fused" swaps the panel chol+inverse for the
    sub-blocked recursion; the factor and the NLML must match the builtin
    path (f64 CPU: to reduction-order tolerance).  The choice is a STATIC
    jit argument (round-4 review: a config flip alone cannot bust an
    already-cached inner trace), so the test exercises both the explicit
    argument and the config-routed path through nlml_terms (which reads
    the config eagerly per outer trace)."""
    from albatross_tpu import config
    from albatross_tpu.ops.blocked_cholesky import (
        blocked_cholesky_cols,
        fused_panel_chol_inverse,
    )
    from albatross_tpu.ops.linalg import CholeskyFactor

    n, b = 1024, 512
    Araw = rng.standard_normal((n, n))
    K = jnp.asarray(Araw @ Araw.T + n * np.eye(n))
    y = jnp.asarray(rng.standard_normal(n))

    # unit: fused panel (L, W) against the direct computation
    Akk = np.asarray(K)[:b, :b]
    L_ref = np.linalg.cholesky(Akk)
    Lf, Wf = fused_panel_chol_inverse(jnp.asarray(Akk), 128)
    np.testing.assert_allclose(np.asarray(Lf), L_ref, rtol=1e-10, atol=1e-8)
    np.testing.assert_allclose(
        np.asarray(Wf) @ L_ref, np.eye(b), atol=1e-9
    )

    # pipeline: full factorization + whiten equivalence via the explicit
    # static argument
    L0, z0 = blocked_cholesky_cols(K, block_size=b, rhs=y)
    L1, z1 = blocked_cholesky_cols(
        K, block_size=b, rhs=y, panel_factorizer="fused"
    )
    np.testing.assert_allclose(np.asarray(L1), np.asarray(L0), atol=1e-8)
    np.testing.assert_allclose(np.asarray(z1), np.asarray(z0), atol=1e-8)

    # config routing: nlml_terms reads PANEL_FACTORIZER eagerly, so a
    # config flip takes effect without any cache clearing
    n2 = 3072  # > the 2048 blocked-path threshold
    A2 = rng.standard_normal((n2, n2))
    K2 = jnp.asarray(A2 @ A2.T + n2 * np.eye(n2))
    y2 = jnp.asarray(rng.standard_normal(n2))
    ld0, w0 = CholeskyFactor.nlml_terms(K2, y2, assume_symmetric=True)
    prev = config.PANEL_FACTORIZER
    try:
        config.PANEL_FACTORIZER = "fused"
        ld1, w1 = CholeskyFactor.nlml_terms(K2, y2, assume_symmetric=True)
    finally:
        config.PANEL_FACTORIZER = prev
    assert float(ld1) == pytest.approx(float(ld0), rel=1e-10)
    np.testing.assert_allclose(np.asarray(w1), np.asarray(w0), atol=1e-7)


def test_left_looking_matches_right_looking(rng):
    """config.CHOLESKY_ALGORITHM="left" (one large GEMM per panel, gram
    columns fed lazily) must reproduce the right-looking NLML terms and
    gradients (f64: to reduction-order tolerance).  "right" stays the
    default; the algorithm remains available and correct."""
    from albatross_tpu import config
    from albatross_tpu.ops.blocked_cholesky import blocked_cholesky_left
    from albatross_tpu.ops.linalg import CholeskyFactor

    n, b = 1536, 512
    Araw = rng.standard_normal((n, n))
    K = jnp.asarray(Araw @ Araw.T + n * np.eye(n))
    y = jnp.asarray(rng.standard_normal(n))

    # direct: left-looking factor + whiten vs numpy
    def col_fn(j0, bb):
        return jax.lax.slice(K, (j0, j0), (n, j0 + bb))

    L, z = blocked_cholesky_left(col_fn, n, rhs=y, block_size=b,
                                 dtype=K.dtype)
    L_ref = np.linalg.cholesky(np.asarray(K))
    np.testing.assert_allclose(np.asarray(L), L_ref, atol=1e-7)
    z_ref = np.linalg.solve(L_ref, np.asarray(y))
    np.testing.assert_allclose(np.asarray(z), z_ref, atol=1e-7)
    # no-assemble diag path
    diag, z2 = blocked_cholesky_left(col_fn, n, rhs=y, block_size=b,
                                     assemble=False, dtype=K.dtype)
    np.testing.assert_allclose(np.asarray(diag), np.diag(L_ref), atol=1e-8)
    np.testing.assert_allclose(np.asarray(z2), z_ref, atol=1e-7)

    # nlml_terms config routing (K-slice fallback builder)
    ld_r, w_r = CholeskyFactor.nlml_terms(K, y, assume_symmetric=True)
    prev = config.CHOLESKY_ALGORITHM
    try:
        config.CHOLESKY_ALGORITHM = "left"
        ld_l, w_l = CholeskyFactor.nlml_terms(K, y, assume_symmetric=True)
    finally:
        config.CHOLESKY_ALGORITHM = prev
    assert float(ld_l) == pytest.approx(float(ld_r), rel=1e-12)
    np.testing.assert_allclose(np.asarray(w_l), np.asarray(w_r), atol=1e-8)


def test_left_looking_fused_gram_gp_equivalence(rng):
    """The GP's pattern-matched column builder (gram produced per panel,
    never materialized) must reproduce the materialized-covariance NLML
    and its gradients."""
    import jax as _jax

    from albatross_tpu import config
    import albatross_tpu as ab

    n = 3072
    x = jnp.asarray(np.sort(rng.uniform(0, 100, n)))
    y = jnp.sin(0.3 * x) + 0.1 * jnp.asarray(rng.standard_normal(n))
    data = ab.RegressionDataset.create(x, y)
    m = ab.gp_from_covariance(
        ab.SquaredExponential(5.0, 1.0)
        + ab.measurement_only(ab.IndependentNoise(0.1, assume_unique=True)),
        jitter=1e-6,
    )
    # the pattern must match (radial + diag noise, 1-D features)
    from albatross_tpu.kernels import as_measurement

    assert m._training_cov_col_fn(as_measurement(x)) is not None
    ll_r = float(m.log_likelihood(data))
    g_r = _jax.tree_util.tree_leaves(
        _jax.grad(lambda mm: -mm.log_likelihood(data))(m)
    )
    prev = config.CHOLESKY_ALGORITHM
    try:
        config.CHOLESKY_ALGORITHM = "left"
        ll_l = float(m.log_likelihood(data))
        g_l = _jax.tree_util.tree_leaves(
            _jax.grad(lambda mm: -mm.log_likelihood(data))(m)
        )
    finally:
        config.CHOLESKY_ALGORITHM = prev
    assert ll_l == pytest.approx(ll_r, rel=1e-10)
    for a, b2 in zip(g_l, g_r):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b2), rtol=1e-8, atol=1e-10
        )


def test_left_looking_guards_and_fallback(rng):
    """Round-4 review: assemble=False without rhs must raise the explicit
    ValueError (not crash in unpacking), and the non-divisible-n fallback
    must keep working through the cols layout with knobs honored."""
    from albatross_tpu.ops.blocked_cholesky import blocked_cholesky_left

    n = 1400  # not divisible by the default block
    A = rng.standard_normal((n, n))
    K = jnp.asarray(A @ A.T + n * np.eye(n))
    y = jnp.asarray(rng.standard_normal(n))

    def col_fn(j0, b):
        return jax.lax.slice(K, (j0, j0), (n, j0 + b))

    with pytest.raises(ValueError, match="requires rhs"):
        blocked_cholesky_left(col_fn, n, assemble=False, dtype=K.dtype)
    diag, z = blocked_cholesky_left(
        col_fn, n, rhs=y, assemble=False, dtype=K.dtype
    )
    L_ref = np.linalg.cholesky(np.asarray(K))
    np.testing.assert_allclose(np.asarray(diag), np.diag(L_ref), atol=1e-8)
    np.testing.assert_allclose(
        np.asarray(z), np.linalg.solve(L_ref, np.asarray(y)), atol=1e-7
    )
    # double_word + col_fn is rejected with a clear message
    from albatross_tpu import config
    from albatross_tpu.ops.linalg import CholeskyFactor

    prev = config.CHOLESKY_PRECISION
    try:
        config.CHOLESKY_PRECISION = "double_word"
        with pytest.raises(ValueError, match="double_word"):
            CholeskyFactor.nlml_terms(None, y, col_fn=col_fn)
    finally:
        config.CHOLESKY_PRECISION = prev


def test_right_fused_gram_gp_equivalence(rng):
    """config.CHOLESKY_ALGORITHM="right_fused" (right-looking loop, gram
    columns produced lazily at their first trailing update) must reproduce
    the materialized-covariance NLML and gradients — the op sequence is
    identical, only the gram's materialization is elided."""
    import jax as _jax

    import albatross_tpu as ab
    from albatross_tpu import config

    n = 3072
    x = jnp.asarray(np.sort(rng.uniform(0, 100, n)))
    y = jnp.sin(0.3 * x) + 0.1 * jnp.asarray(rng.standard_normal(n))
    data = ab.RegressionDataset.create(x, y)
    m = ab.gp_from_covariance(
        ab.SquaredExponential(5.0, 1.0)
        + ab.measurement_only(ab.IndependentNoise(0.1, assume_unique=True)),
        jitter=1e-6,
    )
    ll_r = float(m.log_likelihood(data))
    g_r = _jax.tree_util.tree_leaves(
        _jax.grad(lambda mm: -mm.log_likelihood(data))(m)
    )
    prev = config.CHOLESKY_ALGORITHM
    try:
        config.CHOLESKY_ALGORITHM = "right_fused"
        ll_f = float(m.log_likelihood(data))
        g_f = _jax.tree_util.tree_leaves(
            _jax.grad(lambda mm: -mm.log_likelihood(data))(m)
        )
    finally:
        config.CHOLESKY_ALGORITHM = prev
    assert ll_f == pytest.approx(ll_r, rel=1e-10)
    for a, b2 in zip(g_f, g_r):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b2), rtol=1e-8, atol=1e-10
        )


def test_right_fused_is_opt_in(rng, monkeypatch):
    """The default "right" algorithm keeps the materialized covariance at
    any N (the lazy-gram loop holds as many bytes on a GPU, PERF.md); the
    lazy-gram "right_fused" loop engages only when asked for, and then
    matches the materialized NLML."""
    import albatross_tpu as ab
    from albatross_tpu import config
    from albatross_tpu.models import gp as gp_mod

    n = 3072
    x = jnp.asarray(np.sort(rng.uniform(0, 100, n)))
    y = jnp.sin(0.3 * x) + 0.1 * jnp.asarray(rng.standard_normal(n))
    data = ab.RegressionDataset.create(x, y)
    m = ab.gp_from_covariance(
        ab.SquaredExponential(5.0, 1.0)
        + ab.measurement_only(ab.IndependentNoise(0.1, assume_unique=True)),
        jitter=1e-6,
    )
    calls = []
    real = gp_mod._fused_gram_nlml

    def spy(*args, **kwargs):
        calls.append(kwargs.get("algorithm"))
        return real(*args, **kwargs)

    monkeypatch.setattr(gp_mod, "_fused_gram_nlml", spy)
    ll_ref = float(m.log_likelihood(data))
    assert calls == []
    monkeypatch.setattr(config, "CHOLESKY_ALGORITHM", "right_fused")
    ll_up = float(m.log_likelihood(data))
    assert calls == ["right_fused"]
    assert ll_up == pytest.approx(ll_ref, rel=1e-10)


def test_trailing_bf16_mode(rng):
    """trailing_precision="bf16" stores factored panels at bf16 for the
    trailing re-reads: f32 results stay close (the mode exists to halve
    the panels' memory traffic); f64 inputs ignore the knob bitwise."""
    from albatross_tpu.ops.blocked_cholesky import blocked_cholesky_cols

    n, b = 2048, 512
    A = rng.standard_normal((n, n))
    K64 = jnp.asarray(A @ A.T + n * np.eye(n))
    y64 = jnp.asarray(rng.standard_normal(n))

    # f64: knob is a bitwise no-op
    d0, z0 = blocked_cholesky_cols(K64, block_size=b, rhs=y64, assemble=False)
    d1, z1 = blocked_cholesky_cols(
        K64, block_size=b, rhs=y64, assemble=False,
        trailing_precision="bf16",
    )
    np.testing.assert_array_equal(np.asarray(d0), np.asarray(d1))
    np.testing.assert_array_equal(np.asarray(z0), np.asarray(z1))

    # f32: bf16-stored trailing inputs, results close to the f32 factor
    K32 = K64.astype(jnp.float32)
    y32 = y64.astype(jnp.float32)
    d2, z2 = blocked_cholesky_cols(
        K32, block_size=b, rhs=y32, assemble=False,
        trailing_precision="bf16",
    )
    assert np.all(np.isfinite(np.asarray(d2)))
    np.testing.assert_allclose(
        np.asarray(d2), np.asarray(d0, np.float32), rtol=2e-2
    )
    # the NLML scalars (what the mode serves) stay tight
    ld_ref = 2.0 * np.sum(np.log(np.asarray(d0)))
    ld_b16 = 2.0 * np.sum(np.log(np.asarray(d2, np.float64)))
    assert ld_b16 == pytest.approx(ld_ref, rel=1e-3)
    quad_ref = float(jnp.sum(z0 * z0))
    quad_b16 = float(jnp.sum(z2.astype(jnp.float64) ** 2))
    assert quad_b16 == pytest.approx(quad_ref, rel=5e-2)

    # diag refinement composes with bf16 trailing (f32 diag rows)
    d3, z3 = blocked_cholesky_cols(
        K32, block_size=b, rhs=y32, assemble=False,
        trailing_precision="bf16", diag_precision="highest",
    )
    assert np.all(np.isfinite(np.asarray(d3)))

    # config routing: CHOLESKY_TRAILING_BF16 reaches the NLML path
    from albatross_tpu import config
    from albatross_tpu.ops.linalg import CholeskyFactor

    ld_r, w_r = CholeskyFactor.nlml_terms(K32, y32, assume_symmetric=True)
    prev = config.CHOLESKY_TRAILING_BF16
    try:
        config.CHOLESKY_TRAILING_BF16 = True
        ld_b, w_b = CholeskyFactor.nlml_terms(K32, y32, assume_symmetric=True)
    finally:
        config.CHOLESKY_TRAILING_BF16 = prev
    assert float(ld_b) == pytest.approx(float(ld_r), rel=1e-3)


def test_cols_nondivisible_n_honors_precision_knobs(rng):
    """Non-divisible n now pads to the panel boundary instead of silently
    dropping the precision/factorizer knobs (round-4 advisor finding):
    the padded run must equal the numpy factorization, in every output
    layout."""
    from albatross_tpu.ops.blocked_cholesky import blocked_cholesky_cols

    n, b = 2900, 1024  # 2900 % 1024 != 0
    A = rng.standard_normal((n, n))
    K = jnp.asarray(A @ A.T + n * np.eye(n))
    y = jnp.asarray(rng.standard_normal(n))
    L_ref = np.linalg.cholesky(np.asarray(K))
    z_ref = np.linalg.solve(L_ref, np.asarray(y))

    L = blocked_cholesky_cols(
        K, block_size=b, panel_precision="highest",
        trailing_precision="highest",
    )
    assert L.shape == (n, n)
    np.testing.assert_allclose(np.asarray(L), L_ref, atol=1e-8)
    L2, z2 = blocked_cholesky_cols(
        K, block_size=b, rhs=y, panel_precision="highest",
        trailing_precision="highest",
    )
    np.testing.assert_allclose(np.asarray(z2), z_ref, atol=1e-7)
    diag, z3 = blocked_cholesky_cols(
        K, block_size=b, rhs=y, assemble=False,
        panel_precision="highest", trailing_precision="highest",
        panel_factorizer="fused",
    )
    np.testing.assert_allclose(np.asarray(diag), np.diag(L_ref), atol=1e-8)
    np.testing.assert_allclose(np.asarray(z3), z_ref, atol=1e-7)
