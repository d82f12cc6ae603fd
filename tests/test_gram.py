"""Radial gram accuracy: the exact per-pair distance form.

Euclidean grams at every feature dimension are built from per-pair
differences (kernels/distances.py squared_distances), which XLA fuses into
one reduction; its gradient is a closed-form custom VJP that stores no
(N, M, D) array.  These tests hold that path to the accuracy contract the
factorization relies on: no cancellation at large coordinates, bitwise
symmetry, an exact σ² diagonal, f64 preserved.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import albatross_tpu as ab
from albatross_tpu.kernels.distances import EuclideanDistance, squared_distances
from albatross_tpu.kernels.radial import (
    exponential_covariance,
    matern_32_covariance,
    matern_52_covariance,
    radial_profile,
    squared_exponential_covariance,
)

PROFILES = {
    "squared_exponential": squared_exponential_covariance,
    "exponential": exponential_covariance,
    "matern_32": matern_32_covariance,
    "matern_52": matern_52_covariance,
}
KERNELS = {
    "squared_exponential": ab.SquaredExponential,
    "exponential": ab.Exponential,
    "matern_32": ab.Matern32,
    "matern_52": ab.Matern52,
}


def _d2_64(X, Y):
    X64 = np.asarray(X, np.float64).reshape(len(X), -1)
    Y64 = np.asarray(Y, np.float64).reshape(len(Y), -1)
    return np.sum((X64[:, None, :] - Y64[None, :, :]) ** 2, axis=-1)


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_gram_matches_closed_form(profile, rng):
    X = jnp.asarray(rng.uniform(0, 100, 300), dtype=jnp.float32)
    Y = jnp.asarray(rng.uniform(0, 100, 140), dtype=jnp.float32)
    K = KERNELS[profile](5.0, 2.0)(X, Y)
    ref = np.asarray(PROFILES[profile](jnp.asarray(np.sqrt(_d2_64(X, Y))), 5.0, 2.0))
    np.testing.assert_allclose(np.asarray(K), ref, atol=2e-6)


def test_gram_multidim(rng):
    X = jnp.asarray(rng.uniform(0, 10, (260, 3)), dtype=jnp.float32)
    K = ab.Matern52(2.0, 1.5)(X)
    ref = np.asarray(
        matern_52_covariance(jnp.asarray(np.sqrt(_d2_64(X, X))), 2.0, 1.5)
    )
    np.testing.assert_allclose(np.asarray(K), ref, atol=2e-6)


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_gram_matches_closed_form_highd(profile, rng):
    """Every profile at D=12 against the f64 closed form, with clustered
    data so many pairs sit where the kernel is large."""
    n, m, d = 260, 180, 12
    X = jnp.asarray(rng.uniform(0, 6, (n, d)), dtype=jnp.float32)
    Y = jnp.asarray(rng.uniform(0, 6, (m, d)), dtype=jnp.float32)
    K = KERNELS[profile](3.0, 2.0)(X, Y)
    ref = np.asarray(PROFILES[profile](jnp.asarray(np.sqrt(_d2_64(X, Y))), 3.0, 2.0))
    np.testing.assert_allclose(np.asarray(K), ref, atol=5e-6)


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_radial_profile_matches_kernel(profile, rng):
    """radial_profile (the lazy-gram column builder's form, on d²) agrees
    with each kernel's own closed form."""
    d2 = jnp.asarray(rng.uniform(0, 50, (40, 30)))
    got = radial_profile(profile, d2, 2.5, 1.5)
    ref = PROFILES[profile](jnp.sqrt(d2), 2.5, 1.5)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-12)


def test_gram_no_cancellation_at_large_coordinates(rng):
    """Feature magnitude ~1e4 with unit-scale structure: the |x|²+|y|²−2x·y
    matmul form loses every distance bit to cancellation (error ~ eps·|x|²),
    the per-pair difference form stays at reference accuracy."""
    n, d = 300, 16
    base = 1e4 + rng.standard_normal((1, d))
    X = jnp.asarray(base + rng.standard_normal((n, d)), dtype=jnp.float32)
    ls, sigma = 2.0, 1.5
    K = ab.SquaredExponential(ls, sigma)(X)
    D2 = _d2_64(X, X)
    np.testing.assert_allclose(
        np.asarray(K), sigma**2 * np.exp(-D2 / ls**2), atol=5e-6
    )
    # the matmul form really is broken here (what the path must NOT do)
    Xf = np.asarray(X, np.float32)
    x2 = np.sum(Xf.astype(np.float64) ** 2, axis=-1)
    broken = x2[:, None] + x2[None, :] - 2.0 * (Xf @ Xf.T).astype(np.float64)
    assert np.max(np.abs(broken - D2)) > 1.0


def test_gram_symmetric_and_exact_diagonal(rng):
    """Bitwise symmetric (fit/NLML factorize with assume_symmetric=True)
    with k(x,x) = σ² exactly, at D=32 and coordinates ~100."""
    n, d = 280, 32
    X = jnp.asarray(rng.uniform(0, 100, (n, d)), dtype=jnp.float32)
    K = np.asarray(ab.SquaredExponential(10.0, 1.5)(X))
    assert np.array_equal(K, K.T)
    np.testing.assert_array_equal(np.diag(K), np.full(n, 1.5**2, np.float32))
    np.testing.assert_allclose(K, 1.5**2 * np.exp(-_d2_64(X, X) / 100.0), atol=5e-6)


def test_gram_skips_symmetrization_for_euclidean(rng):
    """The exact form is symmetric by construction, so __call__ need not
    average K with its transpose at any D."""
    X = jnp.asarray(rng.uniform(0, 1, (10, 20)))
    assert ab.SquaredExponential(1.0, 1.0)._symmetric_exact(X)
    assert ab.Matern32(1.0, 1.0)._symmetric_exact(X)


def test_gram_preserves_f64(rng):
    n, d = 280, 12
    X = jnp.asarray(rng.uniform(0, 10, (n, d)), dtype=jnp.float64)
    K = np.asarray(ab.SquaredExponential(2.5, 1.5)(X))
    assert K.dtype == np.float64
    np.testing.assert_allclose(
        K, 1.5**2 * np.exp(-_d2_64(X, X) / 2.5**2), rtol=1e-12, atol=1e-13
    )


@pytest.mark.parametrize("d", [1, 3, 16])
def test_squared_distances_vjp_matches_autodiff(d, rng):
    """The closed-form backward equals autodiff through the plain
    broadcast form, for both operands."""
    X = jnp.asarray(rng.uniform(-5, 5, (37, d)))
    Y = jnp.asarray(rng.uniform(-5, 5, (23, d)))
    W = jnp.asarray(rng.standard_normal((37, 23)))

    def plain(x, y):
        diff = x[:, None, :] - y[None, :, :]
        return jnp.sum(diff * diff, axis=-1)

    g = jax.grad(lambda x, y: jnp.sum(W * squared_distances(x, y)), (0, 1))(X, Y)
    r = jax.grad(lambda x, y: jnp.sum(W * plain(x, y)), (0, 1))(X, Y)
    for a, b in zip(g, r):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10)


def test_squared_distances_vjp_same_batch(rng):
    """K(X, X): the two operand cotangents add up to the full gradient."""
    X = jnp.asarray(rng.uniform(0, 100, (50, 8)))

    def plain(x):
        diff = x[:, None, :] - x[None, :, :]
        return jnp.sum(jnp.exp(-jnp.sum(diff * diff, -1) / 400.0))

    g = jax.grad(lambda x: jnp.sum(jnp.exp(-squared_distances(x, x) / 400.0)))(X)
    np.testing.assert_allclose(
        np.asarray(g), np.asarray(jax.grad(plain)(X)), rtol=1e-9, atol=1e-12
    )


def test_gram_backward_adds_no_nmd_buffer():
    """The backward of a high-D gram stores no (N, M, D) array beyond what
    the forward's reduction takes (the GPU fuses that reduction into one
    kernel; the CPU backend stages it): compiled temporaries of the
    gradient exceed the forward's by O(N·M) at most."""
    n, m, d = 256, 192, 64

    def loss(x, y):
        return jnp.sum(jnp.exp(-squared_distances(x, y) / 100.0))

    X = jax.ShapeDtypeStruct((n, d), jnp.float32)
    Y = jax.ShapeDtypeStruct((m, d), jnp.float32)
    fwd, bwd = (
        fn.lower(X, Y).compile().memory_analysis().temp_size_in_bytes
        for fn in (jax.jit(loss), jax.jit(jax.grad(loss, (0, 1))))
    )
    assert bwd - fwd < n * m * d * 4 / 8


def test_gram_length_scale_gradient_matches_closed_form(rng):
    X = jnp.asarray(rng.uniform(0, 10, 64), dtype=jnp.float64)

    def loss(ls):
        K = ab.SquaredExponential(ls, 2.0)(X)
        return jnp.sum(K * jnp.cos(K))

    def loss_ref(ls):
        K = squared_exponential_covariance(jnp.abs(X[:, None] - X[None, :]), ls, 2.0)
        return jnp.sum(K * jnp.cos(K))

    assert float(jax.grad(loss)(1.7)) == pytest.approx(
        float(jax.grad(loss_ref)(1.7)), rel=1e-10
    )


@pytest.mark.parametrize("j0", [0, 128, 256])
def test_lazy_gram_columns_include_diagonal(j0, rng):
    """The lazy-gram column builder reproduces the active rows of K plus the
    noise + jitter diagonal, at D=32 (high-D grams now take the lazy path)."""
    from albatross_tpu.models.gp import _make_gram_col_fn

    n, d, b = 384, 32, 128
    X = jnp.asarray(rng.uniform(0, 100, (n, d)))
    col = _make_gram_col_fn(X, 40.0, 1.3, 0.25, "matern_52")(j0, b)
    K = np.asarray(ab.Matern52(40.0, 1.3)(X)) + 0.25 * np.eye(n)
    np.testing.assert_allclose(np.asarray(col), K[j0:, j0 : j0 + b], rtol=1e-12)


def test_highd_kernel_matches_lazy_gram_pattern():
    """D > 8 no longer opts out of the lazy-gram NLML."""
    kernel = ab.SquaredExponential(5.0, 1.0) + ab.measurement_only(
        ab.IndependentNoise(0.1, assume_unique=True)
    )
    model = ab.gp_from_covariance(kernel, jitter=1e-6)
    from albatross_tpu.kernels import as_measurement

    pieces = model._training_cov_fused_pieces(as_measurement(jnp.zeros((16, 32))))
    assert pieces is not None
    x2, ls, sigma, diag_add, profile = pieces
    assert x2.shape == (16, 32) and profile == "squared_exponential"
    assert float(diag_add) == pytest.approx(0.01 + 1e-6)


def test_euclidean_pairwise_1d_is_abs(rng):
    x = jnp.asarray(rng.uniform(0, 100, 50))
    np.testing.assert_array_equal(
        np.asarray(EuclideanDistance().pairwise(x, x)),
        np.abs(np.asarray(x)[:, None] - np.asarray(x)[None, :]),
    )


# ---------------------------------------------------------------------------
# The GPU kernel (ops/triton_gram.py), run through the Pallas interpreter
# ---------------------------------------------------------------------------
@pytest.fixture
def on_gpu_interpreted(monkeypatch):
    """Route kernels as on a GPU, with the Triton kernel interpreted."""
    from albatross_tpu.ops import triton_gram

    calls = []
    real = triton_gram.pallas_radial_gram

    def interpreted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, interpret=True, **kwargs)

    monkeypatch.setattr(triton_gram, "pallas_radial_gram", interpreted)
    monkeypatch.setattr(triton_gram.jax, "default_backend", lambda: "gpu")
    return calls


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_triton_gram_matches_closed_form(profile, rng):
    """Every profile, with N and M off the tile multiples (padding)."""
    from albatross_tpu.ops.triton_gram import pallas_radial_gram

    n, m, d = 200, 150, 12
    X = jnp.asarray(rng.uniform(0, 6, (n, d)), dtype=jnp.float32)
    Y = jnp.asarray(rng.uniform(0, 6, (m, d)), dtype=jnp.float32)
    K = pallas_radial_gram(X, Y, 3.0, 2.0, profile, interpret=True)
    assert K.shape == (n, m) and K.dtype == jnp.float32
    ref = np.asarray(PROFILES[profile](jnp.asarray(np.sqrt(_d2_64(X, Y))), 3.0, 2.0))
    np.testing.assert_allclose(np.asarray(K), ref, atol=5e-6)


@pytest.mark.parametrize("d", [9, 20, 32])
def test_triton_gram_symmetric_exact_diagonal(d, rng):
    """Bitwise symmetric with an exact σ² diagonal at coordinates ~100, for
    power-of-two and padded feature counts."""
    from albatross_tpu.ops.triton_gram import pallas_radial_gram

    n = 192
    X = jnp.asarray(rng.uniform(0, 100, (n, d)), dtype=jnp.float32)
    K = np.asarray(pallas_radial_gram(X, X, 60.0, 1.5, "squared_exponential",
                                      interpret=True))
    assert np.array_equal(K, K.T)
    np.testing.assert_array_equal(np.diag(K), np.full(n, 1.5**2, np.float32))
    np.testing.assert_allclose(
        K, 1.5**2 * np.exp(-_d2_64(X, X) / 3600.0), atol=5e-6
    )


def test_triton_gram_diag_add(rng):
    from albatross_tpu.ops.triton_gram import pallas_radial_gram

    n, d = 200, 16
    X = jnp.asarray(rng.uniform(0, 50, (n, d)), dtype=jnp.float32)
    diag = jnp.asarray(rng.uniform(0.1, 0.5, n), dtype=jnp.float32)
    got = pallas_radial_gram(X, X, 5.0, 1.2, "matern_32", diag=diag,
                             interpret=True)
    base = pallas_radial_gram(X, X, 5.0, 1.2, "matern_32", interpret=True)
    np.testing.assert_array_equal(
        np.asarray(got), np.asarray(base) + np.diag(np.asarray(diag))
    )


def test_triton_gram_no_cancellation_at_large_coordinates(rng):
    from albatross_tpu.ops.triton_gram import pallas_radial_gram

    n, d = 130, 16
    X = jnp.asarray(1e4 + rng.standard_normal((1, d))
                    + rng.standard_normal((n, d)), dtype=jnp.float32)
    K = pallas_radial_gram(X, X, 2.0, 1.5, "squared_exponential",
                           interpret=True)
    np.testing.assert_allclose(
        np.asarray(K), 1.5**2 * np.exp(-_d2_64(X, X) / 4.0), atol=5e-6
    )


@pytest.mark.parametrize("d", [3, 8, 17, 100])
def test_triton_gram_loop_over_features(d, rng):
    """The kernel's loop over D (whole trips of D_UNROLL plus an unrolled
    remainder) sums every feature once, in order."""
    from albatross_tpu.ops.triton_gram import pallas_radial_gram

    n, m = 70, 130
    X = jnp.asarray(rng.uniform(0, 30, (n, d)), dtype=jnp.float32)
    Y = jnp.asarray(rng.uniform(0, 30, (m, d)), dtype=jnp.float32)
    K = pallas_radial_gram(X, Y, 40.0, 1.1, "squared_exponential",
                           interpret=True)
    np.testing.assert_allclose(
        np.asarray(K), 1.1**2 * np.exp(-_d2_64(X, Y) / 1600.0), atol=5e-6
    )


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_nonpositive_length_scale_gives_zero(profile, rng):
    """ls ≤ 0 gives a zero gram on every route, diagonal included, where
    an unguarded 0/0 would give NaN."""
    from albatross_tpu.ops.triton_gram import _xla_gram, pallas_radial_gram

    X = jnp.asarray(rng.uniform(0, 5, (40, 12)), dtype=jnp.float32)
    for ls in (0.0, -1.0):
        K = pallas_radial_gram(X, X, ls, 1.3, profile, interpret=True)
        np.testing.assert_array_equal(np.asarray(K), 0.0)
        np.testing.assert_array_equal(
            np.asarray(_xla_gram(X, X, ls, 1.3, profile)), 0.0
        )
        ref = PROFILES[profile](jnp.zeros(3), ls, 1.3)
        np.testing.assert_array_equal(np.asarray(ref), 0.0)


def test_use_triton_gram_policy(monkeypatch):
    from albatross_tpu.ops import triton_gram

    x32 = jnp.zeros((8, 32), jnp.float32)
    assert not triton_gram.use_triton_gram(x32, x32)  # the CPU backend
    monkeypatch.setattr(triton_gram.jax, "default_backend", lambda: "gpu")
    assert triton_gram.use_triton_gram(x32, x32)
    low = jnp.zeros((8, triton_gram.MIN_D - 1), jnp.float32)
    assert not triton_gram.use_triton_gram(low, low)
    x64 = jnp.zeros((8, 32), jnp.float64)
    assert not triton_gram.use_triton_gram(x64, x64)


def test_kernels_route_to_triton_on_gpu(on_gpu_interpreted, rng):
    """High-D f32 grams take the kernel on a GPU; low-D ones do not."""
    X = jnp.asarray(rng.uniform(0, 10, (100, 12)), dtype=jnp.float32)
    Y = jnp.asarray(rng.uniform(0, 10, (70, 12)), dtype=jnp.float32)
    D = jnp.asarray(np.sqrt(_d2_64(X, Y)))
    for kernel in (ab.SquaredExponential(4.0, 1.3), ab.Matern52(4.0, 1.3)):
        on_gpu_interpreted.clear()
        got = kernel(X, Y)
        assert on_gpu_interpreted == [(100, 12)]
        ref = PROFILES[kernel._profile_name](D, 4.0, 1.3)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=5e-6)
    on_gpu_interpreted.clear()
    ab.SquaredExponential(4.0, 1.3)(X[:, :3], Y[:, :3])
    assert on_gpu_interpreted == []


def test_triton_gram_gradients_match_xla(on_gpu_interpreted, rng):
    """The custom VJPs (XLA closed form) give the gradients of the plain
    gram, for the hyperparameters, the features and the diagonal."""
    from albatross_tpu.ops.triton_gram import _xla_gram, radial_gram, training_gram

    X = jnp.asarray(rng.uniform(0, 10, (90, 12)), dtype=jnp.float32)
    W = jnp.asarray(rng.standard_normal((90, 90)), dtype=jnp.float32)
    dg = jnp.asarray(rng.uniform(0.1, 0.3, 90), dtype=jnp.float32)

    def via(gram):
        return jax.grad(lambda x, l, s, d: jnp.sum(W * gram(x, l, s, d)),
                        (0, 1, 2, 3))(X, 4.0, 1.3, dg)

    got = via(lambda x, l, s, d: training_gram(x, l, s, d, "matern_32"))
    ref = via(lambda x, l, s, d: _xla_gram(x, x, l, s, "matern_32") + jnp.diag(d))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4,
                                   atol=1e-4)
    got = via(lambda x, l, s, d: radial_gram(x, x, l, s, "exponential"))
    ref = via(lambda x, l, s, d: _xla_gram(x, x, l, s, "exponential"))
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4,
                                   atol=1e-4)


def test_gp_fit_and_nlml_through_fused_training_kernel(on_gpu_interpreted, rng):
    """On a GPU the high-D training covariance (gram + noise + jitter +
    target variance) is one kernel pass; fit and NLML match the XLA path."""
    n, d = 150, 12
    X = jnp.asarray(rng.uniform(0, 10, (n, d)), dtype=jnp.float32)
    y = jnp.asarray(np.sin(np.asarray(X)[:, 0]), dtype=jnp.float32)
    var = jnp.full((n,), 0.01, jnp.float32)
    model = ab.gp_from_covariance(
        ab.SquaredExponential(6.0, 1.0)
        + ab.measurement_only(ab.IndependentNoise(0.2, assume_unique=True)),
        jitter=1e-4,
    )
    data = ab.RegressionDataset.create(X, y, variance=var)
    info = np.asarray(model.fit(data).fit.information)
    ll = float(model.log_likelihood(ab.RegressionDataset.create(X, y)))
    assert (n, d) in on_gpu_interpreted
    K = 1.0 * np.exp(-_d2_64(X, X) / 36.0) + (0.04 + 1e-4) * np.eye(n)
    np.testing.assert_allclose(
        info, np.linalg.solve(K + 0.01 * np.eye(n), np.asarray(y, np.float64)),
        rtol=2e-3, atol=2e-3,
    )
    L = np.linalg.cholesky(K)
    w = np.linalg.solve(L, np.asarray(y, np.float64))
    ll64 = -0.5 * (2 * np.sum(np.log(np.diag(L))) + w @ w + n * np.log(2 * np.pi))
    assert ll == pytest.approx(ll64, rel=1e-4)
