"""Checks that only the card can answer (marker ``gpu``; they skip
elsewhere).  Run them on a machine with an NVIDIA GPU, in one process:

    ALBATROSS_TEST_PLATFORMS=cuda python -m pytest tests -m gpu -p no:xdist
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import albatross_tpu as ab

pytestmark = pytest.mark.gpu


def _d2_64(X):
    X64 = np.asarray(X, np.float64)
    sq = np.sum(X64 * X64, axis=1)
    # exact enough in f64 for a reference at unit-scale differences
    return np.maximum(sq[:, None] + sq[None, :] - 2.0 * X64 @ X64.T, 0.0)


def test_precisions_on_card(gpu_device, rng):
    """HIGHEST is full FP32 (exact products); the default runs in TF32."""
    a = rng.standard_normal((1024, 1024)).astype(np.float32)
    b = rng.standard_normal((1024, 1024)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)

    def err(precision):
        out = jnp.matmul(jnp.asarray(a), jnp.asarray(b), precision=precision)
        return np.max(np.abs(np.asarray(out, np.float64) - ref)) / np.max(
            np.abs(ref)
        )

    assert err(jax.lax.Precision.HIGHEST) < 1e-5
    assert err(None) > 1e-5


def test_highd_gram_on_card_is_exact(gpu_device, rng):
    n, d = 4096, 32
    X = rng.uniform(0.0, 100.0, (n, d)).astype(np.float32)
    K = np.asarray(jax.jit(lambda x: ab.SquaredExponential(150.0, 1.0)(x))(
        jnp.asarray(X, jnp.float32)))
    assert K.dtype == np.float32
    assert np.array_equal(K, K.T)
    assert np.all(np.diag(K) == np.float32(1.0))
    np.testing.assert_allclose(K, np.exp(-_d2_64(X) / 150.0**2), atol=1e-5)


def test_blocked_nlml_on_card_matches_f64(gpu_device, rng):
    n = 4096
    x = np.sort(rng.uniform(0.0, 100.0, n)).astype(np.float32)
    y = np.sin(0.3 * x).astype(np.float32)
    model = ab.gp_from_covariance(
        ab.SquaredExponential(2.0, 1.0)
        + ab.measurement_only(ab.IndependentNoise(0.3, assume_unique=True)),
        jitter=1e-4,
    )
    data = ab.RegressionDataset.create(jnp.asarray(x, jnp.float32),
                                       jnp.asarray(y, jnp.float32))
    ll = float(jax.jit(lambda m, d: m.log_likelihood(d))(model, data))
    x64 = x.astype(np.float64)
    K = np.exp(-((x64[:, None] - x64[None, :]) ** 2) / 4.0) + 0.0901 * np.eye(n)
    L = np.linalg.cholesky(K)
    w = np.linalg.solve(L, y.astype(np.float64))
    ll64 = -0.5 * (2 * np.sum(np.log(np.diag(L))) + w @ w + n * np.log(2 * np.pi))
    assert ll == pytest.approx(ll64, rel=1e-3)


def test_2d_cholesky_on_card_in_chunks(gpu_device, rng, monkeypatch):
    """The 2-D factorization on a (1, 1) mesh with a chunked trailing
    update matches cuSOLVER's f32 factor of the same matrix."""
    from albatross_tpu.parallel import cholesky2d, distributed_cholesky_2d, make_mesh

    n = 4096
    monkeypatch.setattr(cholesky2d, "UPDATE_CHUNK_ELEMENTS", n * 512)
    A = rng.standard_normal((n, n)).astype(np.float32)
    K = jnp.asarray(A @ A.T / n + np.eye(n, dtype=np.float32))
    mesh = make_mesh(1, ("data", "model"), shape=(1, 1))
    with jax.default_matmul_precision("highest"):
        L = np.asarray(distributed_cholesky_2d(K, mesh, panel=512))
        ref = np.asarray(jnp.linalg.cholesky(K))
    assert np.all(np.triu(L, 1) == 0.0)
    np.testing.assert_allclose(L, ref, atol=1e-4)
