"""What the library derives from the device it runs on, and the GPU smoke
script's guards: compile-cache location, the exact-product precision,
the panel-factorizer choices."""

import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from albatross_tpu.utils import compile_cache

REPO = pathlib.Path(__file__).resolve().parents[1]


# -- compilation cache -------------------------------------------------------
def test_compilation_cache_dir_follows_environment():
    env = {compile_cache.ENV_VAR: "/somewhere/cache"}
    assert compile_cache.compilation_cache_dir(env) == "/somewhere/cache"


def test_compilation_cache_dir_defaults_to_checkout():
    path = compile_cache.compilation_cache_dir({})
    assert path == str(REPO / ".jax_cache")
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


@pytest.mark.parametrize("env_dir", [None, "/env/cache"])
def test_enable_compilation_cache_sets_only_without_env(monkeypatch, env_dir):
    updates = []
    monkeypatch.setattr(
        compile_cache.jax.config, "update",
        lambda name, value: updates.append((name, value)),
    )
    if env_dir is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        assert compile_cache.enable_compilation_cache() == str(
            REPO / ".jax_cache"
        )
        assert updates == [("jax_compilation_cache_dir", str(REPO / ".jax_cache"))]
    else:
        monkeypatch.setenv(compile_cache.ENV_VAR, env_dir)
        assert compile_cache.enable_compilation_cache() == env_dir
        assert updates == []


# -- precision ---------------------------------------------------------------
def test_exact_product_precision_gives_exact_f32_products(rng):
    from albatross_tpu.ops.compensated import EXACT_PRODUCT_PRECISION

    assert EXACT_PRODUCT_PRECISION == jax.lax.Precision.HIGHEST
    a = rng.standard_normal((128, 96)).astype(np.float32)
    b = rng.standard_normal((96, 64)).astype(np.float32)
    got = jnp.matmul(jnp.asarray(a), jnp.asarray(b),
                     precision=EXACT_PRODUCT_PRECISION)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    # exact products leave only f32 accumulation rounding
    assert np.max(np.abs(np.asarray(got) - ref)) / np.max(np.abs(ref)) < 1e-6


def test_double_word_factorization_defaults_to_exact_products(rng, monkeypatch):
    from albatross_tpu.ops import compensated

    seen = []
    real = jnp.matmul

    def spy(*args, precision=None, **kw):
        seen.append(precision)
        return real(*args, precision=precision, **kw)

    monkeypatch.setattr(compensated.jnp, "matmul", spy)
    A = rng.standard_normal((512, 512))
    K = jnp.asarray(A @ A.T + 512 * np.eye(512), jnp.float32)
    compensated.blocked_cholesky_dw.clear_cache()
    compensated.blocked_cholesky_dw(K, block_size=256)
    compensated.blocked_cholesky_dw.clear_cache()
    assert seen and all(p == jax.lax.Precision.HIGHEST for p in seen)


# -- panel factorizer --------------------------------------------------------
@pytest.mark.parametrize("factorizer", ["pallas", "mosaic"])
def test_unknown_panel_factorizer_rejected(factorizer, rng):
    from albatross_tpu.ops.blocked_cholesky import blocked_cholesky_cols

    A = rng.standard_normal((512, 512))
    K = jnp.asarray(A @ A.T + 512 * np.eye(512))
    with pytest.raises(ValueError, match="panel factorizer"):
        blocked_cholesky_cols(K, block_size=256, panel_factorizer=factorizer)


@pytest.mark.parametrize("factorizer", [None, "builtin", "fused"])
def test_known_panel_factorizers_agree(factorizer, rng):
    from albatross_tpu.ops.blocked_cholesky import blocked_cholesky_cols

    A = rng.standard_normal((512, 512))
    K = A @ A.T + 512 * np.eye(512)
    L = blocked_cholesky_cols(
        jnp.asarray(K), block_size=256, panel_factorizer=factorizer
    )
    np.testing.assert_allclose(
        np.asarray(L), np.linalg.cholesky(K), rtol=1e-9, atol=1e-9
    )


# -- the GPU smoke script and benchmark refuse the CPU ------------------------
def _run(args, cwd, **env):
    full_env = {k: v for k, v in os.environ.items()
                if k not in ("PYTHONPATH", "XLA_FLAGS")}
    full_env.update(JAX_PLATFORMS="cpu", **env)
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=full_env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_scripts_refuse_cpu(script):
    out = _run([script], REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "GPU" in out.stderr


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(["chip_smoke.py", "--rehearse"], tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "albatross_tpu" in out.stderr


def test_chip_smoke_rehearsal_runs_phases(tmp_path):
    """The smoke script's control flow at rehearsal sizes on the CPU: the
    headline NLML and the accuracy-mode phases pass, and no result line
    is printed for a non-GPU device."""
    out = _run(["chip_smoke.py", "--rehearse", "--phases", "bf"], REPO,
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert sum(line.startswith("[b] nlml") and line.endswith("PASS")
               for line in lines) == 2
    assert any(line.startswith("[f] compensated") and line.endswith("PASS")
               for line in lines)
    assert '"ok"' not in out.stdout
