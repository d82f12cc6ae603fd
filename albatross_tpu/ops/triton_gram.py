"""Radial gram matrices on NVIDIA GPUs: a Pallas kernel through Triton.

For high-dimensional features XLA's fused reduction re-reads both feature
rows for every output element.  This kernel computes one (BLOCK_M,
BLOCK_N) output tile per program: the two blocks of transposed features
are loaded once, the exact per-pair differences are squared and summed
over D in registers, the radial profile (and, for a training covariance,
the noise + jitter + target-variance diagonal) is applied in place, and
the tile is written once.  The arithmetic is the exact form of
``kernels/distances.py`` — Σ_k (x_ik − y_jk)² in feature order — so the
result is bitwise symmetric with an exact σ² diagonal.

Gradients run through the XLA closed form (``radial_profile`` of
``squared_distances``, whose own VJP stores no (N, M, D) array).

The kernel runs compiled for the GPU; ``interpret=True`` (tests only)
runs it through the Pallas interpreter on any backend.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..kernels.distances import squared_distances
from ..kernels.radial import radial_profile

# Tile shape and warps: the fastest of 64×64/4, 128×64/4 and 128×128/8 at
# N=8192, D=32 on an H100 (PERF.md).
BLOCK_M = 128
BLOCK_N = 64
NUM_WARPS = 4
# Features summed per trip of the kernel's loop over D.
D_UNROLL = 8
# Features at and above this dimension take the kernel on a GPU: it beat
# XLA's fused exact form at every D measured on an H100, 4 to 128, at
# N=8192 (PERF.md).  Below it nothing was measured and XLA's fusion is kept.
MIN_D = 4


def use_triton_gram(X, Y) -> bool:
    """Whether the (N, D) / (M, D) batches take the kernel: on a GPU, f32,
    D ≥ MIN_D."""
    return (
        jax.default_backend() == "gpu"
        and X.ndim == 2
        and Y.ndim == 2
        and X.shape[1] >= MIN_D
        and X.dtype == jnp.float32
        and Y.dtype == jnp.float32
    )


def _gram_kernel(params_ref, xt_ref, yt_ref, *rest, d, profile, bm, bn):
    diag_ref, out_ref = rest if len(rest) == 2 else (None, rest[0])

    def add_feature(k, acc):
        diff = xt_ref[k, :][:, None] - yt_ref[k, :][None, :]
        return acc + diff * diff

    def add_features(c, acc):
        for t in range(D_UNROLL):
            acc = add_feature(c * D_UNROLL + t, acc)
        return acc

    # features in order, D_UNROLL per loop trip, the remainder unrolled
    acc = jax.lax.fori_loop(
        0, d // D_UNROLL, add_features, jnp.zeros((bm, bn), jnp.float32)
    )
    for k in range(d - d % D_UNROLL, d):
        acc = add_feature(k, acc)
    out = radial_profile(profile, acc, params_ref[0], params_ref[1])
    if diag_ref is not None:
        rows = pl.program_id(0) * bm + jax.lax.broadcasted_iota(
            jnp.int32, (bm, bn), 0
        )
        cols = pl.program_id(1) * bn + jax.lax.broadcasted_iota(
            jnp.int32, (bm, bn), 1
        )
        out = out + jnp.where(rows == cols, diag_ref[...][:, None], 0.0)
    out_ref[...] = out


def _padded_transpose(X, rows: int, dp: int):
    """(dp, rows) zero-padded Xᵀ: zero feature rows add exactly 0 to every
    distance, padded points are sliced off the output."""
    return jnp.zeros((dp, rows), X.dtype).at[: X.shape[1], : X.shape[0]].set(X.T)


@functools.partial(jax.jit, static_argnames=("profile", "interpret"))
def pallas_radial_gram(
    X, Y, length_scale, sigma, profile: str, diag=None, interpret: bool = False
):
    """(N, M) f32 radial gram of (N, D) / (M, D) f32 batches, plus
    ``diag`` (N,) added where row == column when given."""
    n, d = X.shape
    m = Y.shape[0]
    n_pad = -(-n // BLOCK_M) * BLOCK_M
    m_pad = -(-m // BLOCK_N) * BLOCK_N
    dp = 1 << max(0, (d - 1).bit_length())  # Triton blocks are powers of 2
    params = jnp.stack(
        [jnp.asarray(length_scale, jnp.float32), jnp.asarray(sigma, jnp.float32)]
    )
    operands = [params, _padded_transpose(X, n_pad, dp),
                _padded_transpose(Y, m_pad, dp)]
    in_specs = [
        pl.BlockSpec((2,), lambda i, j: (0,)),
        pl.BlockSpec((dp, BLOCK_M), lambda i, j: (0, i)),
        pl.BlockSpec((dp, BLOCK_N), lambda i, j: (0, j)),
    ]
    if diag is not None:
        operands.append(jnp.zeros((n_pad,), jnp.float32).at[:n].set(diag))
        in_specs.append(pl.BlockSpec((BLOCK_M,), lambda i, j: (i,)))
    out = pl.pallas_call(
        functools.partial(
            _gram_kernel, d=d, profile=profile, bm=BLOCK_M, bn=BLOCK_N
        ),
        grid=(n_pad // BLOCK_M, m_pad // BLOCK_N),
        in_specs=in_specs,
        out_specs=pl.BlockSpec((BLOCK_M, BLOCK_N), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((n_pad, m_pad), jnp.float32),
        compiler_params=pltriton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        backend="triton",
        interpret=interpret,
        name=f"radial_gram_{profile}",
    )(*operands)
    return out[:n, :m]


def _xla_gram(X, Y, length_scale, sigma, profile):
    return radial_profile(profile, squared_distances(X, Y), length_scale, sigma)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4,))
def radial_gram(X, Y, length_scale, sigma, profile):
    """Differentiable kernel gram: Triton forward, XLA closed-form VJP."""
    return pallas_radial_gram(X, Y, length_scale, sigma, profile)


def _radial_gram_fwd(X, Y, length_scale, sigma, profile):
    return radial_gram(X, Y, length_scale, sigma, profile), (
        X, Y, length_scale, sigma,
    )


def _radial_gram_bwd(profile, residuals, g):
    _, vjp = jax.vjp(functools.partial(_xla_gram, profile=profile), *residuals)
    return vjp(g)


radial_gram.defvjp(_radial_gram_fwd, _radial_gram_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4,))
def training_gram(X, length_scale, sigma, diag, profile):
    """K(X, X) + diag(diag) in one kernel pass (the training covariance's
    noise, jitter and target variance ride the gram's write)."""
    return pallas_radial_gram(X, X, length_scale, sigma, profile, diag=diag)


def _training_gram_fwd(X, length_scale, sigma, diag, profile):
    return training_gram(X, length_scale, sigma, diag, profile), (
        X, length_scale, sigma,
    )


def _training_gram_bwd(profile, residuals, g):
    X, length_scale, sigma = residuals
    _, vjp = jax.vjp(
        lambda x, l, s: _xla_gram(x, x, l, s, profile), X, length_scale, sigma
    )
    return (*vjp(g), jnp.diagonal(g))


training_gram.defvjp(_training_gram_fwd, _training_gram_bwd)
