"""GEMM-composed explicit inverses from a Cholesky factor (LAPACK potri).

XLA's TriangularSolve against an identity substitutes a few columns at a
time and is latency-bound; these routines rebuild the same quantities from
large GEMMs instead:

    W    = L⁻¹   two-level blocked triangular inverse (tri_inverse_full)
    K⁻¹  = WᵀW   exploiting W's triangularity — n³/3 FLOPs in S large GEMMs
                 instead of a dense n³ square (blocked_lauum)

They power ``CholeskyFactor.inverse / inverse_diagonal / inverse_blocks``
(the serving DirectInverse construction and the fast LOO/LOGO CV engine,
reference: serializable_ldlt.hpp:137-217) for large N.

Negative result, recorded so it is not retried: a custom VJP for the NLML
(backward = c_ld·K⁻¹ − c_q·ααᵀ built with these routines) costs ~n³
backward GEMM FLOPs (trtri 2n³/3 + lauum n³/3) while the autodiff adjoint
through the blocked factorization costs ~2n³/3, and it was slightly less
accurate in f32 (explicit-inverse cancellation).  The fused autodiff path in models/gp.py stays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from .blocked_cholesky import blocked_tri_inverse

_BLOCK_CANDIDATES = (2560, 2048, 1536, 1280, 1024, 512, 256, 128)
_PAD_BLOCK = 512


def _pick_block(n: int) -> int | None:
    for b in _BLOCK_CANDIDATES:
        if n % b == 0 and n > b:
            return b
    return None


def _pad_identity_tail(T: jnp.ndarray, npad: int) -> jnp.ndarray:
    """Embed lower-triangular T as blockdiag(T, I_{npad−n}).

    For any lower-triangular T this preserves triangularity, and both
    trtri and lauum factor through it: blockdiag(T, I)⁻¹ = blockdiag(T⁻¹, I)
    and blockdiag(W, I)ᵀblockdiag(W, I) = blockdiag(WᵀW, I) — so padded
    results slice back exactly (no approximation, just wasted tail FLOPs
    < (_PAD_BLOCK/n)·3 of the total)."""
    n = T.shape[0]
    out = jnp.pad(T, ((0, npad - n), (0, npad - n)))
    tail = jnp.concatenate(
        [jnp.zeros((n,), T.dtype), jnp.ones((npad - n,), T.dtype)]
    )
    return out + jnp.diag(tail)


def tri_inverse_full(L: jnp.ndarray) -> jnp.ndarray:
    """W = L⁻¹ for a full-size lower-triangular factor, GEMM-rich.

    Two-level: coarse row blocks whose diagonal sub-inverses are themselves
    GEMM-composed (vmapped blocked_tri_inverse) — the same trick the forward
    factorization uses for its panels (ops/blocked_cholesky.py).

    Total for every N: a non-divisible N > 2048 is identity-tail padded to
    the next _PAD_BLOCK multiple (exact; see _pad_identity_tail) instead of
    falling back to the latency-bound dense substitution that OOMs at
    compile above ~8k.
    """
    n = L.shape[0]
    if n <= 2048:
        return solve_triangular(L, jnp.eye(n, dtype=L.dtype), lower=True)
    b = _pick_block(n)
    if b is None:
        npad = ((n + _PAD_BLOCK - 1) // _PAD_BLOCK) * _PAD_BLOCK
        return tri_inverse_full(_pad_identity_tail(L, npad))[:n, :n]
    S = n // b
    diag = jnp.stack(
        [jax.lax.slice(L, (i * b, i * b), ((i + 1) * b, (i + 1) * b)) for i in range(S)]
    )
    inner = 512 if b % 512 == 0 and b > 512 else None
    if inner is not None:
        winv = jax.vmap(lambda Li: blocked_tri_inverse(Li, inner))(diag)
    else:
        eye = jnp.eye(b, dtype=L.dtype)
        winv = jax.vmap(lambda Li: solve_triangular(Li, eye, lower=True))(diag)
    Wtop = jnp.concatenate([winv[0], jnp.zeros((b, n - b), L.dtype)], axis=1)
    for r in range(1, S):
        r0 = r * b
        Lr = jax.lax.slice(L, (r0, 0), (r0 + b, r0))
        left = -winv[r] @ (Lr @ Wtop[:, :r0])
        row = jnp.concatenate(
            [left, winv[r], jnp.zeros((b, n - r0 - b), L.dtype)], axis=1
        )
        Wtop = jnp.concatenate([Wtop, row], axis=0)
    return Wtop


def blocked_lauum(W: jnp.ndarray, block: int | None = None) -> jnp.ndarray:
    """WᵀW for lower-triangular W, exploiting triangularity (LAPACK lauum).

    Row strip i of the lower triangle of M = WᵀW is one GEMM
        M[i, :i+1] = W[i:, i]ᵀ @ W[i:, :i+1]
    (rows above block i of the i-th block column are zero), so the whole
    product is S large GEMMs totalling n³/3 FLOPs instead of a dense n³.
    """
    n = W.shape[0]
    if n <= 2048:
        return W.T @ W
    b = block if block is not None else _pick_block(n)
    if b is None:
        npad = ((n + _PAD_BLOCK - 1) // _PAD_BLOCK) * _PAD_BLOCK
        return blocked_lauum(_pad_identity_tail(W, npad))[:n, :n]
    S = n // b
    strips = []
    for i in range(S):
        i0 = i * b
        Wi = jax.lax.slice(W, (i0, i0), (n, i0 + b))  # (n-i0, b) block col i
        Wrows = jax.lax.slice(W, (i0, 0), (n, i0 + b))  # (n-i0, :i+1 cols)
        strip = Wi.T @ Wrows  # (b, (i+1)·b): blocks j ≤ i of row i
        strips.append(
            jnp.concatenate([strip, jnp.zeros((b, n - i0 - b), W.dtype)], axis=1)
        )
    Mlow = jnp.concatenate(strips, axis=0)  # block-lower incl. full diag blocks
    rows = jnp.arange(n)[:, None] // b
    cols = jnp.arange(n)[None, :] // b
    strict_lower = rows > cols
    return (
        jnp.where(strict_lower, Mlow, 0.0)
        + jnp.where(strict_lower, Mlow, 0.0).T
        + jnp.where(rows == cols, Mlow, 0.0)
    )


def spd_inverse_from_factor(L: jnp.ndarray) -> jnp.ndarray:
    """K⁻¹ = WᵀW from the Cholesky factor (potri: trtri + lauum)."""
    W = tri_inverse_full(L)
    return blocked_lauum(W)
