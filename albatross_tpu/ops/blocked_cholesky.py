"""Single-device blocked Cholesky built from large GEMMs.

This right-looking variant restructures the factorization so almost all
FLOPs land in large square GEMMs, the operation an accelerator runs
fastest:

    for each panel k (static python loop — shapes per step are static):
        L_kk   = chol(A_kk)                  (small, XLA builtin)
        W      = inv(L_kk)                   (b×b triangular inverse)
        L_pk   = A_pk @ W.T                  (GEMM)
        A_trail -= L_pk @ L_pk.T             (GEMM)

The triangular-inverse trick replaces the slow triangular *solve* against
(n−kb) right-hand sides with a GEMM; with the nugget/jitter policy GP
covariances carry, the extra rounding is benign (validated against the
builtin to ~1e-5 relative in f32, exact-path tests run in f64).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

DEFAULT_BLOCK = 1024
# sub-block size for GEMM-composed panel inverses (not yet tuned on the
# H100; PERF.md lists it)
DEFAULT_PANEL_SUB = 256


def auto_block_size(n: int, max_panels: int = 16) -> int:
    """Panel size choice: the smallest 128-aligned divisor of n ≥ 1792
    with at most ``max_panels`` panels (the unrolled program grows as
    panels²); ceil(n/8) rounded up to 128 when no such divisor exists.
    Smaller panels shorten the serial panel factorization and the O(n·b)
    copies at some cost in GEMM efficiency.  The rule is a starting point
    that has not been tuned on the H100 (PERF.md)."""
    best = None
    for g in range(max_panels, 1, -1):
        if n % g != 0:
            continue
        b = n // g
        if b >= 1792 and b % 128 == 0:
            best = b
            break
    if best is not None:
        return best
    b = max(DEFAULT_BLOCK, -(-n // 8))
    return -(-b // 128) * 128  # round up to the 128-lane boundary


def blocked_tri_inverse(
    L: jnp.ndarray, sub: int = DEFAULT_PANEL_SUB, precision=None
) -> jnp.ndarray:
    """Inverse of a lower-triangular matrix, GEMM-rich.

    XLA's TriangularSolve against an identity substitutes a few columns at
    a time and is latency-bound.  This builds W = L⁻¹ from sub-block
    inverses instead: the S diagonal blocks are inverted in one *batched*
    triangular solve (vmap), then row-block r of W is a pair of GEMMs
        W[r, :r] = -W_rr @ (L[r, :r] @ W[:r, :r]).
    ~2x the FLOPs of the dense substitution, all of them in GEMMs.
    """
    m = L.shape[0]
    if m <= sub or m % sub != 0:
        return solve_triangular(L, jnp.eye(m, dtype=L.dtype), lower=True)
    S = m // sub
    diag = jnp.stack(
        [
            jax.lax.slice(L, (i * sub, i * sub), ((i + 1) * sub, (i + 1) * sub))
            for i in range(S)
        ]
    )
    eye = jnp.eye(sub, dtype=L.dtype)
    winv = jax.vmap(lambda Li: solve_triangular(Li, eye, lower=True))(diag)
    return _compose_inverse_rows(L, list(winv), sub, precision)


def _compose_inverse_rows(L, winv, sub: int, precision=None):
    """W = L⁻¹ from per-sub-block inverses ``winv``: row-block recursion
    W[r, :r0] = −winv[r] (L[r, :r0] W[:r0]).  Shared by
    ``blocked_tri_inverse`` (batched-solve winv) and
    ``fused_panel_chol_inverse`` (winv from the panel recursion)."""
    m = L.shape[0]
    S = m // sub
    Wtop = jnp.concatenate(
        [winv[0], jnp.zeros((sub, m - sub), L.dtype)], axis=1
    )  # (r*sub, m) rows built so far
    for r in range(1, S):
        r0 = r * sub
        Lr = jax.lax.slice(L, (r0, 0), (r0 + sub, r0))  # (sub, r0)
        left = -jnp.matmul(
            winv[r],
            jnp.matmul(Lr, Wtop[:, :r0], precision=precision),
            precision=precision,
        )  # (sub, r0)
        row = jnp.concatenate(
            [left, winv[r], jnp.zeros((sub, m - r0 - sub), L.dtype)], axis=1
        )
        Wtop = jnp.concatenate([Wtop, row], axis=0)
    return Wtop


def fused_panel_chol_inverse(
    Akk: jnp.ndarray, sub: int, precision=None
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(L, L⁻¹) of a diagonal panel via a right-looking sub-blocked
    recursion that materializes each sub-block inverse ONCE and reuses it
    for both the sub-panel solve and the W row recursion — replacing the
    builtin chol(b) + separate blocked_tri_inverse pair (which re-solves
    every diagonal sub-block).  Candidate for the serial-panel critical
    path."""
    n = Akk.shape[0]
    if n <= sub or n % sub != 0:
        L = jnp.linalg.cholesky(Akk)
        return L, blocked_tri_inverse(L, sub, precision=precision)
    S = n // sub
    eye = jnp.eye(sub, dtype=Akk.dtype)
    # active-rows layout (same as blocked_cholesky_cols): cols[k] holds
    # rows k·sub..n only, so trailing updates overwrite the whole array
    cols = [
        jax.lax.slice(Akk, (k * sub, k * sub), (n, (k + 1) * sub))
        for k in range(S)
    ]
    lkk, winv, belows = [], [], []
    for k in range(S):
        Lkk = jnp.linalg.cholesky(cols[k][:sub])
        Wk = solve_triangular(Lkk, eye, lower=True)
        below = jnp.matmul(cols[k][sub:], Wk.T, precision=precision)
        lkk.append(Lkk)
        winv.append(Wk)
        belows.append(below)
        k0 = k * sub
        for j in range(k + 1, S):
            j0 = j * sub
            Lj = below[j0 - k0 - sub : j0 - k0]
            Lrows = below[j0 - k0 - sub :]
            cols[j] = cols[j] - jnp.matmul(
                Lrows, Lj.T, precision=precision
            )
    L = jnp.tril(
        jnp.concatenate(
            [
                jnp.concatenate(
                    [
                        jnp.zeros((k * sub, sub), Akk.dtype),
                        lkk[k],
                        belows[k],
                    ],
                    axis=0,
                )
                for k in range(S)
            ],
            axis=1,
        )
    )
    # W = L⁻¹ reusing the sub-inverses the recursion already built
    return L, _compose_inverse_rows(L, winv, sub, precision)


def _panel_chol_inverse(
    Akk: jnp.ndarray, sub: int, precision=None, factorizer: str | None = None
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(L, L⁻¹) of a diagonal panel.

    The builtin factorization plus an inverse composed from batched
    sub-block inverses (blocked_tri_inverse), which is GEMM-rich;
    ``factorizer="fused"`` swaps in the sub-blocked recursion
    (fused_panel_chol_inverse).  NOTE: the choice must be threaded as a
    STATIC jit argument by callers (config.PANEL_FACTORIZER is read at
    trace time; a config flip alone cannot bust an already-cached trace).
    """
    if factorizer == "fused":
        return fused_panel_chol_inverse(Akk, sub, precision=precision)
    if factorizer not in (None, "builtin"):
        raise ValueError(
            f"unknown panel factorizer {factorizer!r}; "
            "expected None, 'builtin' or 'fused'"
        )
    L = jnp.linalg.cholesky(Akk)
    return L, blocked_tri_inverse(L, sub, precision=precision)


@functools.partial(
    jax.jit, static_argnames=("block_size", "use_inverse", "panel_sub")
)
def blocked_cholesky(
    K: jnp.ndarray,
    block_size: int | None = None,
    use_inverse: bool = True,
    rhs: jnp.ndarray | None = None,
    panel_sub: int | str | None = "auto",
) -> jnp.ndarray:
    """Lower-triangular Cholesky factor of an SPD matrix.

    With ``rhs`` (an (n,) vector), also returns ``z = L⁻¹ rhs`` computed by
    forward substitution interleaved with the factorization: the panel
    inverse ``W = L_kk⁻¹`` is already materialized for the panel solve, so
    whitening costs only per-panel GEMVs instead of a separate full-size
    single-RHS triangular solve (which is latency-bound).
    """
    n = K.shape[0]
    b = block_size if block_size is not None else auto_block_size(n)
    if n <= b:
        L = jnp.linalg.cholesky(K)
        if rhs is None:
            return L
        return L, solve_triangular(L, rhs[:, None], lower=True)[:, 0]

    A = K
    z = rhs
    for k0 in range(0, n, b):
        bk = min(b, n - k0)
        Akk = jax.lax.slice(A, (k0, k0), (k0 + bk, k0 + bk))
        Lkk = jnp.linalg.cholesky(Akk)
        A = jax.lax.dynamic_update_slice(A, Lkk, (k0, k0))
        rem = n - (k0 + bk)
        sub = DEFAULT_PANEL_SUB if panel_sub == "auto" else panel_sub
        W = None
        if use_inverse:
            # L_kk^{-1}: GEMM-composed when panel_sub is set, exact
            # TriangularSolve when the caller opts out (panel_sub=None)
            if sub is not None:
                W = blocked_tri_inverse(Lkk, sub)
            else:
                W = solve_triangular(
                    Lkk, jnp.eye(bk, dtype=K.dtype), lower=True
                )
        if z is not None:
            zk = jax.lax.slice(z, (k0,), (k0 + bk,))
            zk = (W @ zk) if W is not None else solve_triangular(
                Lkk, zk[:, None], lower=True
            )[:, 0]
            z = jax.lax.dynamic_update_slice(z, zk, (k0,))
        if rem == 0:
            continue
        Apk = jax.lax.slice(A, (k0 + bk, k0), (n, k0 + bk))  # (rem, bk)
        if W is not None:
            Lpk = Apk @ W.T
        else:
            Lpk = solve_triangular(Lkk, Apk.T, lower=True).T
        A = jax.lax.dynamic_update_slice(A, Lpk, (k0 + bk, k0))
        if z is not None:
            zt = jax.lax.slice(z, (k0 + bk,), (n,)) - Lpk @ zk
            z = jax.lax.dynamic_update_slice(z, zt, (k0 + bk,))
        # SYRK-style trailing update: only the lower-triangular column panels
        # are touched, halving the GEMM FLOPs vs a full square update.
        for j0 in range(k0 + bk, n, b):
            bj = min(b, n - j0)
            Lj = jax.lax.slice(A, (j0, k0), (j0 + bj, k0 + bk))  # (bj, bk)
            col = jax.lax.slice(A, (j0, j0), (n, j0 + bj))  # (n-j0, bj)
            Lrows = jax.lax.slice(A, (j0, k0), (n, k0 + bk))  # (n-j0, bk)
            col = col - Lrows @ Lj.T
            A = jax.lax.dynamic_update_slice(A, col, (j0, j0))
    L = jnp.tril(A)
    return L if rhs is None else (L, z)


_PRECISIONS = {
    None: None,
    "default": None,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}


def _auto_panel_precision(n: int) -> str | None:
    """Panel-GEMM precision of the default mode: Precision.HIGH from
    n = 32768 on, where accumulated rounding in the panel entries of L can
    push later diagonal blocks non-PSD.  Not yet swept on the H100
    (PERF.md)."""
    return "high" if n >= 32768 else None


def blocked_cholesky_left(
    col_fn,
    n: int,
    rhs: jnp.ndarray | None = None,
    block_size: int | None = None,
    panel_sub: int | str | None = "auto",
    panel_precision: str | None = "auto",
    diag_precision: str | None = None,
    trailing_precision: str | None = None,
    assemble: bool = True,
    dtype=jnp.float32,
    panel_factorizer: str | None = None,
):
    """LEFT-looking blocked Cholesky: one large (n−j0, j0)×(j0, b) GEMM
    per panel instead of G−k small right-looking trailing updates.

    ``col_fn(j0, b)`` returns the ACTIVE rows j0..n of covariance column
    panel [j0, j0+b) — including every diagonal term (noise, jitter,
    target variance).  Because the panel's gram is consumed directly by
    the subtraction ``col − L[j0:, :j0] @ L[j0:j0+b, :j0]ᵀ``, XLA fuses
    the (elementwise) gram producer into the GEMM epilogue: the N×N
    covariance never gets its own device-memory write.  Two more
    differences from the right-looking layout:

    * each output entry is accumulated over its FULL k-extent inside one
      GEMM (a single f32 rounding) instead of being stored to device memory and
      re-read G times with a rounding per panel — no trailing rewrite
      traffic, and no per-panel storage rounding;
    * the GEMM k-dimension grows to j0 (up to n−b).

    Semantics match ``blocked_cholesky_cols`` (fused whitening via the
    panel inverses, assemble=False diag+z path, precision escalation
    knobs).  Not jitted itself — call it inside jit (the NLML path does).
    """
    if not assemble and rhs is None:
        raise ValueError("assemble=False requires rhs (the NLML fused path)")
    b = block_size if block_size is not None else auto_block_size(n)
    if n <= b or n % b != 0:
        # small/non-divisible sizes: materialize and use the cols layout,
        # which honors the precision/factorizer knobs for every n > b
        # (non-divisible n pads to the panel boundary); at n <= b the
        # single panel is the XLA builtin and the knobs have no GEMMs to
        # act on
        K = _materialize_from_cols(col_fn, n, b)
        return blocked_cholesky_cols(
            K,
            rhs=rhs,
            panel_sub=panel_sub,
            diag_precision=None
            if diag_precision == "auto"
            else diag_precision,
            panel_precision=panel_precision,
            trailing_precision=trailing_precision,
            assemble=assemble,
            panel_factorizer=panel_factorizer,
        )
    if panel_precision == "auto":
        panel_precision = _auto_panel_precision(n)
    panel_prec = _PRECISIONS[panel_precision]
    diag_prec = _PRECISIONS[diag_precision]
    # "bf16" (trailing inputs stored at bf16) is a cols-layout knob: the
    # left-looking loop reads each factored panel once, so there is no
    # repeated trailing traffic to halve — treat it as default precision
    trail_prec = (
        None if trailing_precision == "bf16" else _PRECISIONS[trailing_precision]
    )
    sub = DEFAULT_PANEL_SUB if panel_sub == "auto" else panel_sub

    G = n // b
    L = jnp.zeros((n, n), dtype=dtype)
    z = None if rhs is None else jnp.asarray(rhs, dtype)
    diag_parts = []
    for j in range(G):
        j0 = j * b
        col = col_fn(j0, b)  # (n - j0, b)
        if j > 0:
            left_rows = jax.lax.slice(L, (j0, 0), (n, j0))  # (n - j0, j0)
            top = jax.lax.slice(L, (j0, 0), (j0 + b, j0))  # (b, j0)
            if diag_prec is not None and trail_prec is None:
                upd_diag = col[:b] - jnp.matmul(
                    top, top.T, precision=diag_prec
                )
                upd_rest = col[b:] - jnp.matmul(
                    left_rows[b:], top.T, precision=trail_prec
                )
                col = jnp.concatenate([upd_diag, upd_rest], axis=0)
            else:
                col = col - jnp.matmul(
                    left_rows, top.T, precision=trail_prec
                )
        Akk = col[:b]
        if sub is not None:
            Lkk, W = _panel_chol_inverse(
                Akk, sub, precision=panel_prec, factorizer=panel_factorizer
            )
        else:
            Lkk = jnp.linalg.cholesky(Akk)
            W = solve_triangular(Lkk, jnp.eye(b, dtype=dtype), lower=True)
        below = jnp.matmul(col[b:], W.T, precision=panel_prec)
        L = jax.lax.dynamic_update_slice(
            L, jnp.concatenate([Lkk, below], axis=0), (j0, j0)
        )
        diag_parts.append(jnp.diagonal(Lkk))
        if z is not None:
            zj = jax.lax.slice(z, (j0,), (j0 + b,))
            if j > 0:
                zj = zj - jnp.matmul(
                    jax.lax.slice(L, (j0, 0), (j0 + b, j0)),
                    jax.lax.slice(z, (0,), (j0,)),
                    precision=panel_prec,
                )
            zj = W @ zj
            z = jax.lax.dynamic_update_slice(z, zj, (j0,))
    if not assemble:
        return jnp.concatenate(diag_parts), z
    L = jnp.tril(L)
    return L if rhs is None else (L, z)


def _materialize_from_cols(col_fn, n: int, b: int) -> jnp.ndarray:
    """Assemble the full symmetric matrix from active-row column panels
    (fallback path for sizes the left-looking loop does not handle)."""
    blocks = []
    j0 = 0
    while j0 < n:
        bj = min(b, n - j0)
        col = col_fn(j0, bj)  # rows j0..n
        blocks.append(
            jnp.concatenate(
                [jnp.zeros((j0, bj), col.dtype), col], axis=0
            )
        )
        j0 += bj
    lower = jnp.concatenate(blocks, axis=1)
    strict_upper = jnp.triu(lower.T, 1)
    return jnp.tril(lower) + strict_upper


@functools.partial(
    jax.jit,
    static_argnames=(
        "block_size",
        "panel_sub",
        "diag_precision",
        "panel_precision",
        "trailing_precision",
        "assemble",
        "panel_factorizer",
    ),
)
def blocked_cholesky_cols(
    K: jnp.ndarray,
    block_size: int | None = None,
    rhs: jnp.ndarray | None = None,
    panel_sub: int | str | None = "auto",
    diag_precision: str | None = "auto",
    panel_precision: str | None = "auto",
    trailing_precision: str | None = None,
    assemble: bool = True,
    panel_factorizer: str | None = None,
) -> jnp.ndarray:
    """Column-panel-layout variant of ``blocked_cholesky``.

    The loop carries a python list of (n, b) column panels instead of one
    (n, n) array, so each trailing update rewrites only the touched panel
    (n·b copy) rather than forcing XLA to materialize a fresh n×n buffer —
    ~6× less copy traffic for 8 panels.  Trailing GEMMs slice to the needed
    rows, so FLOPs are exactly n³/3 + panel terms.

    ``diag_precision`` computes just the diagonal-block rows of every
    trailing update at a higher precision than the bulk, so accumulated
    rounding cannot push a later *diagonal block* non-PSD.  "auto" = off
    (the bulk precision everywhere).  ``panel_precision`` sets the panel
    GEMMs; "auto" = ``_auto_panel_precision(n)``.

    With ``rhs``, also returns ``z = L⁻¹ rhs`` (fused forward substitution,
    see ``blocked_cholesky``).

    ``assemble=False`` (requires ``rhs``) skips building the (n, n) factor
    entirely and returns ``(diag_L, z)`` — the NLML consumes only the
    log-determinant (panel diagonals) and the whitened vector, so the final
    column concatenation's O(N²) write is pure waste on that path.
    """
    n = K.shape[0]
    if not assemble and rhs is None:
        raise ValueError("assemble=False requires rhs (the NLML fused path)")
    b = block_size if block_size is not None else auto_block_size(n)
    if n <= b:
        # single panel: the XLA builtin factorizes it directly — the
        # precision/factorizer knobs govern panel/trailing GEMMs, which do
        # not exist at this size, so there is nothing to thread through
        out = blocked_cholesky(K, b, rhs=rhs, panel_sub=panel_sub)
        if not assemble:
            L, z = out
            return jnp.diagonal(L), z
        return out
    if n % b != 0:
        # pad to the next panel boundary with an identity block
        # ([[K, 0], [0, I]] factors as [[L, 0], [0, I]]) and run the main
        # loop so the precision/factorizer knobs stay honored for EVERY n
        # — a delegation to the rows layout would silently drop them
        m = -(-n // b) * b
        Kp = jnp.zeros((m, m), K.dtype)
        Kp = jax.lax.dynamic_update_slice(Kp, K, (0, 0))
        idx = jnp.arange(n, m)
        Kp = Kp.at[idx, idx].set(jnp.ones((), K.dtype))
        rp = None if rhs is None else jnp.concatenate(
            [rhs, jnp.zeros((m - n,), rhs.dtype)]
        )
        out = blocked_cholesky_cols(
            Kp,
            block_size=b,
            rhs=rp,
            panel_sub=panel_sub,
            diag_precision=diag_precision,
            panel_precision=panel_precision,
            trailing_precision=trailing_precision,
            assemble=assemble,
            panel_factorizer=panel_factorizer,
        )
        if not assemble:
            diag, z = out
            return diag[:n], z[:n]
        if rhs is None:
            return out[:n, :n]
        L, z = out
        return L[:n, :n], z[:n]

    if diag_precision == "auto":
        # diag-block refinement is NOT cheap (G²/2 pairs × b³ extra
        # precision work ≈ n²b ≈ the panel work) — off by default,
        # available as a manual escalation knob
        diag_precision = None
    if panel_precision == "auto":
        panel_precision = _auto_panel_precision(n)
    trailing_bf16 = trailing_precision == "bf16"
    diag_prec = _PRECISIONS[diag_precision]
    panel_prec = _PRECISIONS[panel_precision]
    trail_prec = None if trailing_bf16 else _PRECISIONS[trailing_precision]

    # Each list entry holds ONLY the ACTIVE rows k·b..n of column panel k
    # (rows above the diagonal block are the never-read symmetric upper
    # part): a trailing update then OVERWRITES the whole stored array —
    # no dead-prefix carry, no per-update concatenate copy: ~G²/2 · n·b
    # less copy traffic than the full-column layout (the dw variant
    # stores panels the same way).
    G = n // b
    cols = [
        jax.lax.slice(K, (k * b, k * b), (n, (k + 1) * b)) for k in range(G)
    ]
    return _cols_core(
        cols,
        n,
        b,
        rhs,
        panel_sub=panel_sub,
        diag_prec=diag_prec,
        panel_prec=panel_prec,
        trail_prec=trail_prec,
        trailing_bf16=trailing_bf16,
        assemble=assemble,
        panel_factorizer=panel_factorizer,
    )


def blocked_cholesky_cols_fused(
    col_fn,
    n: int,
    rhs: jnp.ndarray | None = None,
    block_size: int | None = None,
    panel_sub: int | str | None = "auto",
    diag_precision: str | None = "auto",
    panel_precision: str | None = "auto",
    trailing_precision: str | None = None,
    assemble: bool = True,
    panel_factorizer: str | None = None,
    dtype=jnp.float32,
):
    """Right-looking cols layout with LAZY gram columns.

    ``col_fn(j0, b)`` builds the active rows j0..n of covariance column
    panel [j0, j0+b) — diagonal terms included.  Column j > 0 is first
    consumed by panel 0's trailing update, so XLA fuses the (elementwise)
    gram producer into that subtraction's epilogue: the N×N covariance
    is never materialized, which lets N grow past the size whose
    materialized covariance fits the device.

    Not jitted itself (``col_fn`` is a closure): call inside jit — the
    GP's log_likelihood routes through a module-level jitted wrapper.
    """
    if not assemble and rhs is None:
        raise ValueError("assemble=False requires rhs (the NLML fused path)")
    b = block_size if block_size is not None else auto_block_size(n)
    if n <= b or n % b != 0:
        K = _materialize_from_cols(col_fn, n, b)
        return blocked_cholesky_cols(
            K,
            rhs=rhs,
            panel_sub=panel_sub,
            diag_precision=None if diag_precision == "auto" else diag_precision,
            panel_precision=panel_precision,
            trailing_precision=trailing_precision,
            assemble=assemble,
            panel_factorizer=panel_factorizer,
        )
    if diag_precision == "auto":
        diag_precision = None
    if panel_precision == "auto":
        panel_precision = _auto_panel_precision(n)
    trailing_bf16 = trailing_precision == "bf16"
    cols = [col_fn(k * b, b) for k in range(n // b)]
    return _cols_core(
        cols,
        n,
        b,
        rhs if rhs is None else jnp.asarray(rhs, dtype),
        panel_sub=panel_sub,
        diag_prec=_PRECISIONS[diag_precision],
        panel_prec=_PRECISIONS[panel_precision],
        trail_prec=None if trailing_bf16 else _PRECISIONS[trailing_precision],
        trailing_bf16=trailing_bf16,
        assemble=assemble,
        panel_factorizer=panel_factorizer,
    )


def _cols_core(
    cols,
    n: int,
    b: int,
    rhs,
    *,
    panel_sub,
    diag_prec,
    panel_prec,
    trail_prec,
    trailing_bf16,
    assemble,
    panel_factorizer,
):
    """Shared right-looking loop over active-row column panels.  ``cols``
    may come from slicing a materialized K (blocked_cholesky_cols) or from
    a lazy column builder (blocked_cholesky_cols_fused)."""
    G = n // b
    z = rhs
    dtype = cols[0].dtype
    for k in range(G):
        k0 = k * b
        col = cols[k]  # (n - k0, b)
        Akk = col[:b]
        sub = DEFAULT_PANEL_SUB if panel_sub == "auto" else panel_sub
        if sub is not None:
            # two-level blocking: GEMM composition of the panel inverse
            Lkk, W = _panel_chol_inverse(
                Akk, sub, precision=panel_prec, factorizer=panel_factorizer
            )
        else:
            Lkk = jnp.linalg.cholesky(Akk)
            W = solve_triangular(Lkk, jnp.eye(b, dtype=dtype), lower=True)
        below = jnp.matmul(
            col[b:], W.T, precision=panel_prec
        )  # (n - k0 - b, b)
        cols[k] = jnp.concatenate([Lkk, below], axis=0)
        if z is not None:
            zk = W @ jax.lax.slice(z, (k0,), (k0 + b,))
            zt = jax.lax.slice(z, (k0 + b,), (n,)) - below @ zk
            z = jnp.concatenate([z[:k0], zk, zt], axis=0)
        # bf16 trailing-input mode: the G−k trailing updates RE-READ this
        # panel from device memory — a 2-byte store halves that traffic.
        # f32-only (a bf16 cast of f64 inputs would be an accuracy cliff,
        # so the knob is ignored there).
        below_t = (
            below.astype(jnp.bfloat16)
            if trailing_bf16 and dtype == jnp.float32
            else below
        )
        for j in range(k + 1, G):
            j0 = j * b
            Lj = below_t[j0 - k0 - b : j0 - k0]  # (b, b): panel rows of j
            Lrows = below_t[j0 - k0 - b :]  # rows j0.. of column k
            if diag_prec is not None and trail_prec is None:
                # rows of block j's future diagonal block: multi-pass GEMM
                # (on the full-precision panel, even under bf16 trailing)
                # so the Cholesky input stays PSD; bulk stays single-pass
                Ljf = below[j0 - k0 - b : j0 - k0]
                upd_diag = cols[j][:b] - jnp.matmul(
                    Ljf, Ljf.T, precision=diag_prec
                )
                upd_rest = cols[j][b:] - jnp.matmul(
                    Lrows[b:],
                    Lj.T,
                    preferred_element_type=dtype,
                )
                cols[j] = jnp.concatenate([upd_diag, upd_rest], axis=0)
            else:
                cols[j] = cols[j] - jnp.matmul(
                    Lrows,
                    Lj.T,
                    precision=trail_prec,
                    preferred_element_type=dtype,
                )
    if not assemble:
        diag = jnp.concatenate(
            [jnp.diagonal(cols[k][:b]) for k in range(G)]
        )
        return diag, z
    L = jnp.tril(
        jnp.concatenate(
            [
                jnp.concatenate(
                    [jnp.zeros((k * b, b), dtype=dtype), cols[k]], axis=0
                )
                for k in range(G)
            ],
            axis=1,
        )
    )
    return L if rhs is None else (L, z)


@functools.partial(
    jax.jit,
    static_argnames=(
        "block_size",
        "panel_precision",
        "trailing_precision",
        "panel_factorizer",
    ),
)
def left_nlml_from_K(
    K: jnp.ndarray,
    rhs: jnp.ndarray,
    block_size: int | None = None,
    panel_precision: str | None = "auto",
    trailing_precision: str | None = None,
    panel_factorizer: str | None = None,
):
    """(diag_L, L⁻¹ rhs) via the left-looking loop on a materialized K.

    Jitted wrapper so an EAGER caller dispatches ONE program instead of the
    unrolled ~G²/2-op panel loop one op at a time.  Inside an enclosing jit
    it simply inlines.
    """
    n = K.shape[0]

    def col_fn(j0, b):
        return jax.lax.slice(K, (j0, j0), (n, j0 + b))

    return blocked_cholesky_left(
        col_fn,
        n,
        rhs=rhs,
        assemble=False,
        dtype=K.dtype,
        block_size=block_size,
        panel_precision=panel_precision,
        trailing_precision=trailing_precision,
        panel_factorizer=panel_factorizer,
    )
