"""Double-word (two-float) compensated arithmetic for f32 pipelines.

1e-6-relative NLML parity with the reference's Eigen f64 LDLT
(serializable_ldlt.hpp:19-80) from an f32 pipeline cannot come from a
wider dtype.  This module supplies the classical error-free
transformations (Knuth two_sum, Dekker/Veltkamp two_prod) and builds the
three pieces the NLML accuracy study (CLAUDE.md #3) identified as the f32
error floor:

* ``dw_sum``     — pairwise double-word reduction (eps²-accurate sums);
* ``dot2``       — Ogita–Rump–Oishi compensated dot product;
* ``compensated_nll`` — the NLML with (a) the quadratic term yᵀK⁻¹y
  refined by ONE iterative-refinement step (residual at matmul
  precision=HIGHEST — forward error drops from κ·eps to ~c·eps, Higham
  ASNA² §12), (b) the log-det sum and all reductions in double-word, and
  (c) the final term combination in double-word (the three O(N)-magnitude
  terms partially cancel).

Everything is pure elementwise/log-depth XLA — no scans, no dynamic
shapes; the extra cost is O(N²) (one HIGHEST-precision mat-vec + two
triangular solves) on top of the O(N³) pipeline.

Numerical contract of the primitives (valid when no overflow occurs):
    two_sum:  a + b = s + e exactly;
    two_prod: a * b = p + e exactly (Veltkamp split, no FMA needed —
              XLA does not expose one portably).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp


def two_sum(a, b):
    """Error-free sum: returns (s, e) with a + b = s + e exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _splitter(dtype):
    # 2^ceil(p/2) + 1 for a p-bit mantissa: f32 p=24 -> 4097, f64 p=53.
    if dtype == jnp.float64:
        return 134217729.0
    return 4097.0


def veltkamp_split(a):
    """a = hi + lo with hi, lo representable in half the mantissa."""
    c = _splitter(a.dtype) * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: returns (p, e) with a * b = p + e exactly."""
    p = a * b
    ah, al = veltkamp_split(a)
    bh, bl = veltkamp_split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def dw_add(xh, xl, yh, yl):
    """Double-word + double-word (accurate variant)."""
    sh, sl = two_sum(xh, yh)
    th, tl = two_sum(xl, yl)
    c = sl + th
    vh, vl = two_sum(sh, c)
    w = tl + vl
    zh, zl = two_sum(vh, w)
    return zh, zl


def dw_sum(hi, lo=None, axis: int = -1):
    """Pairwise double-word sum along ``axis``: returns scalar-per-slice
    (hi, lo).  Log-depth tree of vectorized two_sums — error O(eps²)."""
    hi = jnp.moveaxis(jnp.asarray(hi), axis, -1)
    if lo is None:
        lo = jnp.zeros_like(hi)
    else:
        lo = jnp.moveaxis(jnp.asarray(lo), axis, -1)
    n = hi.shape[-1]
    # pad once to the next power of two (zeros are exact under two_sum)
    npad = 1 << max(0, math.ceil(math.log2(n))) if n > 1 else 1
    if npad != n:
        pad = [(0, 0)] * (hi.ndim - 1) + [(0, npad - n)]
        hi = jnp.pad(hi, pad)
        lo = jnp.pad(lo, pad)
        n = npad
    while n > 1:
        half = n // 2
        s, e = two_sum(hi[..., :half], hi[..., half:])
        lo = lo[..., :half] + lo[..., half:] + e
        hi = s
        n = half
    return hi[..., 0], lo[..., 0]


def dot2(x, y):
    """Compensated dot product (Ogita–Rump–Oishi Dot2): error ~ eps +
    cond·eps², i.e. f64-quality for f32 inputs.  Returns (hi, lo)."""
    p, e = two_prod(x, y)
    return dw_sum(p, e)


LN2_HI = 0.6931471824645996  # float32(ln 2)
LN2_LO = float(math.log(2.0) - LN2_HI)  # remainder, |.| < 2^-25


@jax.custom_jvp
def accurate_log(x):
    """Correctly-rounded-class f32 natural log as a double word (hi, lo).

    WHY: a device's builtin f32 ``log`` may be an approximation whose
    per-element error is biased, and a biased error does not cancel over
    the N elements of a log-determinant.  No precision knob touches
    transcendental accuracy, so we compute the log ourselves:

      x = 2^e · m  (exact bitwise reduction, m scaled into [√½, √2)),
      ln m = 2·atanh(s),  s = (m−1)/(m+1)  (|s| ≤ 0.1716),

    with the atanh series in f32 (truncation < 1e-9) and the e·ln2 term
    carried in double-word.  Elementwise work — negligible for the (n,)
    diagonals it serves.  Positive finite inputs only.
    """
    x = jnp.asarray(x, jnp.float32)
    bits = jax.lax.bitcast_convert_type(x, jnp.int32)
    e = ((bits >> 23) & 0xFF) - 127
    m = jax.lax.bitcast_convert_type(
        (bits & 0x007FFFFF) | (127 << 23), jnp.float32
    )  # [1, 2), exact
    big = m > 1.4142135
    m = jnp.where(big, 0.5 * m, m)  # exact (power-of-two scale)
    e = (e + big.astype(e.dtype)).astype(jnp.float32)
    s = (m - 1.0) / (m + 1.0)  # m-1 exact in this range; one rounding
    s2 = s * s
    # ln m = 2s·(1 + s²/3 + s⁴/5 + s⁶/7 + s⁸/9 + s¹⁰/11)
    poly = 1.0 + s2 * (
        1.0 / 3.0
        + s2 * (0.2 + s2 * (1.0 / 7.0 + s2 * (1.0 / 9.0 + s2 / 11.0)))
    )
    ln_m = (2.0 * s) * poly
    # e·ln2 in double-word (two_prod: exact even when e·LN2_HI needs >24 bits)
    ph, pe = two_prod(e, jnp.float32(LN2_HI))
    h, t = two_sum(ph, ln_m)
    return h, t + pe + e * LN2_LO


@accurate_log.defjvp
def _accurate_log_jvp(primals, tangents):
    # the bitwise reduction has no autodiff rule; d log(x) = dx / x
    (x,), (dx,) = primals, tangents
    h, l = accurate_log(x)
    return (h, l), (dx / jnp.asarray(x, jnp.float32), jnp.zeros_like(h))


def _log_validity(x):
    """True where accurate_log's bitwise reduction is meaningful: positive
    finite normal f32.  Everything else (0, negatives, NaN, inf,
    subnormals) must take the builtin log's domain semantics."""
    return jnp.isfinite(x) & (x >= jnp.finfo(jnp.float32).tiny)


def accurate_log_guarded(x):
    """accurate_log with the builtin's domain semantics restored.

    The bitwise reduction is only meaningful for positive finite NORMAL
    f32 inputs; for everything else (0 → -inf, negative → NaN, NaN → NaN,
    inf → inf, subnormal → builtin value) fall back to ``jnp.log`` so a
    failed factorization or negative variance still surfaces as
    -inf/NaN instead of a finite wrong log-det (the surface-as-NaN
    policy, models/gp.py)."""
    x = jnp.asarray(x, jnp.float32)
    h, l = accurate_log(x)
    valid = _log_validity(x)
    return jnp.where(valid, h, jnp.log(x)), jnp.where(valid, l, 0.0)


def _guarded_log_terms(flat):
    """Split Σ log over ``flat`` into a double-word part over the valid
    entries plus a builtin-log sum over the invalid ones.  Invalid entries
    CANNOT ride the dw reduction (two_sum of ±inf/NaN yields NaN even when
    the IEEE answer is -inf), so they are summed with plain addition, which
    keeps exact -inf/NaN propagation — for f64 exactly as for f32 (the f64
    per-element log is the builtin either way; only the f32 path routes
    through accurate_log)."""
    f32 = flat.dtype == jnp.float32
    valid = jnp.isfinite(flat) & (flat >= jnp.finfo(flat.dtype).tiny)
    safe = jnp.where(valid, flat, jnp.ones((), flat.dtype))
    if f32:
        h, l = accurate_log(safe)
        h = jnp.where(valid, h, 0.0)
        l = jnp.where(valid, l, 0.0)
    else:
        h = jnp.where(valid, jnp.log(safe), 0.0)
        l = None
    bad = jnp.sum(jnp.where(valid, jnp.zeros((), flat.dtype), jnp.log(flat)))
    return h, l, bad


def dw_log_determinant(L) -> tuple[jax.Array, jax.Array]:
    """2 Σ log diag(L): accurate per-element logs + double-word reduction
    (see ``accurate_log``); f64 inputs keep the builtin log."""
    diag = jnp.diagonal(L)
    lh, ll, bad = _guarded_log_terms(diag)
    h, l = dw_sum(lh, ll)
    h = h + bad  # exact -inf/NaN propagation for invalid diagonals
    return 2.0 * h, 2.0 * l


def dw_matvec(K, v, chunk: int = 1024) -> tuple[jax.Array, jax.Array]:
    """K @ v with error-free elementwise products and double-word row sums
    — the f32 analog of an f64 mat-vec (error O(eps²·cond)).

    Rows are processed in ``chunk``-sized blocks under lax.map so the
    splitting temporaries stay O(chunk·N) instead of O(N²)."""
    n = K.shape[0]
    if n % chunk != 0:
        chunk = n  # single block; fine for the sizes where n is odd-shaped

    def block(Kb):
        p, e = two_prod(Kb, v[None, :])
        return dw_sum(p, e, axis=1)

    if chunk == n:
        return block(K)
    hh, hl = jax.lax.map(block, K.reshape(n // chunk, chunk, n))
    return hh.reshape(n), hl.reshape(n)


def accurate_sum_of_logs(x, where=None):
    """Σ log xᵢ over ALL elements of ``x``: sub-ulp per-element logs in
    f32 (``accurate_log``) plus a double-word reduction.  Entries where ``where`` is False
    contribute exactly 0 (replaced by 1 before the log, which
    ``accurate_log`` maps to an exact (0, 0)).  Differentiable: the
    custom JVP routes d log x = dx/x, and masked entries get zero
    cotangent through the ``where``.  Serves every log-det site —
    single-chip, blocked, batched-block-diagonal and shard_map-local
    (pure elementwise + log-depth reduction, collective-free)."""
    x = jnp.asarray(x)
    flat = x.reshape(-1)
    if where is not None:
        flat = jnp.where(
            jnp.asarray(where).reshape(-1), flat, jnp.ones((), flat.dtype)
        )
    h, l, bad = _guarded_log_terms(flat)
    sh, sl = dw_sum(h, l)
    return sh + sl + bad


def refined_quadratic(
    chol, K, y, refine_steps: int = 2
) -> tuple[jax.Array, jax.Array]:
    """yᵀK⁻¹y as a double word, via iterative refinement with a
    DOUBLE-WORD residual.

    α = fl(K⁻¹y) carries forward error ~ κ(K)·eps.  A residual computed in
    working precision is pure noise once ‖r‖ ~ eps·‖K‖‖α‖ (measured: rel
    error ≥ 1 at N=4096) — refinement only converges when r = y − Kα is
    formed beyond working precision, so the mat-vec runs through dw_matvec
    (error-free products + compensated row sums).  Each step contracts the
    forward error by ~κ·eps; two steps take κ ≤ 1e5 from κ·eps ≈ 5e-3 to
    ≈ 1e-7 relative.  The final dot products are compensated (dot2) so the
    reduction adds nothing on top."""
    alpha = chol.solve(y)
    qh, ql = dot2(y, alpha)
    corr = jnp.zeros_like(qh)
    for _ in range(refine_steps):
        kh, kl = dw_matvec(K, alpha)
        rh, re = two_sum(y, -kh)
        r = rh + (re - kl)  # single word suffices: δ needs leading bits only
        delta = chol.solve(r)
        alpha = alpha + delta
        # q += yᵀδ: the update is O(κ·eps)·q, so a plain f32 dot of the
        # small correction suffices
        corr = corr + jnp.dot(y, delta)
    return two_sum(qh, ql + corr)


# Dot precision whose f32 products are exact, leaving only f32
# accumulation rounding: full FP32 on the GPU (the default and HIGH may run
# in TF32, which keeps ~10 mantissa bits), plain f32/f64 on the CPU.
EXACT_PRODUCT_PRECISION = jax.lax.Precision.HIGHEST


@functools.partial(
    jax.jit, static_argnames=("block_size", "precision", "assemble")
)
def blocked_cholesky_dw(
    K: jnp.ndarray,
    block_size: int | None = None,
    rhs: jnp.ndarray | None = None,
    precision=None,
    assemble: bool = True,
):
    """Maximum-fidelity f32 blocked Cholesky: double-word-carry trailing
    matrix + exact-product GEMMs.

    Two error sources separate the plain blocked factorization from an f64
    oracle, and this kills both:

    * **Trailing storage rounding**: each update ``T -= L_k L_kᵀ`` rounds
      every trailing entry to f32, accumulating over G panels.  Here the
      trailing matrix is carried as an unevaluated (hi, lo) pair — the
      subtraction runs through an error-free two_sum, the remainder
      accumulates in ``lo``, and each panel folds its carry back in before
      factorizing, so every panel input is a SINGLE rounding from exact.
      (Measured on CPU at N=8192/b=2048 this term alone is ~1e-8 relative
      in the log-det.)
    * **GEMM product rounding**: reduced-precision products (TF32) carry
      ~2⁻¹¹ relative error each.  The trailing/panel GEMMs here default to
      ``EXACT_PRODUCT_PRECISION`` (exact f32 products).

    Cost: one extra n²/2 buffer, G elementwise two_sum passes (O(n²)), and
    full-FP32 instead of TF32 GEMMs.  Enable via
    ``config.CHOLESKY_PRECISION = "double_word"`` (usually together with
    ``config.NLML_COMPENSATED = True`` so the quadratic term is refined
    too).  Reference capability matched: Eigen's f64 LDLT robustness
    (serializable_ldlt.hpp:19-80) from f32 arithmetic.
    """
    from jax.scipy.linalg import solve_triangular

    from .blocked_cholesky import (
        DEFAULT_PANEL_SUB,
        auto_block_size,
        blocked_tri_inverse,
    )

    K = jnp.asarray(K)
    n_orig = K.shape[0]
    n = n_orig
    HI = precision if precision is not None else EXACT_PRODUCT_PRECISION
    b = block_size if block_size is not None else auto_block_size(n)
    if assemble is False and rhs is None:
        raise ValueError("assemble=False requires rhs (the NLML fused path)")
    if n <= b:
        L = jnp.linalg.cholesky(K)
        z0 = (
            None
            if rhs is None
            else solve_triangular(L, rhs[:, None], lower=True)[:, 0]
        )
        if not assemble:
            return jnp.diagonal(L), z0
        return L if rhs is None else (L, z0)
    if n % b != 0:
        # pad-and-mask so the dw fast path is TOTAL for every N: extend to
        # the next panel boundary with an identity block (chol of
        # blkdiag(K, I) is blkdiag(L, I) exactly), factor, slice back
        m = -(-n // b) * b
        pad = m - n
        K = jnp.pad(K, ((0, pad), (0, pad)))
        K = K.at[jnp.arange(n, m), jnp.arange(n, m)].set(1.0)
        if rhs is not None:
            rhs = jnp.pad(rhs, (0, pad))
        n = m

    G = n // b
    # cols_hi[j] / cols_lo[j] hold only the ACTIVE trailing rows j·b..n of
    # column panel j, as an unevaluated hi+lo sum
    cols_hi = [
        jax.lax.slice(K, (k * b, k * b), (n, (k + 1) * b)) for k in range(G)
    ]
    cols_lo = [jnp.zeros_like(c) for c in cols_hi]
    z = rhs
    out_cols = []
    diag_parts = []
    for k in range(G):
        k0 = k * b
        # fold the carry: the panel's input is now one rounding from exact
        ph, _ = two_sum(cols_hi[k], cols_lo[k])  # (n - k0, b)
        Lkk = jnp.linalg.cholesky(ph[:b])
        # panel columns via the GEMM-composed inverse so the products run
        # at the controlled precision (TriangularSolve's internal matmul
        # precision is backend-defined)
        W = blocked_tri_inverse(Lkk, DEFAULT_PANEL_SUB, precision=HI)
        below = jnp.matmul(ph[b:], W.T, precision=HI)  # (n-k0-b, b)
        if assemble:
            out_cols.append(
                jnp.concatenate(
                    [jnp.zeros((k0, b), K.dtype), Lkk, below], axis=0
                )
            )
        else:
            diag_parts.append(jnp.diagonal(Lkk))
        if z is not None:
            zk = jnp.matmul(
                W, jax.lax.slice(z, (k0,), (k0 + b,)), precision=HI
            )
            zt = jax.lax.slice(z, (k0 + b,), (n,)) - jnp.matmul(
                below, zk, precision=HI
            )
            z = jnp.concatenate([z[:k0], zk, zt], axis=0)
        for j in range(k + 1, G):
            j0 = j * b
            Lj = below[j0 - k0 - b : j0 - k0]  # (b, b)
            Lrows = below[j0 - k0 - b :]  # rows j0.. of column k's factor
            P = jnp.matmul(Lrows, Lj.T, precision=HI)  # (n - j0, b)
            s, e = two_sum(cols_hi[j], -P)
            cols_hi[j] = s
            cols_lo[j] = cols_lo[j] + e
    if not assemble:
        # the NLML consumes only diag(L) + the whitened vector — skip the
        # O(N²) column assembly entirely (mirrors blocked_cholesky_cols)
        return (
            jnp.concatenate(diag_parts)[:n_orig],
            None if z is None else z[:n_orig],
        )
    L = jnp.tril(jnp.concatenate(out_cols, axis=1))[:n_orig, :n_orig]
    return L if rhs is None else (L, z[:n_orig])


LOG_2PI = math.log(2.0 * math.pi)


def compensated_nll_dw(chol, K, y) -> tuple[jax.Array, jax.Array]:
    """½(log|K| + yᵀK⁻¹y + n log 2π) as an unevaluated double word.

    ``K`` must be the exact matrix that was factorized into ``chol``
    (including any jitter / target variance on the diagonal).  The three
    O(N)-magnitude terms are combined in double-word so their
    cancellation does not reintroduce f32 error.  Returning (hi, lo)
    matters for measurement: a single-f32 return caps the observable
    accuracy at one output ulp (~8e-8 relative at |NLML|~7000), while the
    internal accuracy is below it.  Combine hi+lo in f64 on the host to
    see it.
    """
    import numpy as np

    n = y.shape[0]
    ldh, ldl = dw_log_determinant(chol.L)
    qh, ql = refined_quadratic(chol, K, y)
    # n·log2π in double-word, split statically (n and the constant are
    # python-level, so no precision is lost before the dw combine)
    dtype = y.dtype
    np_dtype = np.float32 if dtype == jnp.float32 else np.float64
    prod = float(n) * LOG_2PI  # exact in python f64 for any realistic n
    nh = float(np_dtype(prod))
    nl = prod - nh
    sh, sl = dw_add(ldh, ldl, qh, ql)
    sh, sl = dw_add(sh, sl, jnp.asarray(nh, dtype), jnp.asarray(nl, dtype))
    return 0.5 * sh, 0.5 * sl


def compensated_nll(chol, K, y) -> jax.Array:
    """Single-word ½(log|K| + yᵀK⁻¹y + n log 2π); see compensated_nll_dw."""
    h, l = compensated_nll_dw(chol, K, y)
    return h + l
