"""Dense factorizations and solve helpers.

JAX replacement for the reference's Eigen LDLT machinery
(/root/reference/include/albatross/src/eigen/serializable_ldlt.hpp:19-217).

The reference relies on pivoted LDLT for robustness; here the
factorization is a blocked, GEMM-rich Cholesky (ops/blocked_cholesky.py)
combined with an explicit jitter/nugget policy for conditioning.  ``CholeskyFactor`` exposes the same
capability surface as ``SerializableLDLT``: solve, sqrt_solve, log-det,
inverse diagonal and per-group inverse blocks (the engine of fast LOO/LOGO
cross-validation).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular


def _sum_of_logs(diag: jnp.ndarray) -> jnp.ndarray:
    """2 Σ log dᵢ for a Cholesky diagonal.

    In f32 this routes through ops.compensated.accurate_log, a sub-ulp log
    whose error cannot bias the N-term sum the way an approximate builtin
    log can.  It is a handful of elementwise ops on an (n,) vector — free
    next to the O(n³) factorization — so the fast path gets it too, not
    just the compensated mode."""
    from .compensated import accurate_sum_of_logs

    return 2.0 * accurate_sum_of_logs(diag)


def _sym(K: jnp.ndarray) -> jnp.ndarray:
    return 0.5 * (K + K.T)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class CholeskyFactor:
    """Lower-triangular Cholesky factor of an SPD matrix."""

    L: jax.Array

    def tree_flatten(self):
        return (self.L,), None

    @classmethod
    def tree_unflatten(cls, _, children):
        return cls(children[0])

    @staticmethod
    def _factor_core(K, jitter, rhs, assume_symmetric=False):
        """Shared factorization core for factorize/factorize_whiten: one
        place owns the symmetrize/jitter policy, the blocked-vs-builtin
        size threshold, and the layout choice, so the fused-NLML path can
        never factorize a different matrix than the fit path.

        ``assume_symmetric`` skips the 0.5(K+Kᵀ) pass — an N² memory round
        trip — for inputs already bitwise symmetric (covariances from
        CovarianceFunction.__call__, which symmetrizes unless the kernel is
        symmetric-exact by construction)."""
        K = jnp.asarray(K)
        if not assume_symmetric:
            K = _sym(K)
        if jitter:
            K = K + jitter * jnp.eye(K.shape[0], dtype=K.dtype)
        if K.shape[0] > 2048:
            # GEMM-rich blocked factorization, column-panel layout (pads
            # non-divisible N to the panel boundary; ops/blocked_cholesky.py)
            from .. import config
            from .blocked_cholesky import blocked_cholesky_cols

            if config.CHOLESKY_PRECISION == "double_word":
                # maximum-fidelity mode: double-word-carry trailing matrix
                # + exact-product GEMMs (ops/compensated.py)
                from .compensated import blocked_cholesky_dw

                return blocked_cholesky_dw(K, rhs=rhs)
            pf = config.PANEL_FACTORIZER
            if config.CHOLESKY_PRECISION is not None:
                # accuracy mode: multi-pass on every factorization GEMM
                return blocked_cholesky_cols(
                    K,
                    rhs=rhs,
                    block_size=config.CHOLESKY_BLOCK_SIZE,
                    panel_precision=config.CHOLESKY_PRECISION,
                    trailing_precision=config.CHOLESKY_PRECISION,
                    panel_factorizer=pf,
                )
            return blocked_cholesky_cols(
                K,
                rhs=rhs,
                block_size=config.CHOLESKY_BLOCK_SIZE,
                panel_factorizer=pf,
                trailing_precision="bf16"
                if config.CHOLESKY_TRAILING_BF16
                else None,
            )
        L = jnp.linalg.cholesky(K)
        if rhs is None:
            return L
        return L, solve_triangular(L, rhs[:, None], lower=True)[:, 0]

    @classmethod
    def factorize(
        cls, K: jnp.ndarray, jitter: float = 0.0, assume_symmetric: bool = False
    ) -> "CholeskyFactor":
        return cls(cls._factor_core(K, jitter, None, assume_symmetric))

    @classmethod
    def factorize_whiten(
        cls,
        K: jnp.ndarray,
        rhs: jnp.ndarray,
        jitter: float = 0.0,
        assume_symmetric: bool = False,
    ) -> tuple["CholeskyFactor", jnp.ndarray]:
        """Factorize K and return (factor, L⁻¹ rhs) in one pass.

        ``rhs`` must be a 1-D (n,) vector.  For large N the whitening rides
        the blocked factorization (the panel inverses are reused for
        forward substitution), avoiding a separate full-size single-RHS
        triangular solve — a latency-bound step in NLML evaluation
        (likelihood.hpp:38-47 computes the same quantities as two stages).
        """
        rhs = jnp.asarray(rhs)
        if rhs.ndim != 1:
            raise ValueError(
                f"factorize_whiten expects a 1-D rhs, got shape {rhs.shape};"
                " use factorize(...).sqrt_solve for matrix right-hand sides"
            )
        K = jnp.asarray(K)
        L, white = cls._factor_core(
            K, jitter, rhs.astype(K.dtype), assume_symmetric
        )
        return cls(L), white

    @classmethod
    def nlml_terms(
        cls,
        K: jnp.ndarray,
        rhs: jnp.ndarray,
        jitter: float = 0.0,
        assume_symmetric: bool = False,
        col_fn=None,
    ) -> tuple[jnp.ndarray, jnp.ndarray]:
        """(log|K|, L⁻¹ rhs) WITHOUT materializing the factor at scale.

        The NLML consumes only the log-determinant and the whitened vector;
        for large N the blocked path keeps the factor as column panels and
        skips the final (n, n) assembly + tril — an O(N²) memory round trip
        saved on the hyperparameter-optimization hot loop.  Semantically
        identical to ``factorize_whiten`` + ``log_determinant``.

        ``col_fn(j0, b)`` (optional): active-row column-panel builder for
        the left-looking algorithm (config.CHOLESKY_ALGORITHM="left") —
        lets the gram fuse into the factorization GEMMs so the N² matrix
        never gets its own memory write.  Must already include every
        diagonal term; ``K``/``jitter`` are ignored when it engages.
        """
        rhs = jnp.asarray(rhs)
        if rhs.ndim != 1:
            raise ValueError(
                f"nlml_terms expects a 1-D rhs, got shape {rhs.shape}"
            )
        from .. import config as _config

        n = rhs.shape[0]
        if col_fn is not None and _config.CHOLESKY_PRECISION == "double_word":
            raise ValueError(
                "nlml_terms(col_fn=...) is incompatible with "
                "CHOLESKY_PRECISION='double_word' (the double-word carry "
                "needs the materialized matrix); pass K instead"
            )
        use_fused = col_fn is not None or (
            _config.CHOLESKY_ALGORITHM == "left"
            and n > 2048
            and _config.CHOLESKY_PRECISION != "double_word"
        )
        if use_fused:
            kw = {}
            if _config.CHOLESKY_PRECISION is not None:
                kw = dict(
                    panel_precision=_config.CHOLESKY_PRECISION,
                    trailing_precision=_config.CHOLESKY_PRECISION,
                )
            elif _config.CHOLESKY_TRAILING_BF16:
                kw = dict(trailing_precision="bf16")
            if col_fn is None:
                # materialized-K left-looking: route through the module
                # jitted wrapper so an eager caller gets ONE dispatch
                # instead of the unrolled panel loop
                from .blocked_cholesky import left_nlml_from_K

                K = jnp.asarray(K)
                if not assume_symmetric:
                    K = _sym(K)
                if jitter:
                    K = K + jitter * jnp.eye(n, dtype=K.dtype)
                diag, white = left_nlml_from_K(
                    K,
                    rhs.astype(K.dtype),
                    block_size=_config.CHOLESKY_BLOCK_SIZE,
                    panel_factorizer=_config.PANEL_FACTORIZER,
                    **kw,
                )
                return _sum_of_logs(diag), white
            # explicit column builder: honor the configured loop order —
            # "left" = one big GEMM per panel; anything else = the
            # right-looking cols loop with lazy gram columns.  col_fn is a
            # closure, so these run
            # un-jitted — call nlml_terms(col_fn=...) inside jit (the GP's
            # log_likelihood routes through its own jitted wrapper).
            if _config.CHOLESKY_ALGORITHM == "left":
                from .blocked_cholesky import blocked_cholesky_left

                diag, white = blocked_cholesky_left(
                    col_fn,
                    n,
                    rhs=rhs,
                    assemble=False,
                    dtype=rhs.dtype,
                    block_size=_config.CHOLESKY_BLOCK_SIZE,
                    panel_factorizer=_config.PANEL_FACTORIZER,
                    **kw,
                )
            else:
                from .blocked_cholesky import blocked_cholesky_cols_fused

                diag, white = blocked_cholesky_cols_fused(
                    col_fn,
                    n,
                    rhs=rhs,
                    assemble=False,
                    dtype=rhs.dtype,
                    block_size=_config.CHOLESKY_BLOCK_SIZE,
                    panel_factorizer=_config.PANEL_FACTORIZER,
                    **kw,
                )
            return _sum_of_logs(diag), white
        K = jnp.asarray(K)
        if not assume_symmetric:
            K = _sym(K)
        if jitter:
            K = K + jitter * jnp.eye(K.shape[0], dtype=K.dtype)
        if K.shape[0] > 2048:
            from .. import config
            from .blocked_cholesky import blocked_cholesky_cols

            if config.CHOLESKY_PRECISION == "double_word":
                from .compensated import (
                    accurate_sum_of_logs,
                    blocked_cholesky_dw,
                )

                diag, white = blocked_cholesky_dw(
                    K, rhs=rhs.astype(K.dtype), assemble=False
                )
                return 2.0 * accurate_sum_of_logs(diag), white
            kw = {}
            if config.CHOLESKY_PRECISION is not None:
                kw = dict(
                    panel_precision=config.CHOLESKY_PRECISION,
                    trailing_precision=config.CHOLESKY_PRECISION,
                )
            elif config.CHOLESKY_TRAILING_BF16:
                kw = dict(trailing_precision="bf16")
            diag, white = blocked_cholesky_cols(
                K,
                rhs=rhs.astype(K.dtype),
                assemble=False,
                block_size=config.CHOLESKY_BLOCK_SIZE,
                panel_factorizer=config.PANEL_FACTORIZER,
                **kw,
            )
            return _sum_of_logs(diag), white
        L = jnp.linalg.cholesky(K)
        white = solve_triangular(L, rhs[:, None], lower=True)[:, 0]
        return _sum_of_logs(jnp.diagonal(L)), white

    @classmethod
    def factorize_safe(
        cls,
        K: jnp.ndarray,
        initial_jitter: float = 0.0,
        max_tries: int = 6,
        jitter_growth: float = 100.0,
    ) -> "CholeskyFactor":
        """Factorize with automatic jitter escalation (traceable).

        The numerical analog of the reference's nugget-inflation safeguards
        (sparse_gp.hpp:348-352) generalized to any SPD factorization: if the
        Cholesky produces non-finite diagonals, retry with jitter escalated
        ×jitter_growth, up to max_tries.  One factorization in the common
        case; the loop re-runs only on failure.
        """
        K = _sym(jnp.asarray(K))
        n = K.shape[0]
        eye = jnp.eye(n, dtype=K.dtype)
        base = jnp.asarray(
            initial_jitter
            if initial_jitter > 0
            else float(jnp.finfo(K.dtype).eps),
            dtype=K.dtype,
        )

        # Phase 1: find the needed jitter level under stop_gradient.  The
        # while_loop is not reverse-differentiable, but with gradients
        # stopped it is a constant computation, so phase 2's single
        # factorization carries the exact NLML gradients.
        K_const = jax.lax.stop_gradient(K)

        def attempt_ok(jitter, use_jitter):
            L = jnp.linalg.cholesky(
                K_const + jnp.where(use_jitter, jitter, 0.0) * eye
            )
            return jnp.all(jnp.isfinite(jnp.diagonal(L)))

        def cond(state):
            ok, tries, _ = state
            return (~ok) & (tries < max_tries)

        def body(state):
            _, tries, jitter = state
            next_jitter = jnp.where(tries == 0, jitter, jitter * jitter_growth)
            return attempt_ok(next_jitter, True), tries + 1, next_jitter

        ok0 = attempt_ok(base, initial_jitter > 0)
        ok, tries, jitter = jax.lax.while_loop(
            cond, body, (ok0, jnp.asarray(0), base)
        )
        applied = jnp.where(
            (tries > 0) | (initial_jitter > 0), jitter, 0.0
        )
        # Phase 2: one differentiable factorization at the chosen jitter.
        L = jnp.linalg.cholesky(K + applied * eye)
        return cls(L)

    @property
    def shape(self):
        return self.L.shape

    @property
    def dtype(self):
        return self.L.dtype

    # -- solves (serializable_ldlt.hpp solve/sqrt_solve family) -------------
    def solve(self, rhs: jnp.ndarray) -> jnp.ndarray:
        """A⁻¹ rhs via two triangular solves."""
        rhs2d = rhs if rhs.ndim > 1 else rhs[:, None]
        y = solve_triangular(self.L, rhs2d, lower=True)
        x = solve_triangular(self.L.T, y, lower=False)
        return x if rhs.ndim > 1 else x[:, 0]

    def sqrt_solve(self, rhs: jnp.ndarray) -> jnp.ndarray:
        """L⁻¹ rhs — whitening transform; ‖sqrt_solve(r)‖² = rᵀA⁻¹r."""
        rhs2d = rhs if rhs.ndim > 1 else rhs[:, None]
        y = solve_triangular(self.L, rhs2d, lower=True)
        return y if rhs.ndim > 1 else y[:, 0]

    def sqrt_transpose_solve(self, rhs: jnp.ndarray) -> jnp.ndarray:
        """L⁻ᵀ rhs."""
        rhs2d = rhs if rhs.ndim > 1 else rhs[:, None]
        y = solve_triangular(self.L.T, rhs2d, lower=False)
        return y if rhs.ndim > 1 else y[:, 0]

    def sqrt_product(self, rhs: jnp.ndarray) -> jnp.ndarray:
        """Lᵀ rhs (serializable_ldlt.hpp sqrt_product)."""
        return self.L.T @ rhs

    def matmul(self, rhs: jnp.ndarray) -> jnp.ndarray:
        """A rhs = L Lᵀ rhs."""
        return self.L @ (self.L.T @ rhs)

    # -- scalars ------------------------------------------------------------
    def log_determinant(self) -> jnp.ndarray:
        return _sum_of_logs(jnp.diagonal(self.L))

    def is_positive_definite(self) -> jnp.ndarray:
        return jnp.all(jnp.isfinite(jnp.diagonal(self.L))) & jnp.all(
            jnp.diagonal(self.L) > 0
        )

    def to_direct_inverse(self, refine_steps: int = 2) -> "DirectInverse":
        """Serving-mode representation: one O(N³) explicit inverse up front,
        then every solve is a GEMM instead of two bandwidth-
        bound triangular solves (the reference's DirectInverse covariance
        representation, representations.hpp:85-101).

        ``refine_steps`` Newton–Schulz iterations X ← X + X(I − A X) at
        precision=HIGHEST polish the inverse: the triangular solves that
        build it may run their internal matmuls at reduced precision, and
        for ill-conditioned K a raw inverse yields predictive variances off
        by O(1e-2) — even negative.  Each step squares the residual
        max|I−AX| until the precision floor, at one-time construction
        cost.
        """
        X = self.inverse()
        n = X.shape[0]
        if refine_steps:
            A = jnp.matmul(
                self.L, self.L.T, precision=jax.lax.Precision.HIGHEST
            )
            eye = jnp.eye(n, dtype=X.dtype)
            for _ in range(refine_steps):
                R = eye - jnp.matmul(
                    A, X, precision=jax.lax.Precision.HIGHEST
                )
                # Newton–Schulz contracts only while ||I−AX||₂ < 1; for very
                # ill-conditioned K a reduced-precision starting inverse can sit
                # outside the basin, where the step would *square the error
                # up*.  Gate on max|R| — not a proof of contraction (the
                # spectral norm can exceed max-abs), but it stops the
                # catastrophic regime (entries ≥ 1) while permitting the
                # measured-good residuals (~5e-2 at N=8192, kappa~1e6); a
                # Frobenius gate would falsely reject those.  Skipped steps
                # degrade to the unrefined inverse instead of diverging.
                contracting = jnp.max(jnp.abs(R)) < 1.0
                X = jnp.where(
                    contracting,
                    X + jnp.matmul(X, R, precision=jax.lax.Precision.HIGHEST),
                    X,
                )
            X = 0.5 * (X + X.T)
        return DirectInverse(X)

    # -- inverse pieces (engine of fast LOO/LOGO CV) ------------------------
    def _tri_inverse(self) -> jnp.ndarray:
        """L⁻¹ — GEMM-composed for large N (XLA's TriangularSolve against
        an identity is latency-bound; see ops/nlml.py)."""
        from .nlml import tri_inverse_full

        return tri_inverse_full(self.L)

    def inverse(self) -> jnp.ndarray:
        """A⁻¹ = L⁻ᵀL⁻¹, potri-style: blocked triangular inverse + a
        triangularity-exploiting symmetric product (n³/3 GEMM FLOPs)."""
        from .nlml import blocked_lauum

        return blocked_lauum(self._tri_inverse())

    def inverse_diagonal(self) -> jnp.ndarray:
        """diag(A⁻¹) = column-wise ‖L⁻¹ e_i‖²
        (serializable_ldlt.hpp inverse_diagonal)."""
        Linv = self._tri_inverse()
        return jnp.sum(Linv * Linv, axis=0)

    def inverse_blocks(self, indices: Sequence[jnp.ndarray]):
        """Diagonal blocks (A⁻¹)_gg for each index group
        (serializable_ldlt.hpp:137-175).

        One GEMM-composed triangular inverse (a big batched GEMM-rich
        operation replacing the reference's per-column thread pool), then a
        gather + small gram per group.
        """
        Linv = self._tri_inverse()
        blocks = []
        for idx in indices:
            cols = Linv[:, jnp.asarray(idx)]
            blocks.append(cols.T @ cols)
        return blocks


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DirectInverse:
    """CovarianceRepresentation backed by an explicit inverse
    (/root/reference/include/albatross/src/covariance_functions/representations.hpp:85-101)."""

    inverse_matrix: jax.Array

    def tree_flatten(self):
        return (self.inverse_matrix,), None

    @classmethod
    def tree_unflatten(cls, _, children):
        return cls(children[0])

    # Precision of the explicit-inverse GEMM: against an ill-conditioned K
    # it cancels, so reduced-precision products show up directly in the
    # predictive variances.  Full FP32: on an H100 the TF32 default put
    # the variances 0.28 off at N=8192 (HIGHEST: 3e-4; PERF.md).
    solve_precision = jax.lax.Precision.HIGHEST

    def solve(self, rhs):
        return jnp.matmul(
            self.inverse_matrix, rhs, precision=self.solve_precision
        )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class ExplainedCovariance:
    """Representation of C = K (K - P)⁻¹ K used by fit_from_prediction
    (representations.hpp:64-83).  ``explained`` stores K - P (the covariance
    explained by conditioning), so solve(rhs) = C⁻¹ rhs = K⁻¹(K-P)K⁻¹ rhs."""

    prior: jax.Array  # K
    explained: jax.Array  # K - P

    def tree_flatten(self):
        return (self.prior, self.explained), None

    @classmethod
    def tree_unflatten(cls, _, children):
        return cls(*children)

    def solve(self, rhs):
        K_chol = CholeskyFactor.factorize(self.prior)
        inner = K_chol.solve(rhs)
        return K_chol.solve(self.explained @ inner)


def truncated_psd_solve(A: jnp.ndarray, rhs: jnp.ndarray, rtol: float = 1e-12):
    """Eigendecomposition solve dropping tiny eigenvalues
    (/root/reference/include/albatross/src/utils/eigen_utils.hpp:63-100)."""
    vals, vecs = jnp.linalg.eigh(_sym(A))
    cutoff = rtol * jnp.max(jnp.abs(vals))
    inv_vals = jnp.where(vals > cutoff, 1.0 / jnp.where(vals > cutoff, vals, 1.0), 0.0)
    return vecs @ (inv_vals[:, None] * (vecs.T @ rhs)) if rhs.ndim > 1 else vecs @ (
        inv_vals * (vecs.T @ rhs)
    )


def vertical_stack(blocks: Sequence[jnp.ndarray]) -> jnp.ndarray:
    """Stack matrices row-wise, or concatenate vectors
    (eigen_utils.hpp vertical_stack matrix/vector overloads)."""
    blocks = [jnp.asarray(b) for b in blocks]
    if blocks and all(b.ndim == 1 for b in blocks):
        return jnp.concatenate(blocks, axis=0)
    return jnp.concatenate([jnp.atleast_2d(b) for b in blocks], axis=0)
