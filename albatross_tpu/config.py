"""Runtime configuration knobs."""

from __future__ import annotations

# Factorization accuracy mode: None = fast (default matmul precision; panel
# GEMMs escalate to Precision.HIGH at N>=32768); "high" / "highest" = that
# precision on ALL factorization GEMMs; "double_word" = maximum fidelity —
# double-word-carry trailing matrix + exact-product GEMMs
# (ops/compensated.py blocked_cholesky_dw).  Read by
# CholeskyFactor._factor_core / nlml_terms.
CHOLESKY_PRECISION: str | None = None

# Blocked-Cholesky loop order for the no-assemble NLML path: "right"
# (default) = right-looking trailing updates; "left" = left-looking — one
# large (n−j0, j0)×(j0, b) GEMM per panel, gram columns produced inline
# and fused into the GEMM epilogue when the kernel pattern-matches
# (ops/blocked_cholesky.py blocked_cholesky_left), so the N² covariance
# never gets its own device-memory write and each entry rounds to f32
# ONCE; "right_fused" = the right-looking loop with LAZY gram columns
# (blocked_cholesky_cols_fused): column j's gram is built at its first
# trailing update, fused into that GEMM's epilogue, so the covariance is
# never materialized.  Only the factor's column panels remain, and the
# materialized "right" path compiles to about as few bytes (PERF.md), so no
# loop order is chosen automatically.
CHOLESKY_ALGORITHM: str = "right"

# Store factored column panels at bf16 for the trailing-update re-reads
# (right-looking cols layout only): the G−k trailing updates re-read each
# panel from device memory, and a 2-byte store halves that traffic.
# Ignored for f64 inputs and whenever CHOLESKY_PRECISION requests a
# multi-pass accuracy mode (those need full-precision operands).
CHOLESKY_TRAILING_BF16: bool = False

# Diagonal-panel factorizer inside the blocked Cholesky: None/"builtin" =
# XLA's cholesky + GEMM-composed inverse (blocked_tri_inverse); "fused" =
# the sub-blocked recursion that materializes each sub-inverse once for
# both the panel solve and the inverse composition
# (ops/blocked_cholesky.py fused_panel_chol_inverse).  Any other value is
# rejected.  Read EAGERLY by linalg._factor_core/nlml_terms and threaded
# into the inner jit as a STATIC argument (a config flip busts the cache
# through a fresh outer trace; direct blocked_cholesky_cols callers must
# pass panel_factorizer=... themselves — the inner jit never re-reads
# config).
PANEL_FACTORIZER: str | None = None

# Panel (block) size override for the blocked Cholesky: None = the auto
# policy (ops/blocked_cholesky.py auto_block_size, smallest 128-aligned
# divisor >= 1792 with <= 16 panels).
CHOLESKY_BLOCK_SIZE: int | None = None

# NLML accuracy mode (ops/compensated.py): double-word (two-float)
# reductions for the log-det and whiten sums plus iterative refinement on
# the quadratic term — attacks the f32 solve/reduction error floor
# without f64 arithmetic.  Costs one extra mat-vec + two triangular solves
# (O(N²)) per refinement step.  Read by GaussianProcess.log_likelihood.
NLML_COMPENSATED: bool = False

