"""Finite-difference gradients (API parity).

JAX counterpart of
/root/reference/include/albatross/src/tune/finite_difference.hpp:18-100.

JAX autodiff makes this mostly obsolete — gradient tuners here use exact
gradients through the Cholesky — but the forward-difference fallback is kept
for non-traceable objectives, with the reference's bound-aware epsilon and
sign-flip-at-bounds behavior.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def compute_gradient(
    objective: Callable[[np.ndarray], float],
    x: np.ndarray,
    lower_bounds=None,
    upper_bounds=None,
    f0: float | None = None,
) -> np.ndarray:
    x = np.asarray(x, dtype=float)
    n = x.shape[0]
    lower = np.full(n, -np.inf) if lower_bounds is None else np.asarray(lower_bounds)
    upper = np.full(n, np.inf) if upper_bounds is None else np.asarray(upper_bounds)
    if f0 is None:
        f0 = float(objective(x))
    grad = np.zeros(n)
    for i in range(n):
        bound_range = upper[i] - lower[i]
        eps = 1e-8 * bound_range if np.isfinite(bound_range) else 1e-8
        eps = max(eps, 1e-12)
        step = eps
        # sign-flip at the upper bound (finite_difference.hpp:50-70)
        if x[i] + step > upper[i]:
            step = -eps
        xp = x.copy()
        xp[i] += step
        grad[i] = (float(objective(xp)) - f0) / step
    return grad
