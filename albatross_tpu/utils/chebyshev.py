"""Chebyshev polynomial evaluation and basis matrices.

JAX counterpart of
/root/reference/include/albatross/src/polynomial/chebyshev.hpp:23-140.
Traceable (jnp) so Chebyshev feature maps can live inside jitted models.
"""

from __future__ import annotations

import jax.numpy as jnp


def chebyshev_t(n: int, x) -> jnp.ndarray:
    """T_n(x) via the stable three-term recurrence."""
    x = jnp.asarray(x)
    if n == 0:
        return jnp.ones_like(x)
    t_prev, t = jnp.ones_like(x), x
    for _ in range(1, n):
        t_prev, t = t, 2.0 * x * t - t_prev
    return t


def chebyshev_u(n: int, x) -> jnp.ndarray:
    """U_n(x)."""
    x = jnp.asarray(x)
    if n == 0:
        return jnp.ones_like(x)
    u_prev, u = jnp.ones_like(x), 2.0 * x
    for _ in range(1, n):
        u_prev, u = u, 2.0 * x * u - u_prev
    return u


def chebyshev_t_phi(x, order: int, lo: float = -1.0, hi: float = 1.0):
    """Basis matrix Phi[i, k] = T_k(scaled x_i), k = 0..order-1
    (chebyshev.hpp chebyshev_t_phi)."""
    x = jnp.asarray(x).reshape(-1)
    scaled = 2.0 * (x - lo) / (hi - lo) - 1.0
    cols = [chebyshev_t(k, scaled) for k in range(order)]
    return jnp.stack(cols, axis=1)
