"""Greedy coordinate-descent coarse tuner.

JAX re-design of
/root/reference/include/albatross/src/tune/greedy_tuner.hpp:14-201:
per-parameter log-spaced candidate queries within prior bounds, pick the
best, iterate.  Candidate evaluations for one parameter are *batched* with
vmap (replacing the reference's thread pool) when the objective is traceable.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.parameters import set_tunable_params


def _candidate_values(value, lower, upper, n: int) -> np.ndarray:
    """Log-spaced candidates within bounds around the current value
    (greedy_tuner.hpp query generation)."""
    lo = lower if np.isfinite(lower) and lower > 0 else max(1e-8, value * 1e-4)
    hi = upper if np.isfinite(upper) else max(1.0, value * 1e4)
    if lo <= 0 or hi <= lo:
        return np.linspace(
            lower if np.isfinite(lower) else value - 1.0,
            upper if np.isfinite(upper) else value + 1.0,
            n,
        )
    return np.geomspace(lo, hi, n)


def greedy_tune(
    model,
    objective: Callable,
    n_candidates: int = 9,
    n_sweeps: int = 2,
    use_vmap: bool = True,
    log_fn: Optional[Callable] = None,
):
    """Minimize objective(model) coordinate-wise.

    ``objective(model) -> scalar``.  Returns (best_model, best_value).
    """
    tunable = model.get_tunable_parameters()
    x = np.asarray(tunable.values, dtype=float)
    lower = np.asarray(tunable.lower_bounds)
    upper = np.asarray(tunable.upper_bounds)
    params = model.get_params()

    def eval_x(xv):
        m = model.set_params(set_tunable_params(params, jnp.asarray(xv)))
        return objective(m)

    if use_vmap:
        batched_eval = jax.jit(jax.vmap(lambda xv: jnp.asarray(eval_x(xv))))
    best_value = float(eval_x(x))

    for sweep in range(n_sweeps):
        for i, name in enumerate(tunable.names):
            # candidates in *tunable* space: log-scale params are already
            # log-transformed there, so geomspace over positive bounds (or
            # linspace in log space) reproduces the reference's log-spaced
            # queries
            cands = _candidate_values(x[i], lower[i], upper[i], n_candidates)
            cand_x = np.tile(x, (len(cands), 1))
            cand_x[:, i] = np.clip(cands, lower[i], upper[i])
            if use_vmap:
                values = np.asarray(batched_eval(jnp.asarray(cand_x)))
            else:
                values = np.asarray([float(eval_x(c)) for c in cand_x])
            values = np.where(np.isnan(values), np.inf, values)
            j = int(np.argmin(values))
            if values[j] < best_value:
                best_value = float(values[j])
                x = cand_x[j]
            if log_fn:
                log_fn(sweep, name, x[i], best_value)

    best_model = model.set_params(set_tunable_params(params, jnp.asarray(x)))
    return best_model, best_value
