"""Hyperparameter tuning drivers.

JAX re-design of
/root/reference/include/albatross/src/tune/tune.hpp:51-315.

The reference wraps nlopt (default derivative-free SBPLX; gradient SLSQP with
finite differences).  Here the objective — metric(dataset, model) through
gram + Cholesky — is *differentiable end-to-end* with JAX autodiff, so the
default tuner is gradient-based (Adam or L-BFGS via optax) in the bounded,
log-scale-transformed tunable space (the exact reparameterization the
reference feeds nlopt, core/parameters.hpp:117-195).  A Nelder–Mead
simplex tuner covers non-smooth objectives as the SBPLX analog.

Every evaluation is logged via an optional callback, mirroring the
reference's ostream logging (tune.hpp:102-110).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..core.dataset import RegressionDataset
from ..core.parameters import ParameterStore, set_tunable_params


def mean_aggregator(values) -> float:
    """Default multi-dataset aggregator (tuning_metrics.hpp:23-31)."""
    return jnp.mean(jnp.stack([jnp.asarray(v) for v in values]))


@dataclasses.dataclass
class TuningResult:
    params: Optional[ParameterStore]  # filled by ModelTuner/param-store form
    value: float
    x: np.ndarray
    history: List[float]


def _clip(x, lower, upper):
    return jnp.clip(x, lower, upper)


# -- smooth bound handling ----------------------------------------------------
# The gradient path optimizes an UNCONSTRAINED vector u and maps it through a
# smooth bijection into the box — two-sided bounds via scaled sigmoid,
# one-sided via softplus shifts — so the optimizer state never fights a
# clamp at an active bound (the failure mode of projected steps with
# momentum/curvature optimizers).  The reference clamps inside nlopt
# (parameters.hpp:166-177); this is the differentiable equivalent.
_SOFTPLUS_CAP = 30.0


def _softplus(u):
    return jnp.where(u > _SOFTPLUS_CAP, u, jnp.log1p(jnp.exp(jnp.minimum(u, _SOFTPLUS_CAP))))


def _softplus_inv(x):
    x = jnp.maximum(x, 1e-300)
    return jnp.where(x > _SOFTPLUS_CAP, x, jnp.log(jnp.expm1(jnp.minimum(x, _SOFTPLUS_CAP))))


def _make_bijection(lower, upper):
    """(constrain, unconstrain) mapping R^n <-> the bound box."""
    two_sided = jnp.isfinite(lower) & jnp.isfinite(upper)
    lower_only = jnp.isfinite(lower) & ~jnp.isfinite(upper)
    upper_only = ~jnp.isfinite(lower) & jnp.isfinite(upper)
    span = jnp.where(two_sided, upper - lower, 1.0)

    def constrain(u):
        x = u  # free
        x = jnp.where(two_sided, lower + span * jax.nn.sigmoid(u), x)
        x = jnp.where(lower_only, lower + _softplus(u), x)
        x = jnp.where(upper_only, upper - _softplus(-u), x)
        return x

    def unconstrain(x):
        x_in = jnp.clip(x, lower, upper)
        t = jnp.clip((x_in - lower) / span, 1e-12, 1.0 - 1e-12)
        u = x  # free
        u = jnp.where(two_sided, jnp.log(t) - jnp.log1p(-t), u)
        u = jnp.where(lower_only, _softplus_inv(x_in - lower), u)
        u = jnp.where(upper_only, -_softplus_inv(upper - x_in), u)
        return u

    return constrain, unconstrain


class GenericTuner:
    """Minimize f(tunable_vector) within bounds (tune.hpp:112-254)."""

    def __init__(
        self,
        tunable,  # TunableParameters
        optimizer: str = "lbfgs",
        max_iterations: int = 200,
        learning_rate: float = 0.05,
        tolerance: float = 1e-9,
        log_fn: Optional[Callable[[int, np.ndarray, float], None]] = None,
        sync_every: int = 10,
    ):
        self.tunable = tunable
        self.optimizer = optimizer
        self.max_iterations = max_iterations
        self.learning_rate = learning_rate
        self.tolerance = tolerance
        self.log_fn = log_fn
        # gradient path: optimizer steps per host synchronization — K steps
        # run inside ONE jitted lax.scan, so the loop costs
        # max_iterations/K host round trips instead of max_iterations.
        # Per-iteration history/log_fn fidelity is kept:
        # the scan stacks every step's (value, x) and they are replayed on
        # the host after each chunk.
        self.sync_every = max(1, int(sync_every))

    def tune(self, objective: Callable) -> TuningResult:
        lower = jnp.asarray(self.tunable.lower_bounds)
        upper = jnp.asarray(self.tunable.upper_bounds)
        x0 = jnp.asarray(self.tunable.values)

        def guarded(x):
            # NaN -> +inf guard (tune.hpp:164-166)
            v = objective(_clip(x, lower, upper))
            return jnp.where(jnp.isnan(v), jnp.inf, v)

        if self.optimizer == "nelder_mead":
            return self._nelder_mead(guarded, x0, lower, upper)
        return self._gradient(guarded, x0, lower, upper)

    # -- gradient path ------------------------------------------------------
    def _gradient(self, objective, x0, lower, upper) -> TuningResult:
        if self.optimizer == "adam":
            opt = optax.adam(self.learning_rate)
        else:
            opt = optax.lbfgs()

        constrain, unconstrain = _make_bijection(lower, upper)

        def obj_u(u):
            return objective(constrain(u))

        value_and_grad = jax.value_and_grad(obj_u)
        use_adam = self.optimizer == "adam"

        def one_step(carry, _):
            u, opt_state = carry
            value, grad = value_and_grad(u)
            if use_adam:
                updates, opt_state = opt.update(grad, opt_state, u)
            else:
                updates, opt_state = opt.update(
                    grad,
                    opt_state,
                    u,
                    value=value,
                    grad=grad,
                    value_fn=obj_u,
                )
            u_next = optax.apply_updates(u, updates)
            # value is f(u) BEFORE the step; x logged is the post-step point
            # (same pairing as the former python loop)
            return (u_next, opt_state), (value, constrain(u_next))

        @functools.partial(jax.jit, static_argnums=2)
        def run_chunk(u, opt_state, k):
            # ONE compile per tune(); every subsequent chunk reuses it.
            (u, opt_state), (values, xs) = jax.lax.scan(
                one_step, (u, opt_state), None, length=k
            )
            return u, opt_state, values, xs

        u = unconstrain(x0)
        opt_state = opt.init(u)
        history: List[float] = []
        best_x, best_v = np.asarray(x0), np.inf
        done = 0
        converged = False
        while done < self.max_iterations and not converged:
            k = min(self.sync_every, self.max_iterations - done)
            u, opt_state, values, xs = run_chunk(u, opt_state, k)
            values = np.asarray(values)  # the chunk's single host sync
            xs = np.asarray(xs)
            for j in range(k):
                i = done + j
                v = float(values[j])
                history.append(v)
                if self.log_fn:
                    self.log_fn(i, xs[j], v)
                if v < best_v:
                    best_v, best_x = v, xs[j]
                if (
                    i > 5
                    and abs(history[-2] - v) < self.tolerance * (1 + abs(v))
                ):
                    converged = True
                    break
            done += k
        final_v = float(obj_u(u))
        if final_v < best_v:
            best_v, best_x = final_v, np.asarray(constrain(u))
        return TuningResult(None, best_v, best_x, history)

    # -- simplex path (SBPLX analog) ----------------------------------------
    def _nelder_mead(self, objective, x0, lower, upper) -> TuningResult:
        obj = jax.jit(objective)

        def f(x):
            return float(obj(jnp.asarray(x)))

        x0 = np.asarray(x0, dtype=float)
        lower_np = np.asarray(lower)
        upper_np = np.asarray(upper)
        n = x0.shape[0]
        # initial simplex: perturb each coordinate
        scale = np.where(
            np.isfinite(upper_np - lower_np), 0.05 * (upper_np - lower_np), 0.1
        )
        scale = np.maximum(scale, 1e-4)
        simplex = [x0]
        for i in range(n):
            v = x0.copy()
            v[i] = np.clip(v[i] + scale[i], lower_np[i], upper_np[i])
            if v[i] == x0[i]:
                v[i] = np.clip(x0[i] - scale[i], lower_np[i], upper_np[i])
            simplex.append(v)
        simplex = np.stack(simplex)
        values = np.array([f(v) for v in simplex])
        history: List[float] = []
        alpha, gamma, rho, sigma = 1.0, 2.0, 0.5, 0.5
        for it in range(self.max_iterations):
            order = np.argsort(values)
            simplex, values = simplex[order], values[order]
            history.append(values[0])
            if self.log_fn:
                self.log_fn(it, simplex[0], values[0])
            if abs(values[-1] - values[0]) < self.tolerance * (1 + abs(values[0])):
                break
            centroid = simplex[:-1].mean(axis=0)

            def clipped(x):
                return np.clip(x, lower_np, upper_np)

            xr = clipped(centroid + alpha * (centroid - simplex[-1]))
            fr = f(xr)
            if values[0] <= fr < values[-2]:
                simplex[-1], values[-1] = xr, fr
            elif fr < values[0]:
                xe = clipped(centroid + gamma * (xr - centroid))
                fe = f(xe)
                if fe < fr:
                    simplex[-1], values[-1] = xe, fe
                else:
                    simplex[-1], values[-1] = xr, fr
            else:
                xc = clipped(centroid + rho * (simplex[-1] - centroid))
                fc = f(xc)
                if fc < values[-1]:
                    simplex[-1], values[-1] = xc, fc
                else:
                    for i in range(1, n + 1):
                        simplex[i] = clipped(
                            simplex[0] + sigma * (simplex[i] - simplex[0])
                        )
                        values[i] = f(simplex[i])
        best = int(np.argmin(values))
        return TuningResult(
            None, float(values[best]), simplex[best], history
        )


class ModelTuner:
    """Ties model + metric + dataset(s) into a tunable objective
    (tune.hpp:256-315)."""

    def __init__(
        self,
        model,
        metric,
        datasets: Sequence[RegressionDataset] | RegressionDataset,
        aggregator: Callable = mean_aggregator,
        **tuner_kwargs,
    ):
        self.model = model
        self.metric = metric
        self.datasets = (
            [datasets] if isinstance(datasets, RegressionDataset) else list(datasets)
        )
        self.aggregator = aggregator
        self.tuner_kwargs = tuner_kwargs

    def objective(self, x):
        params = set_tunable_params(self.model.get_params(), x)
        model = self.model.set_params(params)
        values = [self.metric(d, model) for d in self.datasets]
        return self.aggregator(values) if len(values) > 1 else values[0]

    def tune(self) -> TuningResult:
        tunable = self.model.get_tunable_parameters()
        tuner = GenericTuner(tunable, **self.tuner_kwargs)
        result = tuner.tune(self.objective)
        result.params = set_tunable_params(
            self.model.get_params(), jnp.asarray(result.x)
        )
        return result

    def tuned_model(self):
        result = self.tune()
        return self.model.set_params(result.params), result


def get_tuner(model, metric, dataset, **kwargs) -> ModelTuner:
    return ModelTuner(model, metric, dataset, **kwargs)


def tune_parameter_store(
    objective: Callable[[ParameterStore], object],
    params: ParameterStore,
    **tuner_kwargs,
) -> TuningResult:
    """Tune an f(ParameterStore) objective (the reference's third objective
    form, tune.hpp:112-140): the store's tunable vector is optimized and the
    result carries the updated store."""
    from ..core.parameters import get_tunable_parameters

    tunable = get_tunable_parameters(params)
    tuner = GenericTuner(tunable, **tuner_kwargs)

    def vector_objective(x):
        return objective(set_tunable_params(params, x))

    result = tuner.tune(vector_objective)
    result.params = set_tunable_params(params, jnp.asarray(result.x))
    return result
