"""Ensemble MCMC: affine-invariant (Goodman–Weare) stretch move.

JAX re-design of
/root/reference/include/albatross/src/samplers/ensemble.hpp:44-186 and
initialization.hpp:110-165.

The reference updates walkers one at a time on a single thread (each proposal
a full O(n³) NLML).  Here the walk runs in the model's *tunable space* with
the standard parallel two-half scheme: each half proposes against the other
half simultaneously, so every iteration is two *vmapped* batches of log-prob
evaluations — batched gram + batched Cholesky, and the whole chain
is one `lax.scan`.  Walkers shard across devices via the mesh layer
(albatross_tpu.parallel) for multi-chip chains.

Matching reference semantics: z ~ ((a−1)u+1)²/a, acceptance on
(d−1)·log z + Δlogp, zero-delta components nudged by 1e-6, non-finite
initial states repaired by resampling interpolations.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.parameters import set_tunable_params


class SamplerState(NamedTuple):
    """One iteration's ensemble state (samplers/state.hpp:18)."""

    params: jax.Array  # (n_walkers, n_dim) tunable-space positions
    log_prob: jax.Array  # (n_walkers,)
    accepted: jax.Array  # (n_walkers,) bool


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class EnsembleChain:
    """Full chain: arrays with leading iteration axis (a pytree, so chains
    checkpoint through serialize.save_checkpoint like any other state)."""

    params: np.ndarray  # (n_iterations+1, n_walkers, n_dim)
    log_prob: np.ndarray
    accepted: np.ndarray

    def tree_flatten(self):
        return (self.params, self.log_prob, self.accepted), None

    @classmethod
    def tree_unflatten(cls, _, children):
        import numpy as _np

        return cls(*(_np.asarray(c) for c in children))

    def __len__(self):
        return self.params.shape[0]

    def state(self, i: int) -> SamplerState:
        return SamplerState(self.params[i], self.log_prob[i], self.accepted[i])

    def acceptance_rate(self) -> float:
        return float(np.mean(self.accepted[1:]))

    def flat_samples(self, burn_in: int = 0) -> np.ndarray:
        return self.params[burn_in:].reshape(-1, self.params.shape[-1])


def _half_step(key, movers, others, others_lp, log_prob_fn, a):
    """Propose for all `movers` against the complementary half at once
    (ensemble.hpp:73-121, parallelized)."""
    n_move, n_dim = movers.shape
    k_choice, k_z, k_accept = jax.random.split(key, 3)
    # choose complementary partners, preferring finite-logp ones via gumbel
    # trick on the finite mask (reference resamples until finite)
    finite = jnp.isfinite(others_lp)
    logits = jnp.where(finite, 0.0, -1e30)
    j = jax.random.categorical(k_choice, logits, shape=(n_move,))
    partners = others[j]

    p = jax.random.uniform(k_z, (n_move,))
    z = ((a - 1.0) * p + 1.0) ** 2 / a
    delta = movers - partners
    delta = jnp.where(delta == 0.0, 1e-6, delta)  # ensemble.hpp:98-103
    proposal = partners + z[:, None] * delta
    return proposal, z, k_accept


def stretch_move_step(
    key,
    state: SamplerState,
    log_prob_fn: Callable,
    a: float = 2.0,
) -> SamplerState:
    """One full stretch-move iteration (both halves)."""
    params, log_prob, _ = state
    n = params.shape[0]
    n_dim = params.shape[1]
    half = n // 2
    idx_a, idx_b = jnp.arange(half), jnp.arange(half, n)

    def update_half(key, movers, movers_lp, others, others_lp):
        proposal, z, k_accept = _half_step(
            key, movers, others, others_lp, log_prob_fn, a
        )
        prop_lp = log_prob_fn(proposal)
        log_prob_z = (n_dim - 1.0) * jnp.log(z)
        log_diff = log_prob_z + prop_lp - movers_lp
        u = jax.random.uniform(k_accept, (movers.shape[0],))
        accepted = (log_diff > jnp.log(u)) & jnp.isfinite(prop_lp)
        new = jnp.where(accepted[:, None], proposal, movers)
        new_lp = jnp.where(accepted, prop_lp, movers_lp)
        return new, new_lp, accepted

    k1, k2 = jax.random.split(key)
    pa, lpa = params[idx_a], log_prob[idx_a]
    pb, lpb = params[idx_b], log_prob[idx_b]
    pa, lpa, acc_a = update_half(k1, pa, lpa, pb, lpb)
    pb, lpb, acc_b = update_half(k2, pb, lpb, pa, lpa)

    return SamplerState(
        jnp.concatenate([pa, pb]),
        jnp.concatenate([lpa, lpb]),
        jnp.concatenate([acc_a, acc_b]),
    )


@functools.partial(jax.jit, static_argnums=(2, 3))
def _run_chunk(state0, keys, log_prob_fn, a):
    """One scan segment, jitted at module level so repeated chains with the
    SAME log_prob_fn object (and chunk shape) reuse the compilation —
    per-call lambdas would recompile the whole chain every run."""

    def scan_body(carry, key_i):
        state = stretch_move_step(key_i, carry, log_prob_fn, a)
        return state, state

    return jax.lax.scan(scan_body, state0, keys)


def ensure_finite_initial_state(
    key, params: jnp.ndarray, log_prob_fn: Callable, max_tries: int = 50
):
    """Repair non-finite walkers by interpolating toward finite ones
    (initialization.hpp:123-165)."""
    lp = log_prob_fn(params)
    for _ in range(max_tries):
        finite = jnp.isfinite(lp)
        if bool(jnp.all(finite)):
            break
        key, k_pick, k_alpha = jax.random.split(key, 3)
        logits = jnp.where(finite, 0.0, -1e30)
        donors = params[
            jax.random.categorical(k_pick, logits, shape=(params.shape[0],))
        ]
        alpha = jax.random.uniform(
            k_alpha, (params.shape[0], 1), minval=0.2, maxval=0.8
        )
        repaired = donors + alpha * (params - donors)
        params = jnp.where(finite[:, None], params, repaired)
        lp = log_prob_fn(params)
    return params, lp


def ensemble_sampler(
    log_prob_fn: Callable,
    initial_params: jnp.ndarray,
    max_iterations: int,
    key,
    a: float = 2.0,
    callback: Optional[Callable] = None,
    callback_interval: int = 64,
) -> EnsembleChain:
    """Run the sampler (ensemble.hpp:126-150).

    ``log_prob_fn`` must map an (n_walkers, n_dim) batch to (n_walkers,)
    log-probabilities (wrap a scalar function with jax.vmap).

    Without a callback the whole chain is one ``lax.scan``.  With a
    callback, the scan is *chunked* every ``callback_interval`` iterations
    and callbacks fire as each chunk lands on the host — so a
    CsvWritingCallback persists progress mid-run and a crashed long chain
    keeps everything up to the last chunk (the durability of the
    reference's per-iteration callback, callbacks.hpp:80-100, at batched
    device-execution speed).  Chunking does not change the chain: the PRNG
    key sequence is identical.
    """
    initial_params = jnp.asarray(initial_params)
    key, k_init = jax.random.split(jax.random.PRNGKey(key) if isinstance(key, int) else key)
    params, lp = ensure_finite_initial_state(k_init, initial_params, log_prob_fn)
    state0 = SamplerState(params, lp, jnp.ones(params.shape[0], dtype=bool))

    keys = jax.random.split(key, max_iterations)
    chunk = max_iterations if callback is None else max(1, callback_interval)

    if callback is not None:
        callback(0, state0)

    parts = []
    state = state0
    pos = 0
    while pos < max_iterations:
        n = min(chunk, max_iterations - pos)
        state, states = _run_chunk(state, keys[pos : pos + n], log_prob_fn, a)
        part = jax.device_get(states)
        parts.append(part)
        if callback is not None:
            for i in range(n):
                callback(
                    pos + 1 + i,
                    SamplerState(
                        part.params[i], part.log_prob[i], part.accepted[i]
                    ),
                )
        pos += n

    chain = EnsembleChain(
        params=np.concatenate(
            [np.asarray(state0.params)[None]] + [p.params for p in parts]
        ),
        log_prob=np.concatenate(
            [np.asarray(state0.log_prob)[None]] + [p.log_prob for p in parts]
        ),
        accepted=np.concatenate(
            [np.asarray(state0.accepted)[None]] + [p.accepted for p in parts]
        ),
    )
    return chain


def initial_params_from_jitter(
    key, tunable_values: jnp.ndarray, n_walkers: int, jitter_sd: float = 0.1
) -> jnp.ndarray:
    """Walkers = params + N(0, jitter_sd) in tunable space
    (initialization.hpp:110-121)."""
    noise = jitter_sd * jax.random.normal(
        key, (n_walkers, tunable_values.shape[0])
    )
    return jnp.asarray(tunable_values)[None, :] + noise


def ensemble_sampler_from_model(
    model,
    dataset,
    n_walkers: int,
    max_iterations: int,
    key,
    jitter_sd: float = 0.1,
    callback: Optional[Callable] = None,
    callback_interval: int = 64,
    mesh=None,
    mesh_axis: str = "chain",
) -> EnsembleChain:
    """Model-level driver (ensemble.hpp:166-186): logp(x) =
    model.set_tunable_params(x).log_likelihood(dataset), vmapped over
    walkers.

    Pass a ``jax.sharding.Mesh`` to shard the walker batch across devices:
    each chip evaluates its walkers' NLMLs (batched gram + Cholesky)
    locally — chain parallelism across devices, the capability the reference's
    serial walker loop could never have (SURVEY.md §2.12 checklist).
    """
    if isinstance(key, int):
        key = jax.random.PRNGKey(key)
    k_init, k_run = jax.random.split(key)
    tunable = model.get_tunable_parameters()
    initial = initial_params_from_jitter(
        k_init, tunable.values, n_walkers, jitter_sd
    )
    params0 = model.get_params()

    def single_log_prob(x):
        m = model.set_params(set_tunable_params(params0, x))
        return m.log_likelihood(dataset)

    batched = jax.vmap(single_log_prob)
    if mesh is not None:
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P

        sharding = NamedSharding(mesh, P(mesh_axis))

        def log_prob_fn(walkers):
            walkers = jax.lax.with_sharding_constraint(
                walkers,
                NamedSharding(mesh, P(mesh_axis, None)),
            )
            return jax.lax.with_sharding_constraint(batched(walkers), sharding)

        log_prob_fn = jax.jit(log_prob_fn)
    else:
        log_prob_fn = jax.jit(batched)
    return ensemble_sampler(
        log_prob_fn, initial, max_iterations, k_run,
        callback=callback, callback_interval=callback_interval,
    )
