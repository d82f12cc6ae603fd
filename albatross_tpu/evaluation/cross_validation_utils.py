"""Fast held-out prediction machinery (LOO / LOGO).

JAX re-design of
/root/reference/include/albatross/src/evaluation/cross_validation_utils.hpp:102-286.

The math: with the full training covariance factorized once, the held-out
prediction for group g falls out of the diagonal blocks of the inverse,

    mean_g = y_g - ((A^-1)_gg)^-1 v_g       cov_g = ((A^-1)_gg)^-1

(v = A^-1 y is the information vector).  One triangular solve against the
identity replaces the reference's threaded per-column loop; the per-group
small solves are *batched* over the group axis (vmap) when fold sizes are
uniform — the common LOO case is fully vectorized with no factorization at
all (variance = 1/diag(A^-1), Rasmussen Eq. 5.12).
"""

from __future__ import annotations

from typing import Type

import jax
import jax.numpy as jnp
import numpy as np

from ..core.distributions import JointDistribution, MarginalDistribution
from ..indexing.grouping import Grouped
from ..ops.linalg import CholeskyFactor


class BatchedGrouped(Grouped):
    """Array-backed Grouped: stacked per-group arrays are the primary
    storage; per-group distribution objects materialize lazily on mapping
    access.  This keeps LOO CV at N=10k to ~one device dispatch with no
    per-point python objects (the reference's threaded loop has no such
    bottleneck to begin with, cross_validation_utils.hpp:198-251)."""

    def __init__(
        self,
        keys,
        means,
        variances=None,
        covariances=None,
        predict_type=None,
    ):
        self._keys_list = list(keys)
        self.means = means  # (G, b)
        self.variances = variances  # (G, b) | None
        self.covariances = covariances  # (G, b, b) | None
        self.predict_type = predict_type
        self._materialized = None

    def value_at(self, i: int):
        if self.predict_type is MarginalDistribution:
            return MarginalDistribution(self.means[i], self.variances[i])
        if self.predict_type is JointDistribution:
            return JointDistribution(self.means[i], self.covariances[i])
        return self.means[i]

    @property
    def _data(self):
        if self._materialized is None:
            self._materialized = {
                k: self.value_at(i) for i, k in enumerate(self._keys_list)
            }
        return self._materialized

    # mapping views that must not force materialization
    def keys(self):
        return list(self._keys_list)

    def __len__(self):
        return len(self._keys_list)

    def __iter__(self):
        return iter(self._keys_list)

    def __contains__(self, key):
        return key in self._keys_list

    def __repr__(self):
        return f"BatchedGrouped(n_groups={len(self._keys_list)})"


def leave_one_out_conditional_variance(chol: CholeskyFactor) -> jnp.ndarray:
    """1 / diag(A⁻¹) (cross_validation_utils.hpp:132-144)."""
    return 1.0 / chol.inverse_diagonal()


def leave_one_out_conditional(
    prior: JointDistribution, truth: MarginalDistribution
) -> MarginalDistribution:
    """Conditional of each variable given all others
    (cross_validation_utils.hpp:147-163)."""
    covariance = prior.covariance + jnp.diag(truth.get_variance())
    chol = CholeskyFactor.factorize(covariance)
    loo_variance = leave_one_out_conditional_variance(chol)
    deviation = truth.mean - prior.mean
    loo_mean = truth.mean - chol.solve(deviation) * loo_variance
    return MarginalDistribution(loo_mean, loo_variance)


def _grouped_inverse_blocks(chol, indexers: Grouped):
    """(A⁻¹)_gg per group, batched when group sizes are uniform."""
    from jax.scipy.linalg import solve_triangular

    if not isinstance(chol, CholeskyFactor):
        # generic representation (e.g. DistributedCholesky): delegate to its
        # own inverse_blocks and skip the local-Linv fast paths
        blocks = chol.inverse_blocks(list(indexers.values()))
        return (
            {key: blk for key, blk in zip(indexers.keys(), blocks)},
            None,
            None,
        )

    Linv = chol._tri_inverse()  # GEMM-composed for large N (ops/nlml.py)
    sizes = [len(idx) for idx in indexers.values()]
    uniform = len(set(sizes)) == 1
    if uniform:
        idx_mat = jnp.asarray(np.stack(indexers.values()))  # (G, b)
        cols = Linv[:, idx_mat]  # (n, G, b)
        cols = jnp.moveaxis(cols, 1, 0)  # (G, n, b)
        blocks = jnp.einsum("gnb,gnc->gbc", cols, cols)
        return {
            key: blocks[g] for g, key in enumerate(indexers.keys())
        }, blocks, idx_mat
    out = {}
    for key, idx in indexers.items():
        cols = Linv[:, jnp.asarray(idx)]
        out[key] = cols.T @ cols
    return out, None, None


def held_out_predictions(
    train_covariance: CholeskyFactor,
    target_mean: jnp.ndarray,
    information: jnp.ndarray,
    indexers: Grouped,
    predict_type: Type = MarginalDistribution,
) -> Grouped:
    """Per-group held-out predictions (cross_validation_utils.hpp:198-251).

    ``target_mean`` is the raw target mean — the information vector already
    accounts for the mean function (see the note at gp.hpp:465-482).
    """
    sizes = [len(idx) for idx in indexers.values()]

    # -- fully vectorized LOO fast path ------------------------------------
    if predict_type is not JointDistribution and all(s == 1 for s in sizes):
        ainv_diag = train_covariance.inverse_diagonal()
        variance = 1.0 / ainv_diag
        order = jnp.asarray(
            np.concatenate([np.asarray(idx) for idx in indexers.values()])
        )
        mean = target_mean[order] - information[order] * variance[order]
        var_o = variance[order]
        return BatchedGrouped(
            indexers.keys(),
            mean[:, None],
            variances=var_o[:, None] if predict_type is MarginalDistribution else None,
            predict_type=predict_type,
        )

    blocks, stacked, idx_mat = _grouped_inverse_blocks(
        train_covariance, indexers
    )

    # -- batched uniform-size path -----------------------------------------
    if stacked is not None:
        y_g = target_mean[idx_mat]  # (G, b)
        v_g = information[idx_mat]  # (G, b)
        Lb = jnp.linalg.cholesky(stacked)  # (G, b, b)

        def _one(L, y, v):
            from jax.scipy.linalg import cho_solve

            mean = y - cho_solve((L, True), v)
            eye = jnp.eye(L.shape[0], dtype=L.dtype)
            inv = cho_solve((L, True), eye)
            return mean, inv

        means, invs = jax.vmap(_one)(Lb, y_g, v_g)
        if predict_type is JointDistribution:
            return BatchedGrouped(
                indexers.keys(), means, covariances=invs,
                predict_type=JointDistribution,
            )
        return BatchedGrouped(
            indexers.keys(),
            means,
            variances=(
                jnp.diagonal(invs, axis1=1, axis2=2)
                if predict_type is MarginalDistribution
                else None
            ),
            predict_type=predict_type,
        )

    # -- ragged fallback ----------------------------------------------------
    out = {}
    for key, idx in indexers.items():
        idx = jnp.asarray(idx)
        block = blocks[key]
        bchol = CholeskyFactor.factorize(block)
        mean = target_mean[idx] - bchol.solve(information[idx])
        if predict_type is JointDistribution:
            out[key] = JointDistribution(mean, bchol.inverse())
        elif predict_type is MarginalDistribution:
            out[key] = MarginalDistribution(mean, bchol.inverse_diagonal())
        else:
            out[key] = mean
    return Grouped(out)


def leave_one_group_out_conditional(
    prior: JointDistribution,
    truth: MarginalDistribution,
    indexers: Grouped,
    predict_type: Type = MarginalDistribution,
) -> Grouped:
    """Public LOGO conditional API (cross_validation_utils.hpp:255-286)."""
    covariance = prior.covariance + jnp.diag(truth.get_variance())
    chol = CholeskyFactor.factorize(covariance)
    information = chol.solve(truth.mean - prior.mean)
    return held_out_predictions(
        chol, truth.mean, information, indexers, predict_type
    )


def cross_validated_scores(metric, folds: Grouped, predictions: Grouped):
    """Apply a metric per fold (cross_validation_utils.hpp:102-130)."""
    scores = []
    for key, fold in folds.items():
        scores.append(metric(predictions[key], fold.test_dataset.targets))
    return jnp.stack([jnp.asarray(s) for s in scores])


def batched_cross_validated_scores(
    metric, dataset, indexers: Grouped, predictions: BatchedGrouped
):
    """All fold scores in one vmapped dispatch over the stacked arrays.

    Returns None when the metric is not jax-traceable (→ caller falls back
    to the per-fold loop).  Scores come out in the same sorted-key order as
    cross_validated_scores.
    """
    sizes = {len(idx) for idx in indexers.values()}
    if len(sizes) != 1:
        return None
    idx_mat = jnp.asarray(np.stack([np.asarray(i) for i in indexers.values()]))
    t_mean = dataset.targets.mean[idx_mat]  # (G, b)
    t_var = (
        dataset.targets.variance[idx_mat]
        if dataset.targets.variance is not None
        else jnp.zeros_like(t_mean)
    )
    pt = predictions.predict_type

    def one(mean, var, cov, tm, tv):
        if pt is JointDistribution:
            pred = JointDistribution(mean, cov)
        elif pt is MarginalDistribution:
            pred = MarginalDistribution(mean, var)
        else:
            pred = mean
        return metric(pred, MarginalDistribution(tm, tv))

    means = predictions.means
    variances = (
        predictions.variances
        if predictions.variances is not None
        else jnp.zeros_like(means)
    )
    covs = (
        predictions.covariances
        if predictions.covariances is not None
        else jnp.zeros(means.shape + means.shape[-1:], dtype=means.dtype)
    )
    try:
        return jax.vmap(one)(means, variances, covs, t_mean, t_var)
    except (jax.errors.TracerArrayConversionError, TypeError):
        return None
