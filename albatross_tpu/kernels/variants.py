"""Mixed (variant) feature types as tagged batches.

JAX re-design of the reference's variant-feature support
(/root/reference/include/albatross/src/covariance_functions/callers.hpp
 VariantForwarder, 196-592; utils/variant_utils.hpp).

The reference stores ``vector<variant<A, B>>`` and dispatches per element at
compile time; undefined type pairs contribute 0.  Here a ``TaggedBatch``
keeps one *dense sub-batch per type* plus the permutation back to the user's
interleaved order — a Gram over mixed features assembles from per-type-pair
blocks, each a normal batched kernel call with static shapes, and
"undefined pair → 0" becomes a zero block (variant semantics, NOT the error
semantics of an entirely-undefined call).

Tag dispatch flows *out of band* through the composition tree via
``_tagged_matrix`` (see base.py): plain kernels are tag-agnostic (they apply
to every sub-batch, like albatross templates accepting any type), while the
``ForTag`` wrapper restricts a term to specific tags — the data-driven analog
of defining ``_call_impl`` only for certain types.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .base import CovarianceFunction


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class TaggedBatch:
    """Per-tag dense sub-batches + the inverse permutation.

    ``features[i]`` holds the rows whose tag is ``tags[i]`` (in original
    relative order); ``order[p]`` is the original interleaved position of
    concatenated-sub-batch row p.
    """

    tags: Tuple[int, ...]  # static: tag value per sub-batch
    features: Tuple[Any, ...]  # dynamic: one feature batch per tag
    order: Tuple[int, ...]  # static: original position per row

    def tree_flatten(self):
        return (self.features,), (self.tags, self.order)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0], children[0], aux[1])

    @property
    def size(self) -> int:
        return len(self.order)

    def counts(self) -> Tuple[int, ...]:
        return tuple(
            jax.tree_util.tree_leaves(f)[0].shape[0] for f in self.features
        )

    @classmethod
    def create(cls, tag_array, features_by_tag: Dict[int, Any]) -> "TaggedBatch":
        """Build from an (N,) tag array and per-tag feature batches whose
        rows correspond, in order, to that tag's occurrences."""
        tag_array = np.asarray(jax.device_get(tag_array))
        tags = tuple(sorted(features_by_tag))
        order: list = []
        for t in tags:
            order.extend(np.nonzero(tag_array == t)[0].tolist())
        if len(order) != tag_array.shape[0]:
            raise ValueError("features_by_tag does not cover every tag value")
        return cls(tags, tuple(features_by_tag[t] for t in tags), tuple(order))

    @classmethod
    def concatenate(cls, batches: Sequence["TaggedBatch"]) -> "TaggedBatch":
        """Row-concatenate tagged batches, preserving interleaved order —
        the analog of the reference's variant-vector concatenation
        (core/concatenate.hpp), which is what lets an online update mix
        feature kinds (gp.hpp:384-414 with variant features)."""
        all_tags = tuple(sorted(set().union(*(set(b.tags) for b in batches))))
        feats: Dict[int, list] = {t: [] for t in all_tags}
        orders: Dict[int, list] = {t: [] for t in all_tags}
        offset = 0
        for b in batches:
            start = 0
            for t, f in zip(b.tags, b.features):
                n = jax.tree_util.tree_leaves(f)[0].shape[0]
                feats[t].append(f)
                orders[t].extend(offset + p for p in b.order[start : start + n])
                start += n
            offset += b.size
        merged_feats = []
        for t in all_tags:
            parts = feats[t]
            merged_feats.append(
                parts[0]
                if len(parts) == 1
                else jax.tree_util.tree_map(
                    lambda *ls: jnp.concatenate(ls, axis=0), *parts
                )
            )
        order = tuple(p for t in all_tags for p in orders[t])
        return cls(all_tags, tuple(merged_feats), order)


class ForTag(CovarianceFunction):
    """Restrict a kernel term to specific variant tags."""

    def __init__(self, sub: CovarianceFunction, tags: Sequence[int]):
        self.sub = sub
        self.for_tags = tuple(sorted(tags))

    @property
    def name(self):
        return f"for_tags{list(self.for_tags)}[{self.sub.name}]"

    def _matrix(self, X, Y, x_meas, y_meas):
        # untagged call: behave like the sub-kernel (albatross kernels apply
        # to their plain types regardless of variant context)
        return self.sub._matrix(X, Y, x_meas, y_meas)

    def _tagged_matrix(self, X, Y, tx, ty, x_meas, y_meas):
        if tx is not None and tx not in self.for_tags:
            return None
        if ty is not None and ty not in self.for_tags:
            return None
        return self.sub._tagged_matrix(X, Y, tx, ty, x_meas, y_meas)

    def _diag(self, X, x_meas):
        return self.sub._diag(X, x_meas)

    def _tagged_diag(self, X, tx, x_meas):
        if tx is not None and tx not in self.for_tags:
            return None
        return self.sub._tagged_diag(X, tx, x_meas)

    def _symmetric_exact(self, X):
        return self.sub._symmetric_exact(X)


def for_tag(sub: CovarianceFunction, *tags: int) -> ForTag:
    return ForTag(sub, tags)


def tagged_gram(kernel: CovarianceFunction, X: TaggedBatch, Y, x_meas, y_meas):
    """Assemble the block covariance over tagged batches; undefined
    tag pairs are zero blocks; output is permuted back to interleaved
    order."""
    y_tagged = isinstance(Y, TaggedBatch)
    y_items = (
        list(zip(Y.tags, Y.features)) if y_tagged else [(None, Y)]
    )

    rows = []
    for tx, fx in zip(X.tags, X.features):
        nx = jax.tree_util.tree_leaves(fx)[0].shape[0]
        cols = []
        for ty, fy in y_items:
            ny = jax.tree_util.tree_leaves(fy)[0].shape[0]
            block = kernel._tagged_matrix(fx, fy, tx, ty, x_meas, y_meas)
            if block is None:
                block = jnp.zeros((nx, ny))
            cols.append(block)
        rows.append(jnp.concatenate(cols, axis=1))
    stacked = jnp.concatenate(rows, axis=0)

    inv_x = jnp.asarray(np.argsort(np.asarray(X.order)))
    stacked = stacked[inv_x, :]
    if y_tagged:
        inv_y = jnp.asarray(np.argsort(np.asarray(Y.order)))
        stacked = stacked[:, inv_y]
    return stacked


def tagged_diag(kernel: CovarianceFunction, X: TaggedBatch, x_meas):
    parts = []
    for tx, fx in zip(X.tags, X.features):
        d = kernel._tagged_diag(fx, tx, x_meas)
        if d is None:
            n = jax.tree_util.tree_leaves(fx)[0].shape[0]
            d = jnp.zeros((n,))
        parts.append(d)
    stacked = jnp.concatenate(parts)
    inv_x = jnp.asarray(np.argsort(np.asarray(X.order)))
    return stacked[inv_x]


def concatenate_mixed_datasets(datasets, tags=None):
    """Concatenate datasets of *different feature kinds* into one tagged
    dataset — the analog of the reference's type-promoting concatenation
    (core/concatenate.hpp: vector<X> + vector<Y> -> vector<variant<X, Y>>).

    ``tags`` assigns the variant tag per dataset (defaults to 0..k-1).
    """
    import numpy as _np

    from ..core.dataset import RegressionDataset
    from ..core.distributions import concatenate_marginals

    if tags is None:
        tags = list(range(len(datasets)))
    if len(set(tags)) != len(tags):
        raise ValueError("tags must be distinct per dataset")
    sizes = [d.size for d in datasets]
    tag_array = _np.concatenate(
        [_np.full(s, t) for s, t in zip(sizes, tags)]
    )
    batch = TaggedBatch.create(
        tag_array, {t: d.features for t, d in zip(tags, datasets)}
    )
    targets = concatenate_marginals([d.targets for d in datasets])
    metadata = {}
    for d in datasets:
        metadata.update(d.metadata)
    return RegressionDataset(batch, targets, metadata)
