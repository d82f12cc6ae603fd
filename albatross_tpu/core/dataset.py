"""Regression dataset container.

JAX re-design of ``RegressionDataset<FeatureType>``
(/root/reference/include/albatross/src/core/dataset.hpp:25-189).

Features are *structured arrays*: either a single ``jnp`` array with leading
axis N (shape ``(N,)`` or ``(N, D)``) or any pytree whose leaves share a
leading axis N ("struct of arrays").  This replaces the reference's
``std::vector<FeatureType>`` — batch-level layout is what lets Gram
construction run as batched array ops instead of looping over scalar ``_call_impl`` calls.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .distributions import MarginalDistribution, concatenate_marginals

Features = Any  # array or pytree-with-leading-axis


def feature_count(features: Features) -> int:
    """Leading-axis length shared by every leaf of the feature pytree.

    Structured wrappers (Measurement, TaggedBatch, LinearCombinationBatch)
    report their own logical size.
    """
    if hasattr(features, "value") and type(features).__name__ == "Measurement":
        return feature_count(features.value)
    if type(features).__name__ in ("TaggedBatch", "LinearCombinationBatch"):
        return features.size
    leaves = jax.tree_util.tree_leaves(features)
    if not leaves:
        raise ValueError("empty feature pytree")
    n = leaves[0].shape[0]
    for leaf in leaves[1:]:
        if leaf.shape[0] != n:
            raise ValueError("feature leaves disagree on leading axis")
    return n


def subset_features(features: Features, indices) -> Features:
    """Row-subset a feature batch; wrapper-aware (a TaggedBatch subsets by
    its *original interleaved* positions, not per-leaf positions)."""
    if type(features).__name__ == "Measurement":
        from ..kernels.features import Measurement

        return Measurement(subset_features(features.value, indices))
    if type(features).__name__ == "TaggedBatch":
        return _subset_tagged(features, indices)
    indices = jnp.asarray(indices)
    return jax.tree_util.tree_map(lambda leaf: leaf[indices], features)


def _subset_tagged(batch, indices):
    """Subset a TaggedBatch by original interleaved positions (host-side
    index math — this reshapes *structure*, which must be static)."""
    import numpy as _np

    from ..kernels.features import Measurement  # noqa: F401

    idx = _np.asarray(jax.device_get(jnp.asarray(indices)))
    order = _np.asarray(batch.order)
    counts = batch.counts()
    # position within the concatenated sub-batches for each original index
    pos_of_original = _np.empty(order.shape[0], dtype=_np.int64)
    pos_of_original[order] = _np.arange(order.shape[0])
    offsets = _np.concatenate([[0], _np.cumsum(counts)])

    new_features = []
    new_tags = []
    kept_per_tag = []
    for t_i, tag in enumerate(batch.tags):
        lo, hi = offsets[t_i], offsets[t_i + 1]
        positions = pos_of_original[idx]
        in_tag = (positions >= lo) & (positions < hi)
        local = positions[in_tag] - lo
        if local.shape[0] == 0:
            continue
        new_tags.append(tag)
        new_features.append(
            jax.tree_util.tree_map(
                lambda leaf: leaf[jnp.asarray(local)], batch.features[t_i]
            )
        )
        kept_per_tag.append(_np.nonzero(in_tag)[0])
    # new order: for each kept row (in new concatenated layout), its position
    # within the *selected* index list
    new_order = _np.concatenate(kept_per_tag) if kept_per_tag else _np.zeros(0, int)
    return type(batch)(
        tuple(new_tags), tuple(new_features), tuple(int(i) for i in new_order)
    )


def concatenate_features(feature_list: Sequence[Features]) -> Features:
    # TaggedBatch (variant) features concatenate tag-wise, preserving the
    # interleaved order — required for online updates that mix feature
    # kinds (reference: concatenate.hpp variant promotion).
    if feature_list and all(
        type(f).__name__ == "TaggedBatch" for f in feature_list
    ):
        from ..kernels.variants import TaggedBatch

        return TaggedBatch.concatenate(list(feature_list))
    return jax.tree_util.tree_map(
        lambda *leaves: jnp.concatenate(leaves, axis=0), *feature_list
    )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class RegressionDataset:
    """Features + target distribution + string metadata (dataset.hpp:25-80)."""

    features: Features
    targets: MarginalDistribution
    metadata: Dict[str, str] = dataclasses.field(default_factory=dict)

    def tree_flatten(self):
        return (self.features, self.targets), tuple(sorted(self.metadata.items()))

    @classmethod
    def tree_unflatten(cls, metadata, children):
        return cls(children[0], children[1], dict(metadata))

    @classmethod
    def create(
        cls,
        features: Features,
        targets,
        variance=None,
        metadata: Optional[Dict[str, str]] = None,
    ) -> "RegressionDataset":
        """Build from raw arrays; ``targets`` may be a mean vector."""
        features = jax.tree_util.tree_map(jnp.asarray, features)
        if not isinstance(targets, MarginalDistribution):
            targets = MarginalDistribution.create(targets, variance)
        n = feature_count(features)
        if targets.size != n:
            raise ValueError(
                f"features ({n}) and targets ({targets.size}) disagree"
            )
        return cls(features, targets, metadata or {})

    @property
    def size(self) -> int:
        return feature_count(self.features)

    def __len__(self) -> int:
        return self.size

    def subset(self, indices) -> "RegressionDataset":
        return RegressionDataset(
            subset_features(self.features, indices),
            self.targets.subset(indices),
            dict(self.metadata),
        )

    def __getitem__(self, indices) -> "RegressionDataset":
        return self.subset(jnp.atleast_1d(jnp.asarray(indices)))

    def with_metadata(self, **kwargs: str) -> "RegressionDataset":
        md = dict(self.metadata)
        md.update(kwargs)
        return RegressionDataset(self.features, self.targets, md)

    def __repr__(self):
        return f"RegressionDataset(n={self.size})"


def concatenate_datasets(
    datasets: Sequence[RegressionDataset],
) -> RegressionDataset:
    """Concatenate along the example axis (dataset.hpp concatenation).

    Unlike the reference there is no type promotion to variants — mixed
    feature *kinds* are expressed up front as tagged feature pytrees.
    """
    features = concatenate_features([d.features for d in datasets])
    targets = concatenate_marginals([d.targets for d in datasets])
    metadata: Dict[str, str] = {}
    for d in datasets:
        metadata.update(d.metadata)
    return RegressionDataset(features, targets, metadata)


def deduplicate(dataset: RegressionDataset) -> RegressionDataset:
    """Keep the LAST occurrence of each duplicated feature row
    (dataset.hpp:86-106: indices that 'appear later' win)."""
    leaves = jax.tree_util.tree_leaves(dataset.features)
    X = np.asarray(jax.device_get(leaves[0]))
    flat = X.reshape(X.shape[0], -1)
    keep = []
    seen: set = set()
    for i in range(flat.shape[0] - 1, -1, -1):
        key = flat[i].tobytes()
        if key not in seen:
            seen.add(key)
            keep.append(i)
    keep.reverse()
    return dataset.subset(jnp.asarray(keep))


def transform_dataset(matrix, dataset: RegressionDataset) -> RegressionDataset:
    """matrix * dataset: apply a linear transform to features AND targets
    (dataset.hpp operator*): features become LinearCombination rows, targets
    are A μ with covariance diag(A Σ Aᵀ)."""
    from ..kernels.features import LinearCombinationBatch

    matrix = jnp.asarray(matrix)
    n = dataset.size
    values = jax.tree_util.tree_map(
        lambda leaf: jnp.broadcast_to(
            leaf[None, ...], (matrix.shape[0],) + leaf.shape
        ),
        dataset.features,
    )
    features = LinearCombinationBatch(values, matrix)
    mean = matrix @ dataset.targets.mean
    variance = (matrix * matrix) @ dataset.targets.get_variance()
    return RegressionDataset(
        features, MarginalDistribution(mean, variance), dict(dataset.metadata)
    )


def align_datasets(
    a: RegressionDataset, b: RegressionDataset, key_fn
) -> tuple[RegressionDataset, RegressionDataset]:
    """Restrict both datasets to features whose keys appear in both
    (dataset.hpp:132-160).  ``key_fn(features) -> array of keys``."""
    ka = jax.device_get(key_fn(a.features))
    kb = jax.device_get(key_fn(b.features))
    common = sorted(set(ka.tolist()) & set(kb.tolist()))
    ia = [int(list(ka).index(k)) for k in common]
    ib = [int(list(kb).index(k)) for k in common]
    # explicit integer dtype: an empty intersection otherwise produces a
    # float64 empty index array, which jnp indexing rejects
    return (
        a.subset(jnp.asarray(ia, dtype=jnp.int32)),
        b.subset(jnp.asarray(ib, dtype=jnp.int32)),
    )
