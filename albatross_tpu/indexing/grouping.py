"""Split-apply-combine over datasets and feature batches.

JAX re-design of
/root/reference/include/albatross/src/indexing/group_by.hpp:67-620 and
subset.hpp:22-215.

Group keys are computed host-side (they drive *structure* — fold shapes,
block sizes — which must be static for XLA); the grouped *values* stay on
device.  ``Grouped`` preserves the reference's sorted-by-key (std::map)
iteration order.  Group-parallel apply maps to vmap/shard over the group
axis where sizes are uniform, replacing the reference's ThreadPool loop.
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, List, Sequence, TypeVar

import jax
import jax.numpy as jnp
import numpy as np

from ..core.dataset import RegressionDataset, subset_features

K = TypeVar("K")
V = TypeVar("V")


class Grouped(Generic[K, V]):
    """Ordered (sorted-key) mapping with apply/filter/combine helpers
    (group_by.hpp:67-343)."""

    def __init__(self, items: Dict[K, V] | Sequence[tuple] = ()):
        data = dict(items)
        self._data = {k: data[k] for k in sorted(data, key=_sort_key)}

    # -- mapping protocol ---------------------------------------------------
    def __getitem__(self, key: K) -> V:
        return self._data[key]

    def __contains__(self, key: K) -> bool:
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def items(self):
        return self._data.items()

    def keys(self) -> List[K]:
        return list(self._data.keys())

    def values(self) -> List[V]:
        return list(self._data.values())

    def get_map(self) -> Dict[K, V]:
        return dict(self._data)

    # -- split-apply-combine ------------------------------------------------
    def apply(self, fn: Callable) -> "Grouped":
        """fn(value) or fn(key, value) per group (arity-dispatched)."""
        binary = _accepts_two_args(fn)
        out = {}
        for key, value in self._data.items():
            out[key] = fn(key, value) if binary else fn(value)
        return Grouped(out)

    def filter(self, predicate: Callable) -> "Grouped":
        binary = _accepts_two_args(predicate)
        out = {}
        for key, value in self._data.items():
            keep = predicate(key, value) if binary else predicate(value)
            if keep:
                out[key] = value
        return Grouped(out)

    def first_value(self) -> V:
        return next(iter(self._data.values()))

    def last_value(self) -> V:
        return next(reversed(self._data.values()))

    def first_group(self) -> tuple:
        """(key, value) of the first (sorted) group (group_by.hpp)."""
        return next(iter(self._data.items()))

    def erase(self, key: K) -> "Grouped":
        """Copy without ``key`` (the reference mutates; here functional)."""
        return Grouped({k: v for k, v in self._data.items() if k != key})

    def with_(self, other) -> "Grouped":
        """Zip per-key with another key-aligned mapping → (value, other)
        pairs (group_by.hpp ::with)."""
        return Grouped(
            {k: (v, other[k]) for k, v in self._data.items()}
        )

    def counts(self) -> "Grouped":
        return self.apply(lambda v: len(v))

    # -- numeric reductions (group_by.hpp numeric specializations) ----------
    def sum(self):
        return sum(self._data.values())

    def mean(self):
        return self.sum() / len(self)

    def min(self):
        return min(self._data.values())

    def max(self):
        return max(self._data.values())

    # explicit value/key variants (group_by.hpp min_value/max_value/
    # min_key/max_key)
    def min_value(self):
        return self.min()

    def max_value(self):
        return self.max()

    def min_key(self) -> K:
        return min(self._data.items(), key=lambda kv: kv[1])[0]

    def max_key(self) -> K:
        return max(self._data.items(), key=lambda kv: kv[1])[0]

    def any(self) -> bool:
        return any(bool(v) for v in self._data.values())

    def all(self) -> bool:
        return all(bool(v) for v in self._data.values())

    def combine(self):
        """Concatenate per-group values back into one object, ordered by
        sorted group key (group_by.hpp combine)."""
        values = self.values()
        first = values[0]
        if isinstance(first, RegressionDataset):
            from ..core.dataset import concatenate_datasets

            return concatenate_datasets(values)
        from ..core.distributions import MarginalDistribution

        if isinstance(first, MarginalDistribution):
            from ..core.distributions import concatenate_marginals

            return concatenate_marginals(values)
        if isinstance(first, (jax.Array, np.ndarray)):
            return jnp.concatenate([jnp.atleast_1d(v) for v in values])
        return values

    def __repr__(self):
        return f"Grouped(n_groups={len(self)})"


def _accepts_two_args(fn: Callable) -> bool:
    """Arity inspection beats try/except TypeError dispatch, which would
    silently mask TypeErrors raised *inside* the callback."""
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    required = [
        p
        for p in sig.parameters.values()
        if p.kind
        in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
        and p.default is p.empty
    ]
    if any(p.kind == p.VAR_POSITIONAL for p in sig.parameters.values()):
        return True
    return len(required) >= 2


def _sort_key(k):
    # mixed int/str keys: sort by (typename, value) for determinism
    return (type(k).__name__, k)


# ---------------------------------------------------------------------------
# Groupers (group_by.hpp:379-444)
# ---------------------------------------------------------------------------
class LeaveOneOutGrouper:
    """Every element is its own group: key = position."""

    def __call__(self, features) -> np.ndarray:
        n = jax.tree_util.tree_leaves(features)[0].shape[0]
        return np.arange(n)


class KFoldGrouper:
    """Round-robin assignment into k folds."""

    def __init__(self, k: int):
        self.k = int(k)

    def __call__(self, features) -> np.ndarray:
        n = jax.tree_util.tree_leaves(features)[0].shape[0]
        return np.arange(n) % self.k


def compute_keys(features, grouper) -> np.ndarray:
    """Apply a grouper; accepts batch-level groupers (array in → keys out)
    or per-element functions."""
    keys = grouper(features)
    keys = np.asarray(jax.device_get(keys))
    return keys


class GroupBy:
    """Result of group_by (group_by.hpp:449-620)."""

    def __init__(self, parent, keys: np.ndarray):
        self.parent = parent
        self.keys = keys
        uniq = sorted(set(keys.tolist()), key=_sort_key)
        self._indexers = Grouped(
            {
                key: np.nonzero(keys == key)[0].astype(np.int64)
                for key in uniq
            }
        )

    def indexers(self) -> Grouped:
        return self._indexers

    def groups(self) -> Grouped:
        if isinstance(self.parent, RegressionDataset):
            return self._indexers.apply(
                lambda idx: self.parent.subset(jnp.asarray(idx))
            )
        return self._indexers.apply(
            lambda idx: subset_features(self.parent, jnp.asarray(idx))
        )

    def counts(self) -> Grouped:
        return self._indexers.apply(lambda idx: int(idx.shape[0]))

    def apply(self, fn: Callable) -> Grouped:
        return self.groups().apply(fn)

    def index_apply(self, fn: Callable) -> Grouped:
        return self._indexers.apply(fn)

    def get_group(self, key):
        """The feature/dataset subset of one group (group_by.hpp)."""
        return self.groups()[key]

    def first_group(self) -> tuple:
        return self.groups().first_group()

    def with_(self, other) -> Grouped:
        """Per-group pairing (group_by.hpp ::with): ``other`` is either a
        parallel sequence (same length as the grouped data — split by the
        same indexers) or an already key-aligned Grouped/mapping."""
        if isinstance(other, (list, tuple, np.ndarray, jax.Array)) and len(
            other
        ) == len(self.keys):
            paired = self._indexers.apply(
                lambda idx: [other[int(i)] for i in idx]
                if isinstance(other, (list, tuple))
                else jnp.asarray(other)[jnp.asarray(idx)]
            )
        elif isinstance(other, Grouped):
            paired = other
        else:
            paired = Grouped(other)
        return self.groups().with_(paired)

    def filter(self, predicate: Callable):
        kept = self.groups().filter(predicate)
        if isinstance(self.parent, RegressionDataset):
            return kept.combine()
        return kept


def group_by(data, grouper) -> GroupBy:
    """group_by over a RegressionDataset or a feature batch."""
    features = data.features if isinstance(data, RegressionDataset) else data
    return GroupBy(data, compute_keys(features, grouper))


# ---------------------------------------------------------------------------
# Index utilities (subset.hpp, unique.hpp)
# ---------------------------------------------------------------------------
def indices_complement(indices, n: int) -> np.ndarray:
    mask = np.ones(n, dtype=bool)
    mask[np.asarray(indices)] = False
    return np.nonzero(mask)[0]


def indices_from_groups(indexers: Grouped, keys: Sequence) -> np.ndarray:
    parts = [indexers[k] for k in keys]
    return np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)


def unique_values(values) -> List:
    return sorted(set(np.asarray(jax.device_get(values)).tolist()), key=_sort_key)


def unique_value(values):
    uniq = unique_values(values)
    if len(uniq) != 1:
        raise ValueError(f"expected exactly one unique value, got {len(uniq)}")
    return uniq[0]
