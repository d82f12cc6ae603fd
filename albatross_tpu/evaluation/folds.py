"""Cross-validation folds.

JAX re-design of
/root/reference/include/albatross/src/evaluation/folds.hpp:21-146.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp
import numpy as np

from ..core.dataset import RegressionDataset
from ..indexing.grouping import Grouped, group_by, indices_complement


@dataclasses.dataclass(frozen=True)
class RegressionFold:
    """Train/test split for one fold (folds.hpp:21-44)."""

    train_dataset: RegressionDataset
    test_dataset: RegressionDataset
    test_indices: np.ndarray
    key: Any = None


def create_fold(
    dataset: RegressionDataset, test_indices, key=None
) -> RegressionFold:
    """Complement split (folds.hpp:46-64)."""
    test_indices = np.asarray(test_indices)
    train_indices = indices_complement(test_indices, dataset.size)
    return RegressionFold(
        train_dataset=dataset.subset(jnp.asarray(train_indices)),
        test_dataset=dataset.subset(jnp.asarray(test_indices)),
        test_indices=test_indices,
        key=key,
    )


def folds_from_group_indexer(
    dataset: RegressionDataset, indexers: Grouped
) -> Grouped:
    """One fold per group (folds.hpp:66-96)."""
    return indexers.apply(
        lambda key, idx: create_fold(dataset, idx, key=key)
    )


def folds_from_grouper(dataset: RegressionDataset, grouper) -> Grouped:
    return folds_from_group_indexer(
        dataset, group_by(dataset, grouper).indexers()
    )


def leave_one_out_folds(dataset: RegressionDataset) -> Grouped:
    from ..indexing.grouping import LeaveOneOutGrouper

    return folds_from_grouper(dataset, LeaveOneOutGrouper())


def k_fold_folds(dataset: RegressionDataset, k: int) -> Grouped:
    from ..indexing.grouping import KFoldGrouper

    return folds_from_grouper(dataset, KFoldGrouper(k))
