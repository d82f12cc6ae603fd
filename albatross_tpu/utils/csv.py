"""CSV I/O for datasets and predictions.

JAX counterpart of
/root/reference/include/albatross/src/utils/csv_utils.hpp:29-270 (write side)
and the fast-cpp-csv-parser usage in the reference examples (read side).

The reference reflects arbitrary feature structs through a cereal-XML trick;
here features are structured arrays, so columns are explicit.  Reading
prefers the native C++ parser (albatross_tpu._native) when built, falling
back to NumPy.
"""

from __future__ import annotations

import csv
from typing import Dict, Optional, Sequence

import jax
import numpy as np

from ..core.dataset import RegressionDataset
from ..core.distributions import MarginalDistribution


def _feature_columns(features, to_map=None) -> Dict[str, list]:
    if to_map is not None:
        # custom per-feature -> {column: value} reflection
        # (csv_utils.hpp to_map customization, test_csv_utils.cc:216-274)
        X = np.asarray(jax.device_get(features))
        rows = [to_map(X[i]) for i in range(X.shape[0])]
        names = sorted({k for row in rows for k in row})
        return {name: [row.get(name, "") for row in rows] for name in names}
    X = np.asarray(jax.device_get(features))
    if X.ndim == 1:
        return {"feature": list(X)}
    return {f"feature_{i}": list(X[:, i]) for i in range(X.shape[1])}


def _dataset_columns(dataset, predictions, to_map) -> Dict[str, list]:
    columns = _feature_columns(dataset.features, to_map)
    columns["target"] = list(
        np.asarray(jax.device_get(dataset.targets.mean))
    )
    if dataset.targets.variance is not None:
        columns["target_variance"] = list(
            np.asarray(jax.device_get(dataset.targets.variance))
        )
    if predictions is not None:
        columns["prediction"] = list(
            np.asarray(jax.device_get(predictions.mean))
        )
        columns["prediction_variance"] = list(
            np.asarray(jax.device_get(predictions.get_variance()))
        )
    n = len(columns["target"])
    for key, value in dataset.metadata.items():
        # metadata is constant per dataset -> one repeated column
        # (csv_utils.hpp metadata columns, test_csv_utils.cc:192-214)
        columns[key] = [value] * n
    return columns


def _write_columns(path_or_stream, columns: Dict[str, list]) -> None:
    close = False
    if isinstance(path_or_stream, str):
        stream = open(path_or_stream, "w", newline="")
        close = True
    else:
        stream = path_or_stream
    try:
        writer = csv.writer(stream)
        names = list(columns)
        writer.writerow(names)
        n = len(columns[names[0]])
        for i in range(n):
            row = []
            for name in names:
                v = columns[name][i]
                row.append(repr(float(v)) if isinstance(v, (int, float, np.floating)) else str(v))
            writer.writerow(row)
    finally:
        if close:
            stream.close()


def write_to_csv(
    path_or_stream,
    dataset,
    predictions=None,
    to_map=None,
) -> None:
    """Dataset(s) or raw matrix (+ optional held-out predictions) -> CSV
    (csv_utils.hpp:29-270 write_to_csv overloads):

    - single ``RegressionDataset`` [+ ``MarginalDistribution`` predictions];
    - a sequence of datasets [+ matching predictions]: one concatenated CSV
      whose columns include the union of per-dataset metadata keys
      (test_csv_utils.cc:192-214);
    - a bare 2-D array (test_csv_utils.cc:276-284);
    - ``to_map``: feature-row -> {column: str} custom reflection.
    """
    if isinstance(dataset, RegressionDataset):
        _write_columns(
            path_or_stream, _dataset_columns(dataset, predictions, to_map)
        )
        return
    if isinstance(dataset, (list, tuple)):
        if predictions is not None and len(predictions) != len(dataset):
            raise ValueError(
                f"got {len(dataset)} datasets but {len(predictions)} "
                "prediction sets"
            )
        preds = (
            predictions
            if predictions is not None
            else [None] * len(dataset)
        )
        blocks = [
            _dataset_columns(d, p, to_map) for d, p in zip(dataset, preds)
        ]
        names = sorted({k for b in blocks for k in b})
        merged: Dict[str, list] = {name: [] for name in names}
        for block in blocks:
            n = len(next(iter(block.values())))
            for name in names:
                merged[name].extend(block.get(name, [""] * n))
        _write_columns(path_or_stream, merged)
        return
    # raw matrix
    X = np.asarray(jax.device_get(dataset))
    if X.ndim != 2:
        raise TypeError(
            "write_to_csv expects a RegressionDataset, a sequence of them, "
            "or a 2-D array"
        )
    _write_columns(
        path_or_stream, {f"col_{j}": list(X[:, j]) for j in range(X.shape[1])}
    )


def read_csv_columns(path: str) -> Dict[str, np.ndarray]:
    """Column name -> float array.  Uses the native parser when available."""
    try:
        from .._native import parse_csv  # C++ fast path

        return parse_csv(path)
    except Exception:
        with open(path, newline="") as f:
            reader = csv.reader(f)
            header = next(reader)
            rows = [row for row in reader if row]
        data = np.asarray(rows, dtype=np.float64)
        return {name: data[:, i] for i, name in enumerate(header)}


def read_csv_dataset(
    path: str,
    feature_columns: Sequence[str],
    target_column: str = "target",
    variance_column: Optional[str] = None,
) -> RegressionDataset:
    import jax.numpy as jnp

    columns = read_csv_columns(path)
    feats = np.stack([columns[c] for c in feature_columns], axis=1)
    if feats.shape[1] == 1:
        feats = feats[:, 0]
    variance = (
        jnp.asarray(columns[variance_column])
        if variance_column is not None and variance_column in columns
        else None
    )
    return RegressionDataset.create(
        jnp.asarray(feats), jnp.asarray(columns[target_column]), variance
    )
