"""Numerical diagnostics for ill-conditioned covariances.

JAX counterpart of
/root/reference/include/albatross/src/linalg/print_eigen_directions.hpp:23-100:
dump the dominant entries of the smallest/largest eigenvectors so a user can
see *which features* drive near-singularity.
"""

from __future__ import annotations

import io

import jax
import jax.numpy as jnp
import numpy as np


def _eigen_directions(matrix, smallest: bool, k: int, top_entries: int) -> str:
    vals, vecs = jnp.linalg.eigh(0.5 * (matrix + matrix.T))
    vals = np.asarray(jax.device_get(vals))
    vecs = np.asarray(jax.device_get(vecs))
    order = np.argsort(vals)
    picks = order[:k] if smallest else order[::-1][:k]
    out = io.StringIO()
    kind = "smallest" if smallest else "largest"
    for rank, idx in enumerate(picks):
        vec = vecs[:, idx]
        dominant = np.argsort(np.abs(vec))[::-1][:top_entries]
        out.write(
            f"{kind} eigenvalue #{rank}: {vals[idx]:.6e}\n"
        )
        for j in dominant:
            out.write(f"    index {j}: {vec[j]:+.4f}\n")
    return out.getvalue()


def print_small_eigen_directions(
    matrix, k: int = 3, top_entries: int = 5, stream=None
) -> str:
    text = _eigen_directions(jnp.asarray(matrix), True, k, top_entries)
    if stream is not None:
        stream.write(text)
    return text


def print_large_eigen_directions(
    matrix, k: int = 3, top_entries: int = 5, stream=None
) -> str:
    text = _eigen_directions(jnp.asarray(matrix), False, k, top_entries)
    if stream is not None:
        stream.write(text)
    return text
