"""Block-structured solvers.

JAX re-design of
/root/reference/include/albatross/src/linalg/block_diagonal.hpp:24-313 and
block_symmetric.hpp:36-120.

``BlockDiagonal`` stacks its blocks into one (G, b, b) tensor (identity-padded
to a shared size) so factorization and solves are *batched* Cholesky /
triangular-solve calls — XLA turns these into parallel batched work, replacing
the reference's per-block ThreadPool loop.  ``BlockSymmetric`` implements the
Schur-complement 2×2 solve used by incremental GP updates.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular


def pad_blocks(blocks: Sequence[jnp.ndarray]):
    """Stack ragged SPD blocks into (G, b_max, b_max), identity-padding."""
    sizes = [b.shape[0] for b in blocks]
    b_max = max(sizes)
    padded = []
    for b in blocks:
        k = b.shape[0]
        if k < b_max:
            eye_pad = jnp.eye(b_max, dtype=b.dtype)
            eye_pad = eye_pad.at[:k, :k].set(b)
            padded.append(eye_pad)
        else:
            padded.append(b)
    return jnp.stack(padded), jnp.asarray(sizes)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class BlockDiagonal:
    """Block-diagonal matrix as a stacked tensor (block_diagonal.hpp:24-120)."""

    blocks: jax.Array  # (G, b, b), identity-padded
    sizes: jax.Array  # (G,) true block sizes

    def tree_flatten(self):
        return (self.blocks, self.sizes), None

    @classmethod
    def tree_unflatten(cls, _, children):
        return cls(*children)

    @classmethod
    def from_blocks(cls, blocks: Sequence[jnp.ndarray]) -> "BlockDiagonal":
        stacked, sizes = pad_blocks(blocks)
        return cls(stacked, sizes)

    @property
    def num_blocks(self) -> int:
        return self.blocks.shape[0]

    @property
    def rows(self) -> int:
        return int(jnp.sum(self.sizes))

    def _mask(self):
        b = self.blocks.shape[1]
        idx = jnp.arange(b)
        return idx[None, :] < self.sizes[:, None]  # (G, b)

    def diagonal(self) -> jnp.ndarray:
        """Concatenated block diagonals (block_diagonal.hpp diagonal)."""
        diags = jnp.diagonal(self.blocks, axis1=1, axis2=2)  # (G, b)
        mask = self._mask()
        parts = []
        sizes = jax.device_get(self.sizes)
        for g in range(self.num_blocks):
            parts.append(diags[g, : int(sizes[g])])
        del mask
        return jnp.concatenate(parts)

    def matmul(self, rhs: jnp.ndarray) -> jnp.ndarray:
        """Block-diagonal @ dense rhs (block_diagonal.hpp operator*)."""
        b = self.blocks.shape[1]
        rhs2 = rhs if rhs.ndim > 1 else rhs[:, None]
        chunks = _split_pad(rhs2, self.sizes, b)
        out = jnp.einsum("gij,gjm->gim", self.blocks, chunks)
        dense = _unsplit(out, self.sizes)
        return dense if rhs.ndim > 1 else dense[:, 0]

    def __matmul__(self, rhs):
        return self.matmul(rhs)

    def to_dense(self) -> jnp.ndarray:
        n = self.rows
        out = jnp.zeros((n, n), dtype=self.blocks.dtype)
        offset = 0
        sizes = jax.device_get(self.sizes)
        for g in range(self.num_blocks):
            k = int(sizes[g])
            out = out.at[offset : offset + k, offset : offset + k].set(
                self.blocks[g, :k, :k]
            )
            offset += k
        return out

    def factorize(self) -> "BlockDiagonalCholesky":
        return BlockDiagonalCholesky(
            jnp.linalg.cholesky(self.blocks), self.sizes
        )


def _split_pad(rhs, sizes, b):
    """Split a dense (n, m) rhs into padded (G, b, m) chunks."""
    chunks = []
    offset = 0
    for k in [int(s) for s in jax.device_get(sizes)]:
        chunk = rhs[offset : offset + k]
        if k < b:
            chunk = jnp.concatenate(
                [chunk, jnp.zeros((b - k,) + chunk.shape[1:], chunk.dtype)]
            )
        chunks.append(chunk)
        offset += k
    return jnp.stack(chunks)


def _unsplit(chunks, sizes):
    parts = []
    for g, k in enumerate(int(s) for s in jax.device_get(sizes)):
        parts.append(chunks[g, :k])
    return jnp.concatenate(parts, axis=0)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class BlockDiagonalCholesky:
    """Batched per-block Cholesky (block_diagonal.hpp:122-313)."""

    L: jax.Array  # (G, b, b) with identity padding
    sizes: jax.Array

    def tree_flatten(self):
        return (self.L, self.sizes), None

    @classmethod
    def tree_unflatten(cls, _, children):
        return cls(*children)

    @property
    def rows(self) -> int:
        return int(jnp.sum(self.sizes))

    def _batched_solve(self, rhs, transpose: bool):
        b = self.L.shape[1]
        chunks = _split_pad(rhs if rhs.ndim > 1 else rhs[:, None], self.sizes, b)
        if transpose:
            out = jax.vmap(
                lambda Lg, rg: solve_triangular(Lg.T, rg, lower=False)
            )(self.L, chunks)
        else:
            out = jax.vmap(lambda Lg, rg: solve_triangular(Lg, rg, lower=True))(
                self.L, chunks
            )
        dense = _unsplit(out, self.sizes)
        return dense if rhs.ndim > 1 else dense[:, 0]

    def sqrt_solve(self, rhs):
        """L⁻¹ rhs blockwise."""
        return self._batched_solve(rhs, transpose=False)

    def sqrt_transpose_solve(self, rhs):
        return self._batched_solve(rhs, transpose=True)

    def solve(self, rhs):
        return self.sqrt_transpose_solve(self.sqrt_solve(rhs))

    def log_determinant(self):
        mask = (
            jnp.arange(self.L.shape[1])[None, :]
            < self.sizes[:, None]
        )
        from .compensated import accurate_sum_of_logs

        diags = jnp.diagonal(self.L, axis1=1, axis2=2)
        return 2.0 * accurate_sum_of_logs(diags, where=mask)

    def l1_norm(self) -> float:
        """||A||₁ of the factorized matrix: max abs column sum, which for a
        block-diagonal matrix is the max over blocks
        (block_diagonal.hpp:220-228).

        Eager-only (like the reference's double-returning API): calls
        ``float`` on device values and raises ConcretizationTypeError under
        jit/vmap."""
        b = self.L.shape[1]
        A = jax.vmap(lambda Lg: Lg @ Lg.T)(self.L)
        col_valid = jnp.arange(b)[None, :] < self.sizes[:, None]
        # zero out padded rows/cols before the column sums
        A = jnp.where(col_valid[:, :, None] & col_valid[:, None, :], A, 0.0)
        col_sums = jnp.sum(jnp.abs(A), axis=1)  # (G, b)
        return float(jnp.max(jnp.where(col_valid, col_sums, -jnp.inf)))

    def rcond(self, max_iterations: int = 5) -> float:
        """Reciprocal L1 condition estimate, 1/(||A||₁·est‖A⁻¹‖₁), via
        Hager's one-norm estimator driven by block solves — the batched
        re-design of Eigen's rcond_estimate_helper
        (block_diagonal.hpp:220-228).

        Eager-only, like ``l1_norm`` (the estimator's data-dependent stopping
        rule syncs each iteration); raises ConcretizationTypeError under jit.
        Follows Higham Alg. 2.4: the estimate is kept monotone (max over
        iterations) and the loop breaks when it stops increasing; zero
        entries of y take sign +1."""
        n = self.rows
        x = jnp.full((n,), 1.0 / n)
        est = 0.0
        for _ in range(max_iterations):
            y = self.solve(x)
            new_est = float(jnp.sum(jnp.abs(y)))
            if new_est <= est:  # estimate stopped increasing (Higham 2.4)
                break
            est = new_est
            xi = jnp.where(y >= 0, 1.0, -1.0)  # sign with sign(0) := +1
            z = self.solve(xi)  # A symmetric: Aᵀ-solve == solve
            if float(jnp.max(jnp.abs(z))) <= float(z @ x):
                break
            x = jnp.zeros((n,)).at[int(jnp.argmax(jnp.abs(z)))].set(1.0)
        denom = self.l1_norm() * est
        return float("inf") if denom == 0.0 else 1.0 / denom


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DiagonalCholesky:
    """Degenerate all-singleton-blocks case (FITC): A = diag(d).

    Same capability surface as BlockDiagonalCholesky but fully vectorized —
    every solve is an elementwise divide.
    """

    sqrt_diag: jax.Array  # (n,)

    def tree_flatten(self):
        return (self.sqrt_diag,), None

    @classmethod
    def tree_unflatten(cls, _, children):
        return cls(children[0])

    @property
    def rows(self) -> int:
        return self.sqrt_diag.shape[0]

    def _div(self, rhs):
        if rhs.ndim > 1:
            return rhs / self.sqrt_diag[:, None]
        return rhs / self.sqrt_diag

    def sqrt_solve(self, rhs):
        return self._div(rhs)

    def sqrt_transpose_solve(self, rhs):
        return self._div(rhs)

    def solve(self, rhs):
        return self._div(self._div(rhs))

    def log_determinant(self):
        from .compensated import accurate_sum_of_logs

        return 2.0 * accurate_sum_of_logs(self.sqrt_diag)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class BlockSymmetric:
    """2×2 symmetric block solve via Schur complement
    (block_symmetric.hpp:36-120).

    Represents M = [A  B; Bᵀ C] through A's factorization, Ai_B = A⁻¹B and
    the factorized Schur complement S = C − BᵀA⁻¹B — the machinery behind
    incremental GP updates (grow the training covariance without
    refactorizing the old block).
    """

    A: Any  # any object with .solve / .log_determinant (CholeskyFactor, ...)
    Ai_B: jax.Array
    S: Any  # factorization of the Schur complement

    def tree_flatten(self):
        return (self.A, self.Ai_B, self.S), None

    @classmethod
    def tree_unflatten(cls, _, children):
        return cls(*children)

    @property
    def rows(self) -> int:
        return self.Ai_B.shape[0] + self.Ai_B.shape[1]

    def solve(self, rhs):
        rhs2d = rhs if rhs.ndim > 1 else rhs[:, None]
        n_a = self.Ai_B.shape[0]
        x, y = rhs2d[:n_a], rhs2d[n_a:]
        v = self.S.solve(y - self.Ai_B.T @ x)
        u = self.A.solve(x) - self.Ai_B @ v
        out = jnp.concatenate([u, v], axis=0)
        return out if rhs.ndim > 1 else out[:, 0]

    def log_determinant(self):
        return self.A.log_determinant() + self.S.log_determinant()


def build_block_symmetric(A, B: jnp.ndarray, S_chol) -> BlockSymmetric:
    """Assemble from A's factorization, the cross block B, and the already-
    factorized Schur complement (gp.hpp:384-414 passes S = predicted joint
    covariance + new target variance, which *is* C − BᵀA⁻¹B)."""
    return BlockSymmetric(A, A.solve(B), S_chol)


def build_block_symmetric_from_C(A, B: jnp.ndarray, C: jnp.ndarray):
    """The reference's other overload (block_symmetric.hpp:36-60): pass the
    raw lower-right block C; the Schur complement S = C − BᵀA⁻¹B is
    computed and factorized here."""
    from .linalg import CholeskyFactor

    Ai_B = A.solve(B)
    S = C - B.T @ Ai_B
    return BlockSymmetric(A, Ai_B, CholeskyFactor.factorize(S))


# ---------------------------------------------------------------------------
# Grouped block utilities (linalg/block_utils.hpp:24-150) — the building
# blocks of patchwork-GP-style clustered computations.
# ---------------------------------------------------------------------------
def block_sum(blocks):
    """Sum of same-shaped blocks (Grouped values or a sequence)."""
    values = blocks.values() if hasattr(blocks, "values") else list(blocks)
    out = values[0]
    for v in values[1:]:
        out = out + v
    return out


def block_accumulate(lhs, rhs, apply_function):
    """sum_key apply_function(lhs[key], rhs[key]) (block_utils.hpp:44-70)."""
    keys = lhs.keys()
    assert len(keys) == len(rhs.keys()) and len(keys) > 0
    return block_sum([apply_function(lhs[k], rhs[k]) for k in keys])


def block_product(lhs, rhs):
    """[x_0 ... x_n] @ [y_0; ...; y_n] over aligned group keys."""
    return block_accumulate(lhs, rhs, lambda x, y: x @ y)


def block_inner_product(lhs, rhs):
    """[x_0ᵀ ... x_nᵀ] @ [y_0; ...; y_n] over aligned group keys."""
    return block_accumulate(lhs, rhs, lambda x, y: x.T @ y)


def block_diag_solve(solvers, rhs):
    """Per-group solver[key].solve(rhs[key]) (block_utils.hpp:120-140)."""
    return rhs.apply(lambda key, value: solvers[key].solve(value))


def block_subtract(lhs, rhs):
    return rhs.apply(lambda key, value: lhs[key] - value)
