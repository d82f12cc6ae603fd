"""Covariance-function combinator algebra.

JAX re-design of the reference covariance DSL
(/root/reference/include/albatross/src/covariance_functions/covariance_function.hpp:63-437
 and callers.hpp:196-592).

The reference dispatches scalar ``_call_impl(x, y)`` per feature pair through
a compile-time caller chain (symmetry / Measurement unwrap / LinearCombination
integration / variant visitation).  Here each kernel implements *batch-level*
``_matrix(X, Y, x_meas, y_meas) -> (N, M) array or None`` so Gram assembly is
a handful of fused XLA ops, and the caller chain becomes explicit
runtime logic in ``CovarianceFunction.__call__``:

* Measurement tags are batch-level wrappers, unwrapped here and passed down as
  flags (callers.hpp MeasurementForwarder).
* LinearCombination batches are integrated by evaluating one gram over the
  flattened base features and contracting with the coefficients
  (callers.hpp LinearCombinationCaller).
* ``None`` from ``_matrix`` means "undefined for this pair"; composition nodes
  fall back to the defined side, and a fully-undefined call raises — keeping
  the reference's "undefined pair = error, not zero" safety property
  (covariance_function.hpp:112-123).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from ..core.module import Module
from .features import LinearCombinationBatch, strip_measurement


class CovarianceFunction(Module):
    """Base class for covariance kernels."""

    # -- to be implemented by concrete kernels ------------------------------
    def _matrix(self, X, Y, x_meas: bool, y_meas: bool) -> Optional[jnp.ndarray]:
        raise NotImplementedError

    def _diag(self, X, x_meas: bool) -> Optional[jnp.ndarray]:
        """Diagonal of the self-covariance; defaults to the dense diagonal
        (kernels override with an O(N) path)."""
        full = self._matrix(X, X, x_meas, x_meas)
        return None if full is None else jnp.diagonal(full)

    # -- public evaluation --------------------------------------------------
    def __call__(self, X, Y=None) -> jnp.ndarray:
        symmetric = Y is None
        result = self.matrix_or_none(X, X if symmetric else Y)
        if result is None:
            raise TypeError(
                f"covariance {self.name} is undefined for these feature types"
            )
        if symmetric and not self._symmetric_exact(X):
            # The reference fills the lower triangle and mirrors
            # (callers.hpp:107-129); symmetrizing removes epsilon-level
            # asymmetry from matmul-reduction paths and protects Cholesky.
            # Kernels whose formulas are elementwise-symmetric skip this
            # (saves an N² transpose+add pass over device memory).
            result = 0.5 * (result + result.T)
        return result

    def _symmetric_exact(self, X) -> bool:
        """True when _matrix(X, X) is bitwise symmetric by construction.
        Conservative default: composition nodes require all children exact;
        leaves with purely elementwise formulas return True."""
        return True

    # -- variant-tag dispatch (kernels/variants.py) -------------------------
    def _tagged_matrix(self, X, Y, tx, ty, x_meas, y_meas):
        """Per-tag-pair block; plain kernels are tag-agnostic (they apply to
        any sub-batch, like albatross templates accepting any type)."""
        return self._matrix(X, Y, x_meas, y_meas)

    def _tagged_diag(self, X, tx, x_meas):
        return self._diag(X, x_meas)

    def matrix_or_none(self, X, Y) -> Optional[jnp.ndarray]:
        X, x_meas = strip_measurement(X)
        Y, y_meas = strip_measurement(Y)

        from .variants import TaggedBatch, tagged_gram

        if isinstance(X, TaggedBatch) or isinstance(Y, TaggedBatch):
            if not isinstance(X, TaggedBatch):
                return tagged_gram(self, Y, X, y_meas, x_meas).T
            return tagged_gram(self, X, Y, x_meas, y_meas)

        x_lc = isinstance(X, LinearCombinationBatch)
        y_lc = isinstance(Y, LinearCombinationBatch)
        if x_lc or y_lc:
            return self._linear_combination_matrix(X, Y, x_meas, y_meas)
        return self._matrix(X, Y, x_meas, y_meas)

    def _linear_combination_matrix(self, X, Y, x_meas, y_meas):
        """Integrate over combination axes: K = C_x G C_yᵀ
        (callers.hpp LinearCombinationCaller)."""
        if isinstance(X, LinearCombinationBatch):
            base = self._linear_combination_matrix(
                X.flat_values(), Y, x_meas, y_meas
            )
            if base is None:
                return None
            n, k = X.coefficients.shape
            base = base.reshape(n, k, -1)
            return jnp.einsum("nk,nkm->nm", X.coefficients, base)
        if isinstance(Y, LinearCombinationBatch):
            base = self._linear_combination_matrix(
                X, Y.flat_values(), x_meas, y_meas
            )
            if base is None:
                return None
            m, k = Y.coefficients.shape
            base = base.reshape(-1, m, k)
            return jnp.einsum("mk,nmk->nm", Y.coefficients, base)
        return self._matrix(X, Y, x_meas, y_meas)

    def diag(self, X) -> jnp.ndarray:
        X, x_meas = strip_measurement(X)
        from .variants import TaggedBatch, tagged_diag

        if isinstance(X, TaggedBatch):
            return tagged_diag(self, X, x_meas)
        if isinstance(X, LinearCombinationBatch):
            # diag of C G Cᵀ per combination: small dense blocks.
            flat = X.flat_values()
            base = self._matrix(flat, flat, x_meas, x_meas)
            if base is None:
                raise TypeError(f"{self.name}: undefined feature type")
            n, k = X.coefficients.shape
            blocks = base.reshape(n, k, n, k)
            idx = jnp.arange(n)
            per = blocks[idx, :, idx, :]  # (n, k, k)
            return jnp.einsum("nk,nkl,nl->n", X.coefficients, per, X.coefficients)
        result = self._diag(X, x_meas)
        if result is None:
            raise TypeError(f"{self.name}: undefined feature type")
        return result

    # -- composition --------------------------------------------------------
    def __add__(self, other):
        return SumKernel(self, _as_kernel(other))

    def __radd__(self, other):
        return SumKernel(_as_kernel(other), self)

    def __mul__(self, other):
        return ProductKernel(self, _as_kernel(other))

    def __rmul__(self, other):
        return ProductKernel(_as_kernel(other), self)

    # -- inducing-point grids ----------------------------------------------
    def state_space_representation(self, X):
        """1-D inducing grid for this kernel (radial.hpp:158-168); None if
        the kernel has no meaningful SSR."""
        return None

    # -- introspection ------------------------------------------------------
    def call_trace(self, x, y) -> "CallTreeNode":
        """Evaluate the full expression tree for a single feature pair
        (call_trace.hpp:20-219)."""
        return _trace(self, x, y)

    def pretty_string(self, indent: int = 0) -> str:
        return "  " * indent + self.name


class SumKernel(CovarianceFunction):
    """k1 + k2 (covariance_function.hpp:222-330)."""

    def __init__(self, lhs: CovarianceFunction, rhs: CovarianceFunction):
        self.lhs = lhs
        self.rhs = rhs

    @property
    def name(self):
        return f"({self.lhs.name}+{self.rhs.name})"

    def _matrix(self, X, Y, x_meas, y_meas):
        a = self.lhs._matrix(X, Y, x_meas, y_meas)
        b = self.rhs._matrix(X, Y, x_meas, y_meas)
        if a is None:
            return b
        if b is None:
            return a
        return a + b

    def _symmetric_exact(self, X):
        return self.lhs._symmetric_exact(X) and self.rhs._symmetric_exact(X)

    def _tagged_matrix(self, X, Y, tx, ty, x_meas, y_meas):
        a = self.lhs._tagged_matrix(X, Y, tx, ty, x_meas, y_meas)
        b = self.rhs._tagged_matrix(X, Y, tx, ty, x_meas, y_meas)
        if a is None:
            return b
        if b is None:
            return a
        return a + b

    def _tagged_diag(self, X, tx, x_meas):
        a = self.lhs._tagged_diag(X, tx, x_meas)
        b = self.rhs._tagged_diag(X, tx, x_meas)
        if a is None:
            return b
        if b is None:
            return a
        return a + b

    def _diag(self, X, x_meas):
        a = self.lhs._diag(X, x_meas)
        b = self.rhs._diag(X, x_meas)
        if a is None:
            return b
        if b is None:
            return a
        return a + b

    def state_space_representation(self, X):
        return _concat_ssr(
            self.lhs.state_space_representation(X),
            self.rhs.state_space_representation(X),
        )


class ProductKernel(CovarianceFunction):
    """k1 * k2; if only one side is defined for a pair, it acts alone
    (covariance_function.hpp:332-437)."""

    def __init__(self, lhs: CovarianceFunction, rhs: CovarianceFunction):
        self.lhs = lhs
        self.rhs = rhs

    @property
    def name(self):
        return f"({self.lhs.name}*{self.rhs.name})"

    def _matrix(self, X, Y, x_meas, y_meas):
        a = self.lhs._matrix(X, Y, x_meas, y_meas)
        b = self.rhs._matrix(X, Y, x_meas, y_meas)
        if a is None:
            return b
        if b is None:
            return a
        return a * b

    def _symmetric_exact(self, X):
        return self.lhs._symmetric_exact(X) and self.rhs._symmetric_exact(X)

    def _tagged_matrix(self, X, Y, tx, ty, x_meas, y_meas):
        a = self.lhs._tagged_matrix(X, Y, tx, ty, x_meas, y_meas)
        b = self.rhs._tagged_matrix(X, Y, tx, ty, x_meas, y_meas)
        if a is None:
            return b
        if b is None:
            return a
        return a * b

    def _tagged_diag(self, X, tx, x_meas):
        a = self.lhs._tagged_diag(X, tx, x_meas)
        b = self.rhs._tagged_diag(X, tx, x_meas)
        if a is None:
            return b
        if b is None:
            return a
        return a * b

    def _diag(self, X, x_meas):
        a = self.lhs._diag(X, x_meas)
        b = self.rhs._diag(X, x_meas)
        if a is None:
            return b
        if b is None:
            return a
        return a * b

    def state_space_representation(self, X):
        return _concat_ssr(
            self.lhs.state_space_representation(X),
            self.rhs.state_space_representation(X),
        )


def _as_kernel(value) -> CovarianceFunction:
    if isinstance(value, CovarianceFunction):
        return value
    raise TypeError(f"cannot compose covariance with {type(value).__name__}")


def _concat_ssr(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return jnp.concatenate([jnp.atleast_1d(a), jnp.atleast_1d(b)])


# ---------------------------------------------------------------------------
# Call tracing (reference call_trace.hpp)
# ---------------------------------------------------------------------------
class CallTreeNode:
    def __init__(self, name: str, value: float, children):
        self.name = name
        self.value = value
        self.children = children

    def pretty(self, indent: int = 0) -> str:
        lines = ["  " * indent + f"{self.name}: {self.value:.6g}"]
        for child in self.children:
            lines.append(child.pretty(indent + 1))
        return "\n".join(lines)

    def __repr__(self):
        return self.pretty()


def _batch_one(feature):
    """Wrap one feature as a 1-element batch, preserving the caller-chain
    wrappers (Measurement tags, LinearCombination, variant tags) so every
    traced node sees exactly what a real gram evaluation would
    (call_trace.hpp walks the same caller chain)."""
    from .features import LinearCombinationBatch, Measurement
    from .variants import TaggedBatch

    if isinstance(feature, Measurement):
        return Measurement(_batch_one(feature.value))
    if isinstance(feature, (LinearCombinationBatch, TaggedBatch)):
        return feature  # already batch-level wrappers
    try:
        # scalar → (1,); (D,) vector feature → (1, D)
        return jnp.asarray(feature)[None]
    except (TypeError, ValueError):
        # custom feature-batch objects (ConstantTerm, user-defined variant
        # kinds) pass through unchanged — they are already batches
        return feature


def _trace(kernel: CovarianceFunction, x, y) -> CallTreeNode:
    """Full-fidelity call trace: each node is evaluated through its real
    dispatch path (``matrix_or_none``), so Measurement semantics
    (measurement_only terms nonzero for train pairs), LinearCombination
    integration, and variant-tag blocks all show their true values —
    matching the reference caller-chain walk (call_trace.hpp:20-219)."""
    Xb = _batch_one(x)
    Yb = _batch_one(y)
    result = kernel.matrix_or_none(Xb, Yb)
    value = float(jnp.ravel(result)[0]) if result is not None else float("nan")
    children = []
    for attr in ("lhs", "rhs", "sub"):
        child = getattr(kernel, attr, None)
        if isinstance(child, CovarianceFunction):
            children.append(_trace(child, x, y))
    return CallTreeNode(kernel.name, value, children)
