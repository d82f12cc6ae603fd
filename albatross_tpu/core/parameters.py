"""Parameter store and tunable-vector round trip.

JAX re-design of the reference parameter system
(/root/reference/include/albatross/src/core/parameters.hpp:21-305,
 parameter_handling_mixin.hpp:204-295).

A ``Parameter`` is a JAX pytree whose *value* is a dynamic leaf (so jitted
functions can take parameter stores as arguments and gradients flow through
them) and whose *prior* is static metadata.  A ``ParameterStore`` is a plain
``dict[str, Parameter]``; iteration order for the tunable-vector round trip is
**sorted by name**, mirroring the reference's ``std::map`` ordering — this
matters for optimizer-state compatibility and reproducibility.

The tunable round trip (`get_tunable_parameters` / `set_tunable_params`)
skips fixed parameters and log-transforms log-scale ones, exactly as the
reference does; both directions are traceable so a whole (bounded,
reparameterized) optimization objective can live under one ``jit``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping

import jax
import jax.numpy as jnp

from .priors import FixedPrior, Prior, UninformativePrior

ParameterStore = Dict[str, "Parameter"]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Parameter:
    """A scalar model parameter: dynamic value + static prior."""

    value: jax.Array | float = 0.0
    prior: Prior = dataclasses.field(default_factory=UninformativePrior)

    def tree_flatten(self):
        return (self.value,), self.prior

    @classmethod
    def tree_unflatten(cls, prior, children):
        return cls(children[0], prior)

    # -- reference Parameter API (parameters.hpp:28-63) ---------------------
    @property
    def is_fixed(self) -> bool:
        return self.prior.is_fixed

    def within_bounds(self) -> bool:
        v = float(self.value)
        return self.prior.lower_bound <= v <= self.prior.upper_bound

    def is_valid(self) -> bool:
        return self.within_bounds()

    def prior_log_likelihood(self):
        return self.prior.log_pdf(self.value)

    def with_value(self, value) -> "Parameter":
        return Parameter(value, self.prior)

    def with_prior(self, prior: Prior) -> "Parameter":
        return Parameter(self.value, prior)

    def fixed(self) -> "Parameter":
        return Parameter(self.value, FixedPrior())


@dataclasses.dataclass
class TunableParameters:
    """Flattened view of the non-fixed parameters (parameters.hpp:21-26)."""

    names: List[str]
    values: jax.Array  # possibly log-transformed
    lower_bounds: jax.Array
    upper_bounds: jax.Array


def get_tunable_parameters(params: ParameterStore) -> TunableParameters:
    """Flatten non-fixed params to a vector (parameters.hpp:117-154).

    Log-scale parameters are log-transformed (values and bounds); parameter
    values outside their bounds raise, matching the reference's hard assert.
    """
    names, values, lowers, uppers = [], [], [], []
    for name in sorted(params):
        p = params[name]
        if p.is_fixed:
            continue
        lb, ub = p.prior.lower_bound, p.prior.upper_bound
        v = p.value
        if not isinstance(v, jax.core.Tracer):
            fv = float(v)
            if fv < lb:
                raise ValueError(
                    f"INVALID PARAMETER: {name} expected to be greater than "
                    f"{lb} but is: {fv}"
                )
            if fv > ub:
                raise ValueError(
                    f"INVALID PARAMETER: {name} expected to be less than "
                    f"{ub} but is: {fv}"
                )
        if p.prior.is_log_scale:
            v = jnp.log(v)
            lb = float(jnp.log(lb)) if lb > 0 else -float("inf")
            ub = float(jnp.log(ub)) if ub < float("inf") else float("inf")
        names.append(name)
        values.append(jnp.asarray(v, dtype=jnp.result_type(v, float)))
        lowers.append(lb)
        uppers.append(ub)
    return TunableParameters(
        names=names,
        values=jnp.stack(values) if values else jnp.zeros((0,)),
        lower_bounds=jnp.asarray(lowers),
        upper_bounds=jnp.asarray(uppers),
    )


def ensure_value_within_bounds(param: Parameter, value):
    """Clamp to the prior's bounds (parameters.hpp:156-169)."""
    return jnp.clip(value, param.prior.lower_bound, param.prior.upper_bound)


def set_tunable_params(
    params: ParameterStore, x, force_bounds: bool = True
) -> ParameterStore:
    """Inverse of get_tunable_parameters (parameters.hpp:171-195).

    ``x`` is a vector ordered by sorted non-fixed parameter name; log-scale
    entries are exponentiated back; values are clamped into bounds unless
    ``force_bounds`` is False.  Fully traceable.
    """
    x = jnp.asarray(x)
    out = dict(params)
    i = 0
    for name in sorted(params):
        p = params[name]
        if p.is_fixed:
            continue
        v = x[i]
        if p.prior.is_log_scale:
            v = jnp.exp(v)
        if force_bounds:
            v = ensure_value_within_bounds(p, v)
        out[name] = p.with_value(v)
        i += 1
    if x.shape[0] != i:
        raise ValueError(f"expected {i} tunable values, got {x.shape[0]}")
    return out


def params_are_valid(params: ParameterStore) -> bool:
    return all(p.is_valid() for p in params.values())


def parameter_prior_log_likelihood(params: ParameterStore):
    """Sum of prior log-pdfs over the store (parameters.hpp:299-305)."""
    total = jnp.asarray(0.0, dtype=jnp.result_type(float))
    for name in sorted(params):
        total = total + params[name].prior_log_likelihood()
    return total


def map_join(*stores: Mapping[str, Parameter]) -> ParameterStore:
    """Join parameter maps; earlier stores win on duplicate names.

    Mirrors the composition-node param join in the reference
    (covariance_function.hpp:245-252).
    """
    out: ParameterStore = {}
    for store in stores:
        for k, v in store.items():
            out.setdefault(k, v)
    return out


def pretty_params(params: ParameterStore) -> str:
    """Copy-pasteable value dump (parameters.hpp:69-80)."""
    lines = ["{"]
    for name in sorted(params):
        lines.append(f'    {{"{name}", {float(params[name].value):.12e}}},')
    lines.append("};")
    return "\n".join(lines) + "\n"


def pretty_priors(params: ParameterStore) -> str:
    lines = ["PRIORS:"]
    for name in sorted(params):
        lines.append(f'    "{name}": {params[name].prior.name}')
    return "\n".join(lines) + "\n"


def pretty_param_details(params: ParameterStore) -> str:
    if not params:
        return ""
    width = max(len(n) for n in params) + 1
    lines = []
    for name in sorted(params):
        p = params[name]
        lines.append(
            f"    {name:<{width}} value: {float(p.value):<12g} "
            f"valid: {str(p.is_valid()):<5} prior: {p.prior.name:<15} "
            f"bounds: [{p.prior.lower_bound}, {p.prior.upper_bound}]"
        )
    return "\n".join(lines) + "\n"


class ParameterHandlingMixin:
    """get/set-param protocol shared by kernels, means and models.

    Functional analog of the reference mixin
    (parameter_handling_mixin.hpp:204-295): ``set_*`` methods return a NEW
    object (everything here is an immutable pytree) instead of mutating.
    Implementors must define ``get_params()`` and ``_replace_param(name,
    Parameter) -> Self``.
    """

    def get_params(self) -> ParameterStore:  # pragma: no cover - interface
        raise NotImplementedError

    def _replace_param(self, name: str, param: Parameter):  # pragma: no cover
        raise NotImplementedError

    # -- queries ------------------------------------------------------------
    def get_param_names(self) -> List[str]:
        return sorted(self.get_params())

    def get_param_value(self, name: str):
        return self.get_params()[name].value

    def params_are_valid(self) -> bool:
        return params_are_valid(self.get_params())

    def prior_log_likelihood(self):
        return parameter_prior_log_likelihood(self.get_params())

    def get_tunable_parameters(self) -> TunableParameters:
        return get_tunable_parameters(self.get_params())

    # -- functional setters -------------------------------------------------
    def set_param(self, name: str, param):
        if not isinstance(param, Parameter):
            param = self.get_params()[name].with_value(param)
        if name not in self.get_params():
            raise KeyError(f"parameter `{name}` not found")
        return self._replace_param(name, param)

    def set_param_value(self, name: str, value):
        return self.set_param(name, self.get_params()[name].with_value(value))

    def set_param_prior(self, name: str, prior: Prior):
        return self.set_param(name, self.get_params()[name].with_prior(prior))

    def set_params(self, params: Mapping[str, Parameter]):
        obj = self
        for name, p in params.items():
            obj = obj.set_param(name, p)
        return obj

    def set_param_values(self, values: Mapping[str, object]):
        obj = self
        for name, v in values.items():
            obj = obj.set_param_value(name, v)
        return obj

    def set_param_if_exists(self, name: str, param) -> "ParameterHandlingMixin":
        if name in self.get_params():
            return self.set_param(name, param)
        return self

    def set_param_values_if_exists(self, values: Mapping[str, object]):
        obj = self
        for name, v in values.items():
            obj = obj.set_param_if_exists(
                name,
                obj.get_params()[name].with_value(v)
                if name in obj.get_params()
                else None,
            )
        return obj

    def set_tunable_params(self, x, force_bounds: bool = True):
        new = set_tunable_params(self.get_params(), x, force_bounds)
        return self.set_params(new)

    def pretty_params(self) -> str:
        return pretty_params(self.get_params())

    def pretty_param_details(self) -> str:
        return pretty_param_details(self.get_params())
