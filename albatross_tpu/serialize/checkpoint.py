"""Checkpointing: save/load of models, fits and sampler state.

JAX re-design of the reference's cereal-based serialization
(/root/reference/include/albatross/src/cereal/*, SURVEY.md §2.11): the
reference archives every fit type (params+priors, LDLT internals, SPQR
structs) in 4 formats with zstd-compressed matrix payloads and explicit
versioning.

Here everything is a pytree, so one mechanism covers all of it:
* ``save_checkpoint`` flattens the object, stores array leaves as a
  compressed ``.npz``-style payload plus a pickled treedef, with an explicit
  ``SERIALIZATION_VERSION`` (gp.hpp:230's versioning);
* params/priors additionally round-trip through *JSON* (params_json.py) for
  human-readable, cross-language checkpoints mirroring cereal's JSON archive.
"""

from __future__ import annotations

import io
import pickle
import zlib
from typing import Any

import jax
import numpy as np

# Highest version this reader understands.  Version history:
#   1 — original format (plain pytree, no persistent ids);
#   2 — treedef may contain Mesh persistent ids (distributed fits).
# Writers stamp the SMALLEST version the payload needs (a mesh-free
# checkpoint stays v1 and remains readable by pre-mesh releases); a v1-only
# reader handed a v2 payload fails at the version gate with a clean error
# instead of an opaque "unsupported persistent id" UnpicklingError.
SERIALIZATION_VERSION = 2
MAGIC = b"ALBTPU01"

# -- durable loading ---------------------------------------------------------
# The treedef references the pytree node classes by module path.  Two
# durability hazards of naive pickle.load are closed here:
# * arbitrary-code-execution: a restricted unpickler only resolves classes
#   from an allowlist of module prefixes;
# * refactor breakage: CLASS_RENAMES maps old (module, qualname) pairs to
#   their current homes, so checkpoints survive class moves (the analog of
#   cereal's explicit version/name registration, src/cereal/*).
_ALLOWED_MODULE_PREFIXES = (
    "albatross_tpu",
    "jax",
    "jaxlib",
    "numpy",
    "builtins",
    "collections",
    "functools",
)

# (old_module, old_qualname) -> (new_module, new_qualname); extend whenever a
# registered pytree class moves between releases.
CLASS_RENAMES: dict = {}


class _MeshAwarePickler(pickle.Pickler):
    """Externalizes ``jax.sharding.Mesh`` nodes (they hold live Device
    handles, which cannot — and should not — be pickled): a mesh is stored
    as its (axis_names, device_grid_shape) signature and rebound to the
    loading process's own devices at restore time.  The analog of the
    reference checkpointing compute-topology-free state (cereal never
    archives thread pools either)."""

    used_persistent_ids: bool = False

    def persistent_id(self, obj):
        from jax.sharding import Mesh

        if isinstance(obj, Mesh):
            self.used_persistent_ids = True
            return (
                "albatross_tpu.mesh",
                tuple(obj.axis_names),
                tuple(obj.devices.shape),
            )
        return None


class _RestrictedUnpickler(pickle.Unpickler):
    def __init__(self, file, mesh=None):
        super().__init__(file)
        self._mesh = mesh

    def find_class(self, module, name):
        module, name = CLASS_RENAMES.get((module, name), (module, name))
        root = module.split(".")[0]
        if root not in _ALLOWED_MODULE_PREFIXES:
            raise pickle.UnpicklingError(
                f"checkpoint references disallowed class {module}.{name}; "
                "only albatross_tpu/jax/numpy pytree nodes may load"
            )
        return super().find_class(module, name)

    def persistent_load(self, pid):
        import jax as _jax
        from jax.sharding import Mesh

        kind, axis_names, shape = pid
        if kind != "albatross_tpu.mesh":
            raise pickle.UnpicklingError(f"unknown persistent id {pid!r}")
        if self._mesh is not None:
            if tuple(self._mesh.axis_names) != tuple(axis_names):
                raise ValueError(
                    f"checkpoint mesh axes {axis_names} do not match the "
                    f"provided mesh axes {tuple(self._mesh.axis_names)}"
                )
            if tuple(self._mesh.devices.shape) != tuple(shape):
                # sharded state (panel counts, row splits) is laid out for
                # the saved grid — a differently shaped mesh would fail
                # deep inside shard_map or silently reshard
                raise ValueError(
                    f"checkpoint mesh grid {tuple(shape)} does not match "
                    f"the provided mesh grid "
                    f"{tuple(self._mesh.devices.shape)}"
                )
            return self._mesh
        need = int(np.prod(shape))
        devices = _jax.devices()
        if len(devices) < need:
            raise ValueError(
                f"checkpoint was saved on a {shape} device mesh "
                f"({need} devices) but only {len(devices)} are visible; "
                "pass load_checkpoint(..., mesh=...) to rebind explicitly"
            )
        return Mesh(np.asarray(devices[:need]).reshape(shape), axis_names)


def _restricted_loads(data: bytes, mesh=None):
    return _RestrictedUnpickler(io.BytesIO(data), mesh=mesh).load()


def save_checkpoint(path: str, obj: Any) -> None:
    """Serialize any pytree (model, FitModel, chain, ...) to disk.

    Array leaves are materialized to host and zlib-compressed (the cereal
    archives zstd-compress Eigen payloads, cereal/eigen.hpp:25-64).
    Distributed fits (mesh-bound factors) are topology-portable: the mesh
    is stored by signature and rebound at load (see _MeshAwarePickler).
    """
    leaves, treedef = jax.tree_util.tree_flatten(obj)
    host_leaves = [np.asarray(jax.device_get(leaf)) for leaf in leaves]
    buffer = io.BytesIO()
    np.savez(buffer, *host_leaves)
    td_buf = io.BytesIO()
    pickler = _MeshAwarePickler(td_buf)
    pickler.dump(treedef)
    payload = {
        # smallest version the payload needs (see SERIALIZATION_VERSION)
        "version": 2 if pickler.used_persistent_ids else 1,
        "treedef": td_buf.getvalue(),
        "arrays": zlib.compress(buffer.getvalue(), level=3),
    }
    with open(path, "wb") as f:
        f.write(MAGIC)
        pickle.dump(payload, f)


def load_checkpoint(path: str, mesh=None) -> Any:
    """Restore a checkpoint.  ``mesh``: optional Mesh to rebind any
    distributed (mesh-bound) state onto; defaults to a mesh of the same
    axis names/shape over this process's devices."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"{path} is not an albatross_tpu checkpoint")
        payload = _restricted_loads(f.read())
    if payload["version"] > SERIALIZATION_VERSION:
        raise ValueError(
            f"checkpoint version {payload['version']} is newer than "
            f"supported {SERIALIZATION_VERSION}"
        )
    treedef = _restricted_loads(payload["treedef"], mesh=mesh)
    data = np.load(io.BytesIO(zlib.decompress(payload["arrays"])))
    leaves = [data[key] for key in data.files]
    import jax.numpy as jnp

    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(leaf) for leaf in leaves]
    )
