"""Persistent XLA compilation cache location.

The blocked factorizations unroll into large programs; caching them lets a
second process on the same checkout skip the compile.  The cache lives
where ``JAX_COMPILATION_CACHE_DIR`` says (JAX reads that variable itself),
and otherwise at one fixed directory of the checkout, ``.jax_cache`` —
fixed because the path is part of the cache key.
"""

from __future__ import annotations

import os
import pathlib
from typing import Mapping

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def compilation_cache_dir(environ: Mapping[str, str] = os.environ) -> str:
    """The cache directory: the environment's, else the checkout's."""
    return environ.get(ENV_VAR) or str(REPO_CACHE_DIR)


def enable_compilation_cache() -> str:
    """Point JAX at the cache directory and return it.  When the
    environment names one, JAX already uses it and nothing is set."""
    path = compilation_cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
