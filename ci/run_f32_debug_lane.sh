#!/usr/bin/env bash
# f32 + jax_debug_nans robustness smoke: the accelerator numerics lane (x64 off,
# NaN checking on) over the core fit/predict/NLML/grad/CV/sampler flows.
# The analog of the reference's sanitizer lanes for numerical code.
set -euo pipefail
cd "$(dirname "$0")/.."
env PYTHONPATH="$PWD" JAX_PLATFORMS=cpu python ci/smoke_f32.py
