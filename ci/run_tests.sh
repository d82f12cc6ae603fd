#!/usr/bin/env bash
# Unit/integration lane: pytest suite on the 8-virtual-device CPU mesh.
# Mirrors /root/reference/ci/run_tests.sh plus the reference's tagged
# unit-vs-integration split (tests/BUILD.bazel): the default QUICK lane
# skips the `slow`-marked tests (distributed ladders, tutorials, big-N);
# FULL=1 runs everything.
set -euo pipefail
cd "$(dirname "$0")/.."
if [ "${FULL:-0}" = "1" ]; then
  env JAX_PLATFORMS=cpu python -m pytest tests/ -q
else
  env JAX_PLATFORMS=cpu python -m pytest tests/ -q -m "not slow" -n 2
fi
