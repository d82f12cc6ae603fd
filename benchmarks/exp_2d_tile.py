"""The 2-D tile-sharded NLML at a given per-device tile, on the GPUs found.

Runs ``DistributedGaussianProcess.log_likelihood`` (2-D layout) once on an
(R, C) mesh of the local devices and reports, per step, what the device
holds: the sharded gram alone, the factorization, then the whole NLML
(compiled temporaries from ``memory_analysis()`` and ``peak_bytes_in_use``
after each).  On a (1, 1) mesh with N=65536 one card holds the same
65536² (2³² entry) f32 tile each of four cards holds at N=131072, so the
per-device program is the four-card one without its collectives.

The data are ``chip_smoke.py``'s clusters (exactly block-diagonal
covariance), so the f64 reference is the sum of the clusters' NLMLs.

    python -m benchmarks.exp_2d_tile --n 65536 --mesh 1,1
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=65536)
    parser.add_argument("--mesh", default="1,1")
    args = parser.parse_args(argv)

    import jax

    import albatross_tpu as ab
    import chip_smoke as cs
    from albatross_tpu.parallel import (
        distributed_cholesky_2d,
        distributed_gp_from_covariance,
        make_mesh,
        sharded_gram_2d,
    )
    from albatross_tpu.utils.compile_cache import enable_compilation_cache

    if jax.devices()[0].platform != "gpu":
        print("exp_2d_tile: needs a GPU", file=sys.stderr)
        return 2
    enable_compilation_cache()
    shape = tuple(int(v) for v in args.mesh.split(","))
    ndev = shape[0] * shape[1]
    devices = jax.devices()[:ndev]
    mesh = make_mesh(ndev, ("data", "model"), shape=shape)
    n, cluster = args.n, cs.FULL["cluster"]
    x, y = cs.clustered_data(n, cluster, unique=True)
    data = ab.RegressionDataset.create(x, y)
    kernel = ab.SquaredExponential(0.5, 1.0) + ab.measurement_only(
        ab.IndependentNoise(0.3, assume_unique=True)
    )
    model = distributed_gp_from_covariance(
        kernel, mesh, axis="data", col_axis="model", jitter=1e-4
    )
    tile = n * n * 4 // ndev

    def step(name, fn, *operands):
        compiled = jax.jit(fn).lower(*operands).compile()
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*operands))
        rec = dict(
            step=name, n=n, mesh=list(shape), s=time.perf_counter() - t0,
            temp_tiles=compiled.memory_analysis().temp_size_in_bytes / tile,
            peak_tiles=[cs.peak_bytes(d) / tile for d in devices],
            device=devices[0].device_kind,
        )
        print(json.dumps(rec), flush=True)
        return out

    feats = jax.numpy.asarray(x)
    K = step("gram", lambda f: sharded_gram_2d(
        kernel, f, mesh, measurement=True, jitter=1e-4), feats)
    L = step("cholesky", lambda A: distributed_cholesky_2d(A, mesh), K)
    del K, L
    nll = -float(step("nlml", lambda d: model.log_likelihood(d), data))
    ref, _ = cs.clustered_nlml64(x, y, cluster, 0.5, 1.0, 0.09 + 1e-4)
    err = cs.rel(nll, ref)
    print(json.dumps(dict(step="check", nll=nll, ref64=ref, rel_err=err)))
    return 0 if err <= 1e-3 else 1


if __name__ == "__main__":
    sys.exit(main())
