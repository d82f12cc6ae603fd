"""Example: mesh-distributed exact and sparse GPs.

The multi-device story (SURVEY.md §2.12): the N×N covariance never exists
on one device.  The mesh spans every device JAX finds (at least 2): the
GPUs of a machine (JAX_PLATFORMS=cuda), or by default a virtual 8-device
CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count=8), so the
example is runnable — and CI-smoked — anywhere.

Shown side by side with the single-chip model to demonstrate the
equivalence ladder the test suite enforces:
  * exact GP, 1-D row-panel layout (N²/D bytes per device);
  * exact GP, 2-D tile layout (N²/(R·C) bytes per device) + fast LOO;
  * sparse GP (FITC) with sharded K_fu panels and a TSQR factorization;
  * online update on the distributed fit == full refit.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax
import jax.numpy as jnp
import numpy as np

import albatross_tpu as ab
from albatross_tpu.parallel import (
    distributed_gp_from_covariance,
    distributed_sparse_gp_from_covariance,
    make_mesh,
)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=512)
    args = parser.parse_args()
    n = args.n

    n_dev = len(jax.devices())
    if n_dev < 2:
        print("needs at least 2 devices "
              "(on the CPU: --xla_force_host_platform_device_count=8)")
        return 1
    cols = 2 if n_dev % 2 == 0 else 1
    mesh = make_mesh(n_dev, ("data", "model"), shape=(n_dev // cols, cols))
    print(f"mesh: {n_dev} {jax.devices()[0].platform} devices, "
          f"shape {dict(mesh.shape)}")

    rng = np.random.default_rng(0)
    x = jnp.asarray(np.sort(rng.uniform(0.0, 10.0, n)))
    y = jnp.sin(x) + 0.1 * jnp.asarray(rng.standard_normal(n))
    data = ab.RegressionDataset.create(x, y, variance=jnp.full((n,), 0.01))
    kernel = ab.SquaredExponential(1.5, 1.0) + ab.IndependentNoise(0.1)
    xs = jnp.linspace(0.0, 10.0, 64)

    single = ab.gp_from_covariance(kernel)
    ref_nlml = float(-single.log_likelihood(data))
    ref_pred = single.fit(data).predict(xs).marginal()
    print(f"single-device    NLML = {ref_nlml:.6f}")

    # -- exact GP, 1-D row panels -------------------------------------------
    gp1 = distributed_gp_from_covariance(kernel, mesh, axis="data")
    nlml1 = float(-gp1.log_likelihood(data))
    p1 = gp1.fit(data).predict(xs).marginal()
    print(
        f"1-D row-sharded  NLML = {nlml1:.6f}  "
        f"max|Δmean| = {float(jnp.max(jnp.abs(p1.mean - ref_pred.mean))):.2e}"
    )

    # -- exact GP, 2-D tiles + fast LOO --------------------------------------
    gp2 = distributed_gp_from_covariance(
        kernel, mesh, axis="data", col_axis="model", panel=min(128, n // 8)
    )
    nlml2 = float(-gp2.log_likelihood(data))
    fit2 = gp2.fit(data)
    p2 = fit2.predict(xs).marginal()
    loo_var = 1.0 / fit2.fit.train_covariance.inverse_diagonal()
    print(
        f"2-D tile-sharded NLML = {nlml2:.6f}  "
        f"max|Δmean| = {float(jnp.max(jnp.abs(p2.mean - ref_pred.mean))):.2e}  "
        f"LOO var[0] = {float(loo_var[0]):.4f}"
    )
    tile = fit2.fit.train_covariance.L.sharding.shard_shape((n, n))
    print(f"  per-device factor tile: {tile} of ({n}, {n})")

    # -- online update == refit ----------------------------------------------
    half = n // 2
    first = ab.RegressionDataset.create(
        x[:half], y[:half], variance=jnp.full((half,), 0.01)
    )
    rest = ab.RegressionDataset.create(
        x[half:], y[half:], variance=jnp.full((n - half,), 0.01)
    )
    updated = gp1.fit(first).update(rest).predict(xs).marginal()
    print(
        f"update==refit    max|Δmean| = "
        f"{float(jnp.max(jnp.abs(updated.mean - ref_pred.mean))):.2e}"
    )

    # -- sparse GP (FITC) with sharded K_fu + TSQR ----------------------------
    from albatross_tpu.models.sparse_gp import (
        UniformlySpacedInducingPoints,
        sparse_gp_from_covariance,
    )

    skw = dict(inducing_point_strategy=UniformlySpacedInducingPoints(24))
    sp_single = sparse_gp_from_covariance(kernel, **skw)
    sp_dist = distributed_sparse_gp_from_covariance(
        kernel, mesh, axis="data", **skw
    )
    sp_ref = float(sp_single.log_likelihood(data))
    sp_got = float(sp_dist.log_likelihood(data))
    sp_pred = sp_dist.fit(data).predict(xs).marginal()
    sp_pred_ref = sp_single.fit(data).predict(xs).marginal()
    print(
        f"sparse (TSQR)    NLML = {sp_got:.6f} (single {sp_ref:.6f})  "
        f"max|Δmean| = "
        f"{float(jnp.max(jnp.abs(sp_pred.mean - sp_pred_ref.mean))):.2e}"
    )

    ok = (
        abs(nlml1 - ref_nlml) < 1e-6 * abs(ref_nlml)
        and abs(nlml2 - ref_nlml) < 1e-6 * abs(ref_nlml)
        and abs(sp_got - sp_ref) < 1e-6 * abs(sp_ref)
    )
    print("all distributed paths match single-device" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
