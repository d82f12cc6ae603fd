"""f32 + debug-NaN smoke lane: core flows must run NaN-free in the
accelerator numerics regime (x64 OFF, jax_debug_nans ON).  A NaN anywhere
raises."""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_debug_nans", True)  # x64 stays OFF: f32 like the GPU

import numpy as np
import jax.numpy as jnp

import albatross_tpu as ab


def main() -> int:
    rng = np.random.default_rng(5)
    n = 64
    x = np.sort(rng.uniform(0, 10, n)).astype(np.float32)
    y = (np.sin(x) + 0.05 * rng.standard_normal(n)).astype(np.float32)
    data = ab.RegressionDataset.create(
        jnp.asarray(x), jnp.asarray(y), variance=jnp.full((n,), 0.0025, jnp.float32)
    )
    kernel = ab.SquaredExponential(2.0, 1.0) + ab.measurement_only(
        ab.IndependentNoise(0.05)
    )
    model = ab.gp_from_covariance(kernel, jitter=1e-6)

    fitm = model.fit(data)
    xs = jnp.linspace(0.5, 9.5, 16, dtype=jnp.float32)
    marg = fitm.predict(xs).marginal()
    assert np.isfinite(np.asarray(marg.mean)).all()
    assert np.isfinite(np.asarray(marg.variance)).all()

    nlml, grads = jax.value_and_grad(lambda m: -m.log_likelihood(data))(model)
    assert np.isfinite(float(nlml))
    for leaf in jax.tree_util.tree_leaves(grads):
        assert np.isfinite(np.asarray(leaf)).all()

    from albatross_tpu.evaluation.metrics import NegativeLogLikelihood
    from albatross_tpu.indexing import LeaveOneOutGrouper

    scores = model.cross_validate().scores(
        NegativeLogLikelihood(), data, LeaveOneOutGrouper()
    )
    assert np.isfinite(np.asarray(scores)).all()

    from albatross_tpu.samplers import ensemble_sampler_from_model

    chain = ensemble_sampler_from_model(
        model, data, n_walkers=8, max_iterations=4, key=1
    )
    assert np.isfinite(chain.log_prob).all()

    from albatross_tpu.parallel import make_mesh, distributed_gp_from_covariance

    mesh = make_mesh(8, ("data",))
    dist = distributed_gp_from_covariance(kernel, mesh, jitter=1e-6)
    assert np.isfinite(float(dist.log_likelihood(data)))

    print("f32 debug-NaN smoke lane: ALL OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
