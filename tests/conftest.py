"""Test configuration: CPU backend with 8 virtual devices + float64.

Mirrors the reference's test strategy of running everything on tiny synthetic
data with no special hardware (SURVEY.md §4): distributed logic is exercised
on a virtual 8-device CPU mesh, numerics at float64 for parity with the
reference's double-precision Eigen results.

Tests marked ``gpu`` need the card; they skip elsewhere (decided in the
``gpu_device`` fixture).  On a machine with one, run only them, in one
process (each xdist worker would claim the card):

    ALBATROSS_TEST_PLATFORMS=cuda python -m pytest tests -m gpu -p no:xdist
"""

import os

# The suite runs on a virtual 8-device CPU mesh unless the caller asks for
# the card (ALBATROSS_TEST_PLATFORMS=cuda, for the gpu-marked tests).
os.environ["JAX_PLATFORMS"] = os.environ.get("ALBATROSS_TEST_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(2012)


@pytest.fixture
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX has {device.platform})")
    return device


# ---------------------------------------------------------------------------
# Quick/full test lanes (the analog of the reference's tagged unit vs
# integration split, tests/BUILD.bazel).  Tests measured >=10 s on the CI
# box (full-suite --durations run, 2026-08-20: suite total 32 min) carry the
# `slow` marker; `ci/run_tests.sh` runs `-m "not slow"` by default and the
# full lane with FULL=1.  Central list (not per-file decorators) so the
# membership is maintained against measured durations in one place.
# ---------------------------------------------------------------------------
_SLOW_TESTS = {
    "test_blocked_cholesky.py::test_left_looking_fused_gram_gp_equivalence",
    "test_blocked_cholesky.py::test_right_fused_gram_gp_equivalence",
    "test_blocked_cholesky.py::test_cols_nondivisible_n_honors_precision_knobs",
    "test_blocked_cholesky.py::test_trailing_bf16_mode",
    "test_blocked_cholesky.py::test_fused_panel_factorizer_matches_builtin",
    "test_blocked_cholesky.py::test_left_looking_matches_right_looking",
    "test_blocked_cholesky.py::test_no_assemble_nlml_path",
    "test_blocked_cholesky.py::test_factorize_whiten_small_and_large_agree",
    "test_examples.py::test_distributed_example",
    "test_examples.py::test_accuracy_example",
    "test_examples.py::test_temperature_example",
    "test_parallel.py::test_distributed_gp_2d_gradients",
    "test_parallel.py::test_distributed_update_matches_refit",
    "test_parallel.py::test_distributed_nlml_gradient",
    "test_parallel.py::test_2d_wsolve_matches_substitution_and_dense",
    "test_parallel.py::test_distributed_sparse_gp_ladder",
    "test_parallel.py::test_distributed_gp_2d_matches_single_chip",
    "test_parallel.py::test_distributed_cholesky_2d_matches_dense",
    "test_parallel.py::test_distributed_gp_matches_single_chip",
    "test_parallel.py::test_no_device_holds_n_squared",
    "test_parallel.py::test_distributed_loo_cv_matches_single_chip",
    "test_parallel.py::test_distributed_loo_2d_matches_single_chip",
    "test_parallel.py::test_parallel_gram_bitwise_equals_serial",
    "test_parallel.py::test_distributed_solves",
    "test_parallel.py::test_distributed_logo_cv",
    "test_parallel.py::test_sharded_gram_matches_dense",
    "test_parallel.py::test_2d_auto_routes_multi_rhs_through_inverse",
    "test_parallel.py::test_distributed_tri_inverse_2d",
    "test_parallel.py::test_2d_wsolve_round_complexity",
    "test_tutorials.py::test_tutorial_runs[tutorial_4_state_space]",
    "test_tutorials.py::test_tutorial_runs[tutorial_3_sparse]",
    "test_reference_parity_r3.py::test_ransac_model",
    "test_reference_parity_r3.py::test_tune_with_prior",
    "test_reference_parity_utils.py::test_random_covariance_matrix_is_spd",
    "test_nlml_ops.py::test_potri_primitives[2304]",
    "test_nlml_ops.py::test_potri_primitives[2113]",
    "test_compensated.py::test_double_word_mode_is_differentiable",
    "test_model_contracts.py::test_fit_and_predict_shapes[generic_ransac]",
    "test_stats_scores_parity.py::test_energy_score_translation_invariance",
    "test_stats_scores_parity.py::test_variogram_score_with_weights",
    "test_stats_scores_parity.py::test_energy_score_scaling",
    "test_stats_scores_parity.py::test_energy_score_rotation_invariance",
    "test_stats_scores_parity.py::test_variogram_score_scaling[madogram]",
    "test_stats_scores_parity.py::test_variogram_score_mean_offset_invariance[madogram]",
    "test_sparse_gp.py::test_sparse_fitc_f32_coincident_inducing_point_finite",
    "test_sparse_gp.py::test_sparse_converges_to_dense",
    "test_models_misc.py::test_generic_ransac_strategy",
    "test_evaluation.py::test_batched_grouped_cv_fast_paths",
    "test_serialize_zoo.py::test_distributed_fit_checkpoint_rebinds_mesh[1d]",
    "test_serialize_zoo.py::test_distributed_fit_checkpoint_rebinds_mesh[2d]",
    "test_reference_parity_r3.py::test_tune_single_dataset",
    "test_reference_parity_r3.py::test_tune_multiple_datasets",
    "test_stats_scores_parity.py::test_energy_score_with_weights",
    "test_stats_scores_parity.py::test_energy_score_approaches_deterministic",
    "test_models_misc.py::test_ransac_batched_matches_serial",
    "test_examples.py::test_sampler_example",
    "test_sparse_gp.py::test_sparse_update_matches_full_fit",
    "test_sparse_gp.py::test_sparse_log_likelihood_approaches_dense",
    "test_model_contracts.py::test_fits_linear_data_sensibly[generic_ransac]",
    "test_reference_parity.py::test_sparse_gp_sanity",
    "test_reference_parity.py::test_performs_reasonably_on_linear_data",
    "test_reference_parity_r3.py::test_tune_with_prior_bounds",
    "test_reference_parity_r3.py::test_ransac_groups",
    "test_examples.py::test_sparse_example",
    "test_parallel.py::test_distributed_inverse_diagonal",
    "test_parallel.py::test_sharded_gram_2d_matches_dense",
    "test_compensated.py::test_cholesky_precision_double_word_wiring",
    "test_models_misc.py::test_adapted_model",
    "test_stats_scores_parity.py::test_variogram_score_scaling[variogram]",
    "test_tutorials.py::test_tutorial_runs[tutorial_2_maximum_likelihood]",
    "test_tutorials.py::test_tutorial_runs[tutorial_5_evaluating_uncertainty]",
    "test_tutorials.py::test_tutorial_runs[tutorial_1_one_dimension]",
    "test_sparse_gp.py::test_rebase_inducing_points",
    "test_evaluation.py::test_ragged_group_cv",
}


def pytest_collection_modifyitems(config, items):
    seen = set()
    collected_files = set()
    for item in items:
        nodeid = item.nodeid.split("tests/")[-1]
        collected_files.add(nodeid.split("::")[0])
        if nodeid in _SLOW_TESTS:
            seen.add(nodeid)
            item.add_marker(pytest.mark.slow)
    # keep the central list honest against renames: warn when an entry's
    # FILE was collected but the listed test no longer exists (a renamed
    # slow test would otherwise silently rejoin the quick lane).  Skip the
    # check on nodeid-subset runs (`pytest file::test`): those collect a
    # file but deselect its other tests, which would false-positive every
    # listed entry of that file (round-4 advisor finding).
    if any("::" in a for a in config.args) or config.getoption("-k"):
        return
    stale = {
        t
        for t in _SLOW_TESTS - seen
        if t.split("::")[0] in collected_files
    }
    if stale:
        import warnings

        warnings.warn(
            f"_SLOW_TESTS entries match no collected test: {sorted(stale)}",
            stacklevel=1,
        )
