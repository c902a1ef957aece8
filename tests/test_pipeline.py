"""One-jit frames->poses pipeline: correctness + frame-sharded equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sks_tpu.parallel import make_mesh
from sks_tpu.robust.ransac import RansacConfig
from sks_tpu.slam.pipeline import frames_to_poses, sharded_frames_to_poses


def _setup(key, num_frames=9, shape=(240, 320)):
    from sks_tpu.data.images import planar_sequence

    frames, poses_gt, k_mat = planar_sequence(key, num_frames, shape)
    return frames, poses_gt, k_mat


def test_frames_to_poses_recovers_trajectory(key):
    from sks_tpu.slam.posegraph import ate_rmse

    frames, poses_gt, k_mat = _setup(key)
    config = RansacConfig(num_hypotheses=1024, threshold=2.0, refine_iters=2)
    out = frames_to_poses(key, frames, k_mat, config, plane_depth=3.0)
    assert bool(jnp.all(jnp.isfinite(out["poses"])))
    ate = float(ate_rmse(out["poses"], poses_gt))
    path = float(jnp.sum(jnp.linalg.norm(
        jnp.diff(poses_gt[:, :3, 3], axis=0), axis=-1)))
    # End-to-end from pixels: detection/matching noise bounds accuracy.
    assert ate < 0.12 * max(path, 1e-9) + 0.02, (ate, path)


@pytest.mark.slow
def test_sharded_pipeline_matches_single_device(key):
    # Tiny shapes: the correctness claim (same per-pair RNG streams ->
    # identical results) is size-independent, and an 8-way shard_map of the
    # full pipeline is expensive to compile on the CPU test backend.
    from sks_tpu.data.images import planar_sequence

    frames, _, k_mat = planar_sequence(key, 9, (96, 128), focal=120.0)
    config = RansacConfig(num_hypotheses=128, threshold=2.0, refine_iters=1)
    kw = dict(num_corners=64, num_octaves=1, plane_depth=3.0)
    mesh = make_mesh({"frame": 8})
    single = frames_to_poses(key, frames, k_mat, config, **kw)
    sharded = sharded_frames_to_poses(mesh, key, frames, k_mat, config, **kw)
    # Same per-pair RNG streams; XLA reassociates float reductions under
    # shard_map (descriptor-distance matmuls), which can flip borderline
    # ratio-test matches — so equality is to tolerance, not bitwise.
    assert np.allclose(np.asarray(single["poses"]),
                       np.asarray(sharded["poses"]), atol=5e-3)
    ninl_s = np.asarray(single["num_inliers"], np.int64)
    ninl_m = np.asarray(sharded["num_inliers"], np.int64)
    assert np.max(np.abs(ninl_s - ninl_m)) <= 2, (ninl_s, ninl_m)


@pytest.mark.slow
def test_planar_slam_closes_the_loop(key):
    """One-call capstone: pixels -> loop-closed poses beats the raw chain."""
    from sks_tpu.data.images import planar_sequence
    from sks_tpu.slam.pipeline import planar_slam
    from sks_tpu.slam.posegraph import ate_rmse

    frames, poses_gt, k_mat = planar_sequence(key, 12, (240, 320), loop=True)
    config = RansacConfig(num_hypotheses=1024, threshold=2.0, refine_iters=2)
    # esm_iters=0: this test exercises the loop-closure MECHANISM, which
    # needs feature-only drift to correct — the round-5 default-on ESM
    # polish leaves the raw chain at ~0.008 ATE, below the pose-graph
    # relaxation's own noise floor (measured: smoothing then neither helps
    # nor hurts materially).  The ESM default is covered below.
    kw = dict(plane_depth=3.0, strides=(4, 6), esm_iters=0)
    raw = planar_slam(key, frames, k_mat, config, smooth=False, **kw)
    closed = planar_slam(key, frames, k_mat, config, smooth=True, **kw)
    ate_raw = float(ate_rmse(raw["poses"], poses_gt))
    ate_closed = float(ate_rmse(closed["poses"], poses_gt))
    assert np.isfinite(ate_closed)
    # Strict improvement (round-4 front end halved raw drift; see
    # test_loop_closures_reduce_ate).
    assert ate_closed < 0.95 * ate_raw, (ate_raw, ate_closed)
    # The default-on ESM capstone beats the feature-only raw chain.
    esm = planar_slam(key, frames, k_mat, config, smooth=False,
                      plane_depth=3.0, strides=(4, 6))
    ate_esm = float(ate_rmse(esm["poses"], poses_gt))
    assert ate_esm < ate_raw, (ate_raw, ate_esm)
    assert closed["closure_inliers"].shape[0] == len(
        [(i, i + k) for k in (4, 6) for i in range(12 - k)]
    )


def test_planar_slam_smoke(key):
    """Default-suite smoke: tiny pixels -> loop-closed poses, finite."""
    from sks_tpu.data.images import planar_sequence
    from sks_tpu.slam.pipeline import planar_slam

    frames, _, k_mat = planar_sequence(key, 6, (96, 128), focal=120.0,
                                       loop=True)
    config = RansacConfig(num_hypotheses=128, threshold=2.0, refine_iters=1)
    out = planar_slam(key, frames, k_mat, config, num_corners=64,
                      num_octaves=1, plane_depth=3.0, strides=(2,))
    assert out["poses"].shape == (6, 4, 4)
    assert bool(jnp.all(jnp.isfinite(out["poses"])))
    assert out["closure_inliers"].shape == (4,)


def test_sharded_planar_slam_matches_single_device(key):
    """The sharded capstone (consecutive + closure fits over one combined
    pair list) must reproduce the single-device planar_slam — same RNG
    streams, same chain, same pose graph."""
    from sks_tpu.data.images import planar_sequence
    from sks_tpu.parallel import make_mesh
    from sks_tpu.slam.pipeline import planar_slam, sharded_planar_slam

    frames, _, k_mat = planar_sequence(key, 9, (120, 160), loop=True)
    cfg = RansacConfig(num_hypotheses=512, refine_iters=2)
    out1 = planar_slam(key, frames, k_mat, cfg, num_corners=192,
                       strides=(2, 3))
    mesh = make_mesh({"pair": 8})
    out2 = sharded_planar_slam(mesh, key, frames, k_mat, cfg,
                               num_corners=192, strides=(2, 3))
    assert bool(jnp.all(jnp.isfinite(out1["poses"])))
    np.testing.assert_array_equal(np.asarray(out1["num_inliers"]),
                                  np.asarray(out2["num_inliers"]))
    np.testing.assert_array_equal(np.asarray(out1["closure_inliers"]),
                                  np.asarray(out2["closure_inliers"]))
    # Same per-pair keys + replicated tail: poses match to float tolerance
    # (measured bit-exact on the CPU mesh; tolerance guards reassociation).
    np.testing.assert_allclose(np.asarray(out1["poses"]),
                               np.asarray(out2["poses"]), atol=1e-5)
