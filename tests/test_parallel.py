"""Multi-chip layer on the virtual 8-device CPU mesh: sharded == single-device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import jit_of
from sks_tpu.parallel import make_mesh
from sks_tpu.parallel.sharded_ba import shard_problem, sharded_gauss_newton_step
from sks_tpu.slam.ba import gauss_newton_step, rms_reprojection


def test_make_mesh_shapes():
    mesh = make_mesh({"hyp": 8})
    assert mesh.shape == {"hyp": 8}
    mesh2 = make_mesh({"dp": 2, "mp": -1})
    assert mesh2.shape == {"dp": 2, "mp": 4}


def test_sharded_ba_matches_single_device(key):
    from test_slam import _ba_setup

    gt, prob = _ba_setup(key)
    # Pad landmarks to a multiple of 8 for even sharding.
    l = prob.points.shape[0]
    pad = (-l) % 8
    if pad:
        from sks_tpu.slam.ba import BAProblem

        prob = BAProblem(
            poses=prob.poses,
            points=jnp.concatenate(
                [prob.points, jnp.ones((pad, 3), prob.points.dtype)], 0
            ),
            intrinsics=prob.intrinsics,
            obs=jnp.concatenate(
                [prob.obs, jnp.zeros((prob.obs.shape[0], pad, 2), prob.obs.dtype)], 1
            ),
            mask=jnp.concatenate(
                [prob.mask, jnp.zeros((prob.mask.shape[0], pad), prob.mask.dtype)], 1
            ),
        )

    mesh = make_mesh({"lm": 8})
    single = gauss_newton_step(prob, damping=1e-6)
    sharded = sharded_gauss_newton_step(mesh, shard_problem(prob, mesh), 1e-6)
    assert np.allclose(
        np.asarray(single.poses), np.asarray(sharded.poses), atol=1e-8
    )
    assert np.allclose(
        np.asarray(single.points), np.asarray(sharded.points), atol=1e-8
    )


@pytest.mark.slow
def test_sharded_ba_converges(key):
    from test_slam import _ba_setup
    from sks_tpu.slam.ba import BAProblem

    gt, prob = _ba_setup(key)
    l = prob.points.shape[0]
    pad = (-l) % 8
    prob = BAProblem(
        poses=prob.poses,
        points=jnp.concatenate([prob.points, jnp.ones((pad, 3), prob.points.dtype)], 0),
        intrinsics=prob.intrinsics,
        obs=jnp.concatenate(
            [prob.obs, jnp.zeros((prob.obs.shape[0], pad, 2), prob.obs.dtype)], 1
        ),
        mask=jnp.concatenate(
            [prob.mask, jnp.zeros((prob.mask.shape[0], pad), prob.mask.dtype)], 1
        ),
    )
    mesh = make_mesh({"lm": 8})
    prob = shard_problem(prob, mesh)
    for _ in range(6):
        prob = sharded_gauss_newton_step(mesh, prob, damping=1e-6)
    assert float(rms_reprojection(prob)) < 1e-6


def test_sharded_ndlt_matches_single_device(key):
    """Point-sharded NDLT (psum reduction) == single-device ndlt_h
   ."""
    from sks_tpu.geom.homography import normalize_h
    from sks_tpu.ops.ndlt import ndlt_h
    from sks_tpu.parallel.sharded_refine import sharded_ndlt_h
    from sks_tpu.utils.synth import random_correspondences

    src, tar, _ = jit_of(
        lambda k: random_correspondences(k, (), 1024, 1.0, jnp.float32))(key)
    w = (jax.random.uniform(jax.random.fold_in(key, 1), (1024,)) > 0.2
         ).astype(jnp.float32)
    mesh = make_mesh({"pts": 8})
    hs = jax.jit(lambda s, t, w: sharded_ndlt_h(mesh, s, t, w))(src, tar, w)
    hr = jit_of(ndlt_h)(src, tar, w)
    np.testing.assert_allclose(np.asarray(normalize_h(hs, "fro")),
                               np.asarray(normalize_h(hr, "fro")),
                               atol=5e-6)


def test_sharded_ho_matches_single_device(key):
    from sks_tpu.geom.homography import normalize_h
    from sks_tpu.ops.ho import ho_h
    from sks_tpu.parallel.sharded_refine import sharded_ho_h
    from sks_tpu.utils.synth import random_correspondences

    src, tar, _ = jit_of(
        lambda k: random_correspondences(k, (), 512, 0.5, jnp.float32))(key)
    mesh = make_mesh({"pts": 8})
    hs = jax.jit(lambda s, t: sharded_ho_h(mesh, s, t))(src, tar)
    hr = jit_of(ho_h)(src, tar)
    np.testing.assert_allclose(np.asarray(normalize_h(hs, "fro")),
                               np.asarray(normalize_h(hr, "fro")),
                               atol=5e-6)


@pytest.mark.slow
def test_sharded_ba_at_scale():
    """K=20 cameras, L=10,240 landmarks on the virtual mesh: converges to
    the 0.5 px observation-noise floor."""
    from sks_tpu.bench.ba_scale import run

    out = run(num_cams=20, num_points=10_240, iters=6)
    assert out["converged"], out["rms_reprojection_px"]
    assert out["rms_reprojection_px"][-1] < 0.6
    assert out["pose_center_rms"] < 0.05, out["pose_center_rms"]


def test_sharded_posegraph_matches_single_device(key):
    from test_slam import _ring_graph

    from sks_tpu.parallel.sharded_posegraph import (
        shard_graph,
        sharded_optimize_posegraph,
    )
    from sks_tpu.slam.posegraph import PoseGraph, optimize_posegraph

    graph, poses_gt = _ring_graph(key)
    # Pad edges to a multiple of 8 with zero-weight (disabled) edges.
    e = graph.edges.shape[0]
    pad = (-e) % 8
    if pad:
        graph = PoseGraph(
            poses=graph.poses,
            edges=jnp.concatenate(
                [graph.edges, jnp.zeros((pad, 2), graph.edges.dtype)], 0
            ),
            meas=jnp.concatenate(
                [graph.meas,
                 jnp.broadcast_to(jnp.eye(4, dtype=graph.meas.dtype),
                                  (pad, 4, 4))], 0
            ),
            weights=jnp.concatenate(
                [graph.weights, jnp.zeros((pad,), graph.weights.dtype)], 0
            ),
        )

    mesh = make_mesh({"edge": 8})
    single = optimize_posegraph(graph, gn_iters=3, cg_iters=40)
    sharded = sharded_optimize_posegraph(
        mesh, shard_graph(graph, mesh), gn_iters=3, cg_iters=40
    )
    assert np.allclose(
        np.asarray(single.poses), np.asarray(sharded.poses), atol=1e-8
    )


@pytest.mark.slow
def test_sharded_posegraph_converges(key):
    from test_slam import _ring_graph

    from sks_tpu.parallel.sharded_posegraph import (
        shard_graph,
        sharded_optimize_posegraph,
    )
    from sks_tpu.slam.posegraph import (
        PoseGraph,
        ate_rmse,
        posegraph_residuals,
    )

    graph, poses_gt = _ring_graph(key, n=16)
    mesh = make_mesh({"edge": 8})
    out = sharded_optimize_posegraph(
        mesh, shard_graph(graph, mesh), gn_iters=10, cg_iters=60
    )
    assert float(jnp.sum(posegraph_residuals(out) ** 2)) < 1e-10
    assert float(ate_rmse(out.poses, poses_gt)) < 1e-4
