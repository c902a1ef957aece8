"""SLAM layers: BA reduces reprojection error to ~0; pose graph closes loops."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sks_tpu.geom.lie import se3_exp
from sks_tpu.slam.ba import BAProblem, gauss_newton_step, rms_reprojection
from sks_tpu.slam.posegraph import (
    PoseGraph,
    ate_rmse,
    optimize_posegraph,
    posegraph_residuals,
)

K_CAMS = 4
L_PTS = 48


def _ba_setup(key, noise_pose=0.02, noise_pt=0.05, dtype=jnp.float64):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    k_mat = jnp.array(
        [[600.0, 0.0, 320.0], [0.0, 600.0, 240.0], [0.0, 0.0, 1.0]], dtype
    )
    # Ground truth: cameras looking at a planar-ish cloud around z=4.
    xi = jax.random.normal(k1, (K_CAMS, 6), dtype) * 0.1
    poses_gt = se3_exp(xi)
    pts = jnp.concatenate(
        [
            jax.random.uniform(k2, (L_PTS, 2), dtype, -1.5, 1.5),
            4.0 + 0.2 * jax.random.normal(k3, (L_PTS, 1), dtype),
        ],
        axis=-1,
    )
    gt = BAProblem(
        poses=poses_gt,
        points=pts,
        intrinsics=k_mat,
        obs=jnp.zeros((K_CAMS, L_PTS, 2), dtype),
        mask=jnp.ones((K_CAMS, L_PTS), dtype),
    )
    from sks_tpu.slam.ba import ba_residuals

    obs = ba_residuals(gt) + gt.obs  # = projections since obs=0... see below
    # ba_residuals returns uv - obs; with obs=0 it IS the projection.
    gt = BAProblem(gt.poses, gt.points, k_mat, obs, gt.mask)

    # Perturb initial estimate.
    poses0 = poses_gt @ se3_exp(
        jax.random.normal(k4, (K_CAMS, 6), dtype) * noise_pose
    )
    pts0 = pts + noise_pt * jax.random.normal(k2, pts.shape, dtype)
    init = BAProblem(poses0, pts0, k_mat, obs, gt.mask)
    return gt, init


def test_ba_converges(key):
    gt, prob = _ba_setup(key)
    e0 = float(rms_reprojection(prob))
    for _ in range(6):
        prob = gauss_newton_step(prob, damping=1e-6)
    e1 = float(rms_reprojection(prob))
    assert e0 > 1.0, e0  # the perturbation must actually hurt
    assert e1 < 1e-6, (e0, e1)  # exact data -> GN reaches machine-level optimum


def test_ba_masked_observations(key):
    gt, prob = _ba_setup(key)
    mask = prob.mask.at[:, ::3].set(0.0)  # drop a third of observations
    prob = BAProblem(prob.poses, prob.points, prob.intrinsics, prob.obs, mask)
    for _ in range(6):
        prob = gauss_newton_step(prob, damping=1e-6)
    assert float(rms_reprojection(prob)) < 1e-6


def _ring_graph(key, n=12, drift=0.05, dtype=jnp.float64):
    """Odometry ring with a loop closure; drifted initialization."""
    k1, k2 = jax.random.split(key)
    # Ground truth poses around a circle.
    ang = jnp.linspace(0.0, 2 * jnp.pi, n, endpoint=False).astype(dtype)
    xi = jnp.stack(
        [jnp.cos(ang), jnp.sin(ang), jnp.zeros_like(ang),
         jnp.zeros_like(ang), jnp.zeros_like(ang), ang],
        axis=-1,
    )
    poses_gt = se3_exp(xi)

    def inv(g):
        from sks_tpu.slam.posegraph import _inv_se3

        return _inv_se3(g)

    edges = jnp.stack(
        [jnp.arange(n), jnp.roll(jnp.arange(n), -1)], axis=-1
    ).astype(jnp.int32)
    meas = inv(poses_gt[edges[:, 0]]) @ poses_gt[edges[:, 1]]
    weights = jnp.ones((n,), dtype)
    # Drifted init: accumulate noisy odometry.
    noise = jax.random.normal(k2, (n, 6), dtype) * drift
    poses0 = [poses_gt[0]]
    for i in range(1, n):
        poses0.append(poses0[-1] @ meas[i - 1] @ se3_exp(noise[i]))
    poses0 = jnp.stack(poses0)
    return PoseGraph(poses0, edges, meas, weights), poses_gt


@pytest.mark.slow
def test_posegraph_reduces_error(key):
    graph, poses_gt = _ring_graph(key)
    r0 = float(jnp.sum(posegraph_residuals(graph) ** 2))
    out = optimize_posegraph(graph, gn_iters=10, cg_iters=60)
    r1 = float(jnp.sum(posegraph_residuals(out) ** 2))
    assert r1 < 1e-10, (r0, r1)
    assert float(ate_rmse(out.poses, poses_gt)) < 1e-4


def test_posegraph_weights_disable_edges(key):
    graph, _ = _ring_graph(key)
    w = graph.weights.at[3].set(0.0)
    g2 = PoseGraph(graph.poses, graph.edges, graph.meas, w)
    r = posegraph_residuals(g2)
    assert float(jnp.sum(r[3] ** 2)) == 0.0


def test_dense_posegraph_matches_cg(key):
    """The dense-GN pose graph (vectorized Jacobian + direct solve) must
    agree with the matrix-free CG optimizer at convergence — same normal
    equations, different solvers.  (Dense measured slower at the capstone
    size, so CG stays the default; dense is kept for small-graph debug use.)"""
    from sks_tpu.geom.lie import se3_exp
    from sks_tpu.slam.posegraph import (
        PoseGraph,
        _inv_se3,
        optimize_posegraph,
        optimize_posegraph_dense,
    )

    k = 6
    ang = 0.05 * jnp.arange(k, dtype=jnp.float32)
    xi = jnp.stack([ang, 0 * ang, ang * 0.3, 0 * ang, 0 * ang, ang], -1)
    poses_gt = se3_exp(xi)
    edges = jnp.stack([jnp.arange(k - 1), jnp.arange(1, k)], -1).astype(
        jnp.int32
    )
    meas = _inv_se3(poses_gt[edges[:, 0]]) @ poses_gt[edges[:, 1]]
    # Start from perturbed poses; both optimizers must recover the chain.
    noise = 0.02 * jax.random.normal(key, (k, 6), jnp.float32)
    poses0 = se3_exp(xi + noise.at[0].set(0.0))
    g = PoseGraph(poses0, edges, meas, jnp.ones((k - 1,), jnp.float32))
    out_cg = optimize_posegraph(g, gn_iters=8, cg_iters=40).poses
    out_dn = optimize_posegraph_dense(g, gn_iters=8).poses
    assert np.allclose(np.asarray(out_cg), np.asarray(out_dn), atol=1e-3)
    # And both actually reduced the residual vs the start.
    from sks_tpu.slam.posegraph import posegraph_residuals

    r0 = float(jnp.sum(posegraph_residuals(g) ** 2))
    r1 = float(jnp.sum(posegraph_residuals(
        PoseGraph(out_dn, edges, meas, g.weights)) ** 2))
    assert r1 < 1e-3 * max(r0, 1e-12), (r0, r1)
