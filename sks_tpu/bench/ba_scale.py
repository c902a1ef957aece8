"""Distributed BA at realistic scale: K cameras x L landmarks on a mesh.

Round-1 review: the sharded-BA tests used K=3, L~64; this CLI runs the
landmark-sharded Schur solver (``parallel.sharded_ba``) at production scale
(default K=20, L=10,240) on whatever mesh the backend offers (the virtual
8-device CPU mesh in CI; the host's GPUs on a card), reporting time/iteration
and the convergence trace.

Run:  python -m sks_tpu.bench.ba_scale [--cams 20] [--points 10240]
      [--iters 8] [--out bench_results/BA_SCALE.json]
"""

from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp

from sks_tpu.parallel.mesh import make_mesh
from sks_tpu.parallel.sharded_ba import shard_problem, sharded_gauss_newton_step
from sks_tpu.slam.ba import rms_reprojection, synth_ba_problem

__all__ = ["run"]


def run(num_cams: int = 20, num_points: int = 10_240, iters: int = 8,
        seed: int = 0, damping: float = 1e-4):
    n_dev = len(jax.devices())
    assert num_points % n_dev == 0, (num_points, n_dev)
    mesh = make_mesh({"lm": n_dev})
    key = jax.random.PRNGKey(seed)
    gt, prob = synth_ba_problem(key, num_cams, num_points)
    prob = shard_problem(prob, mesh)

    rms = [float(rms_reprojection(prob))]
    # Warm-up/compile (one step), then timed steps reusing the executable.
    p = sharded_gauss_newton_step(mesh, prob, damping)
    jax.block_until_ready(p.poses)
    t0 = time.perf_counter()
    p = prob
    for _ in range(iters):
        p = sharded_gauss_newton_step(mesh, p, damping)
        rms.append(float(rms_reprojection(p)))
    jax.block_until_ready(p.poses)
    dt = (time.perf_counter() - t0) / iters

    # Pose accuracy vs ground truth (camera-center RMS; gauge: cam0 fixed).
    c_est = p.poses[:, :3, 3]
    c_gt = gt.poses[:, :3, 3]
    pose_rms = float(jnp.sqrt(jnp.mean(jnp.sum((c_est - c_gt) ** 2, -1))))

    return {
        "backend": jax.default_backend(),
        "devices": n_dev,
        "cams": num_cams,
        "points": num_points,
        "observations": int(jnp.sum(p.mask)),
        "sec_per_iteration": dt,
        "rms_reprojection_px": rms,
        "pose_center_rms": pose_rms,
        "converged": rms[-1] < 1.2 * 0.5,  # ~noise floor (0.5 px obs noise)
    }


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=20)
    ap.add_argument("--points", type=int, default=10_240)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    out = run(args.cams, args.points, args.iters, args.seed)
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}")
