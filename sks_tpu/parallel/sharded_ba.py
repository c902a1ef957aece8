"""Distributed bundle adjustment: landmark-sharded Schur assembly over psum.

The multi-chip half of ``sks_tpu.slam.ba`` (SURVEY.md §2.6/§7): every term of
the Schur system

    S  = B - sum_l E_l C_l^{-1} E_l^T        (6K, 6K)
    rhs = v - sum_l E_l C_l^{-1} w_l         (6K,)

is a sum over landmarks, so the landmark axis shards across the mesh: each
device linearizes only its landmark shard (Jacobians, C-blocks, partial S),
one ``psum`` assembles the global camera system (a few hundred KB),
the replicated dense solve is tiny, and the landmark back-substitution is
local to each shard.  Cameras are replicated (keyframe windows are small);
landmark counts are the scaling axis, exactly like hypothesis counts in
sharded RANSAC.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sks_tpu.geom.lie import se3_exp
from sks_tpu.slam.ba import BAProblem, build_normal_blocks

__all__ = ["sharded_gauss_newton_step", "shard_problem"]


def shard_problem(problem: BAProblem, mesh: Mesh, axis: str = "lm") -> BAProblem:
    """Device-put a BAProblem with landmarks sharded over ``mesh[axis]``."""
    lm = NamedSharding(mesh, P(axis))
    lm2 = NamedSharding(mesh, P(None, axis))
    rep = NamedSharding(mesh, P())
    return BAProblem(
        poses=jax.device_put(problem.poses, rep),
        points=jax.device_put(problem.points, lm),
        intrinsics=jax.device_put(problem.intrinsics, rep),
        obs=jax.device_put(problem.obs, lm2),
        mask=jax.device_put(problem.mask, lm2),
    )


def sharded_gauss_newton_step(
    mesh: Mesh,
    problem: BAProblem,
    damping: float = 1e-6,
    fix_first: bool = True,
    axis: str = "lm",
) -> BAProblem:
    """One GN step with landmark-sharded Schur reduction.

    Numerically identical to ``slam.ba.gauss_newton_step`` (the psum is exact);
    tested against it on the CPU mesh.  Damping is a traced operand so repeated
    steps (and damping schedules) reuse one compilation.
    """
    new_poses, new_points = _sharded_gn_step(
        mesh, problem, jnp.asarray(damping, problem.poses.dtype), fix_first,
        axis,
    )
    return BAProblem(
        poses=new_poses,
        points=new_points,
        intrinsics=problem.intrinsics,
        obs=problem.obs,
        mask=problem.mask,
    )


@partial(jax.jit, static_argnames=("mesh", "fix_first", "axis"))
def _sharded_gn_step(
    mesh: Mesh,
    problem: BAProblem,
    damping,
    fix_first: bool,
    axis: str,
):
    kk = problem.poses.shape[0]
    dtype = problem.poses.dtype

    def local(poses, points, intrinsics, obs, mask, damping):
        # Local shard: (L/n) landmarks. Build local blocks.
        lp = BAProblem(poses, points, intrinsics, obs, mask)
        b, e, c, v, w = build_normal_blocks(lp)
        c = c + damping * jnp.eye(3, dtype=dtype)
        c_inv = jnp.linalg.inv(c)
        ec = jnp.einsum("klij,ljm->klim", e, c_inv)
        s_off = jnp.einsum("klim,qljm->kqij", ec, e)
        rhs_corr = jnp.einsum("klim,lm->ki", ec, w)

        # Landmark sums -> global via psum.  b and v are *observation* sums —
        # already split across landmark shards, so psum is correct for them too.
        s_off = jax.lax.psum(s_off, axis)
        b = jax.lax.psum(b, axis)
        v = jax.lax.psum(v, axis)
        rhs_corr = jax.lax.psum(rhs_corr, axis)
        if fix_first:
            b = b.at[0].add(jnp.asarray(1e12, dtype) * jnp.eye(6, dtype=dtype))

        s = -s_off
        s = s.at[jnp.arange(kk), jnp.arange(kk)].add(
            b + damping * jnp.eye(6, dtype=dtype)
        )
        s_dense = s.transpose(0, 2, 1, 3).reshape(kk * 6, kk * 6)
        rhs = (v - rhs_corr).reshape(kk * 6)
        dx_c = jnp.linalg.solve(s_dense, rhs).reshape(kk, 6)

        # Back-substitution is local to the shard.
        et_dx = jnp.einsum("klij,ki->lj", e, dx_c)
        dx_p = jnp.einsum("lij,lj->li", c_inv, w - et_dx)
        return poses @ se3_exp(dx_c), points + dx_p

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis), P(), P(None, axis), P(None, axis), P()),
        out_specs=(P(), P(axis)),
        check_vma=False,
    )
    return fn(
        problem.poses, problem.points, problem.intrinsics, problem.obs,
        problem.mask, damping,
    )
