"""Distributed pose-graph optimization: edge-sharded Gauss-Newton over psum.

The multi-chip half of ``sks_tpu.slam.posegraph`` (the design its docstring
promises), following the same recipe as ``sharded_ba``: every Gauss-Newton
quantity is a sum over *edges* —

    g    = J^T r          = sum_e J_e^T r_e
    H v  = J^T J v        = sum_e J_e^T (J_e v)

— so the edge axis shards across the mesh.  Poses (K, 6-DOF) are replicated
(pose graphs are small next to their edge sets once loop closures and
covisibility edges pile up); each device evaluates residual/JVP/VJP only for
its edge shard, and one ``psum`` of a (K, 6) vector per CG application rides
the interconnect.  The gauge prior (``fix_first``) is edge-independent and is added
analytically *after* the psum so it is counted exactly once.

Numerically identical to ``slam.posegraph.optimize_posegraph`` (the psum is
exact); tested against it on the CPU mesh (tests/test_parallel.py).  No
reference counterpart: the reference is single-device (SURVEY.md §2.6).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sks_tpu.geom.lie import se3_exp
from sks_tpu.slam.posegraph import PoseGraph, posegraph_residuals

__all__ = ["sharded_optimize_posegraph", "shard_graph"]


def shard_graph(graph: PoseGraph, mesh: Mesh, axis: str = "edge") -> PoseGraph:
    """Device-put a PoseGraph with edges sharded over ``mesh[axis]``.

    The mesh axis size must divide the edge count — pad with zero-weight
    edges (weights 0 disables an edge) to round up, the same fixed-shape
    padding convention the rest of the stack uses.
    """
    e = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    return PoseGraph(
        poses=jax.device_put(graph.poses, rep),
        edges=jax.device_put(graph.edges, e),
        meas=jax.device_put(graph.meas, e),
        weights=jax.device_put(graph.weights, e),
    )


@partial(jax.jit, static_argnames=("mesh", "gn_iters", "cg_iters",
                                   "fix_first", "axis"))
def sharded_optimize_posegraph(
    mesh: Mesh,
    graph: PoseGraph,
    gn_iters: int = 10,
    cg_iters: int = 50,
    damping: float = 1e-6,
    fix_first: bool = True,
    axis: str = "edge",
) -> PoseGraph:
    """Edge-sharded matrix-free Gauss-Newton (psum per CG matvec)."""
    k = graph.poses.shape[0]
    dtype = graph.poses.dtype
    damping = jnp.asarray(damping, dtype)
    prior = jnp.asarray(1e6 if fix_first else 0.0, dtype)  # (1e3)^2 weight

    def local(poses, edges, meas, weights, damping):
        def step(poses):
            zero = jnp.zeros((k, 6), dtype)

            def res(dx):
                # Residuals of the local edge shard only (no gauge rows —
                # the prior is added analytically post-psum).
                g = PoseGraph(poses, edges, meas, weights)
                return posegraph_residuals(g, dx).reshape(-1)

            r0 = res(zero)
            _, vjp = jax.vjp(res, zero)
            g_loc = vjp(r0)[0]
            g = jax.lax.psum(g_loc, axis)
            # Gauge prior on node 0: r_p = 1e3 dx[0] => J^T r = 1e6 dx[0] = 0
            # at dx = 0; only the matvec term is nonzero.

            def jtjv(v):
                vk = v.reshape(k, 6)
                _, jv = jax.jvp(res, (zero,), (vk,))
                h_loc = vjp(jv)[0]
                h = jax.lax.psum(h_loc, axis)
                h = h.at[0].add(prior * vk[0])
                return (h + damping * vk).reshape(-1)

            dx = _cg(jtjv, -g.reshape(-1), cg_iters).reshape(k, 6)
            return poses @ se3_exp(dx)

        for _ in range(gn_iters):
            poses = step(poses)
        return poses

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P()),
        out_specs=P(),
        check_vma=False,
    )
    poses = fn(graph.poses, graph.edges, graph.meas, graph.weights, damping)
    return PoseGraph(poses=poses, edges=graph.edges, meas=graph.meas,
                     weights=graph.weights)


def _cg(matvec, b, iters: int, eps: float = 1e-12):
    """Plain fixed-iteration CG (identical to slam.posegraph._cg; local copy
    keeps the collective structure visible in one file)."""
    x = jnp.zeros_like(b)
    r = b
    p = r
    rs = jnp.sum(r * r)

    def body(_, carry):
        x, r, p, rs = carry
        ap = matvec(p)
        alpha = rs / jnp.maximum(jnp.sum(p * ap), eps)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = jnp.sum(r * r)
        beta = rs_new / jnp.maximum(rs, eps)
        p = r + beta * p
        return x, r, p, rs_new

    x, _, _, _ = jax.lax.fori_loop(0, iters, body, (x, r, p, rs))
    return x
