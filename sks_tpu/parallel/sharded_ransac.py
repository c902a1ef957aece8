"""RANSAC sharded over a device mesh.

Hypotheses are embarrassingly parallel (the scaling axis the reference pushes
to B=1M on one GPU, SURVEY.md §5 "long-context" analogue): each device draws
and scores its own slice of the hypothesis budget against the (replicated,
small) correspondence set; the consensus is an all-gather of each device's
top-K models, a few hundred bytes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import Array
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from sks_tpu.ops import SOLVERS_H, aca_valid_mask, sks_valid_mask
from sks_tpu.robust.ransac import (
    RansacConfig,
    RansacResult,
    _refine_and_pack,
    sample_minimal_sets,
    score_hypotheses,
)

__all__ = ["sharded_ransac_homography"]


def sharded_ransac_homography(
    mesh: Mesh,
    key: Array,
    src: Array,
    tar: Array,
    config: RansacConfig = RansacConfig(),
    axis: str | tuple[str, ...] = "hyp",
) -> RansacResult:
    """RANSAC with the hypothesis batch sharded across ``mesh[axis]``.

    ``config.num_hypotheses`` is the *global* budget; each device runs
    ``B / n_devices`` hypotheses.  Deterministic: per-device streams are
    ``fold_in(key, device_index)``, so the set of hypotheses is a pure function
    of (key, mesh size).

    ``axis`` may be a tuple of mesh axis names — the multi-host layout
    (``parallel.distributed.global_mesh``) passes ``('host', 'hyp')`` so
    hypotheses shard across hosts *and* their local devices; the only
    cross-device traffic is the top-K consensus gather (~K x 9 floats).

    Returns a replicated RansacResult (identical on every device).
    """
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    n_dev = 1
    for a in axes:
        n_dev *= mesh.shape[a]
    assert config.num_hypotheses % n_dev == 0, (config.num_hypotheses, n_dev)
    b_local = config.num_hypotheses // n_dev
    n = src.shape[-2]
    solver = SOLVERS_H[config.solver]
    k_local = max(1, min(config.lo_candidates, b_local))

    def shard_fn(key, src, tar):
        # Linearized device index over the (possibly multi-axis) shard axes.
        dev = jnp.asarray(0, jnp.int32)
        for a in axes:
            dev = dev * mesh.shape[a] + jax.lax.axis_index(a)
        k = jax.random.fold_in(key, dev)
        idx = sample_minimal_sets(k, n, b_local)
        s4 = jnp.take(src, idx, axis=0)
        t4 = jnp.take(tar, idx, axis=0)
        h = solver(s4, t4)
        if config.solver == "aca":
            valid = aca_valid_mask(s4, t4)
            h = jnp.where(valid[..., None, None], h, jnp.nan)
        elif config.solver == "sks":
            valid = sks_valid_mask(s4, t4)
            h = jnp.where(valid[..., None, None], h, jnp.nan)
        scores, _ = score_hypotheses(
            h, src, tar, config.threshold, None, config.scoring,
            config.sigma_max,
        )
        sc_loc, top = jax.lax.top_k(scores, k_local)
        h_loc = h[top]
        # Local top-K stays sharded; the global reduction happens outside.
        return h_loc, sc_loc

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P(axes), P(axes)),
        check_vma=False,  # inputs are replicated, outputs sharded over axis
    )
    h_all, sc_all = fn(key, src, tar)  # (n_dev * k_local, 3, 3), (n_dev*k,)

    # Global consensus: top-K of the device-local top-Ks (the all-gather of
    # (n_dev*K) 9-float models is the only cross-device traffic).
    k_cand = max(1, min(config.lo_candidates, n_dev * k_local))
    sc_top, idx = jax.lax.top_k(sc_all, k_cand)
    h_top = h_all[idx]
    _, inl0 = score_hypotheses(
        h_top[:1], src, tar, config.threshold, None, config.scoring,
        config.sigma_max,
    )
    return _refine_and_pack(h_top, sc_top, inl0[0], src, tar, config, None)
