"""Frames -> poses in ONE jit: the BASELINE config-5 pipeline.

The full planar-VO front+back end fused into a single compiled program:
pyramid Harris detection, oriented patch description, mutual-NN/ratio
matching, vectorized RANSAC, homography -> pose decomposition, metric scale
chaining.  No host round trips between stages — the whole T-frame batch is
device-resident from pixels to trajectory (the reference's pipelines cross
the host boundary at every OpenCV call; SURVEY.md §3).

Two entry points:

- :func:`frames_to_poses` — single device, one jit.
- :func:`sharded_frames_to_poses` — the keyframe-sharded multi-chip form:
  consecutive frame *pairs* shard across the mesh (each chip matches and
  fits its pair shard — detection/matching/RANSAC are embarrassingly
  parallel over pairs), one ``all_gather`` of the tiny per-pair
  (R, t/d, n, inliers) tuples crosses devices, and the metric chain (an
  associative scan over T 4x4 matrices) is replicated.  Matches the
  single-device result to float tolerance (same per-pair fold_in streams;
  XLA may reassociate reductions under shard_map, flipping borderline
  ratio-test matches — see tests/test_pipeline.py).

Benchmarked in ``bench/pipeline_fps.py`` (frames/s on the device).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import Array, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from sks_tpu.features.matching import (
    describe_frames,
    match_features,
    match_frames_oriented,
)
from sks_tpu.robust.ransac import RansacConfig
from sks_tpu.slam.odometry import chain_metric, fit_pair

__all__ = ["frames_to_poses", "sharded_frames_to_poses", "planar_slam",
           "sharded_planar_slam"]


def _match_pad(f1: Array, f2: Array, num_corners: int, num_octaves: int,
               shape: tuple):
    """Match one pair; pad invalid slots to the image center (masked out)."""
    p1, p2, valid, _ = match_frames_oriented(f1, f2, num_corners, num_octaves)
    center = jnp.asarray([shape[1] / 2.0, shape[0] / 2.0], jnp.float32)
    p1 = jnp.where(valid[..., None], p1, center)
    p2 = jnp.where(valid[..., None], p2, center)
    return p1, p2, valid


def _match_pairs_cached(frames: Array, idx1, idx2, num_corners: int,
                        num_octaves: int):
    """Detect+describe every frame ONCE, then match the (idx1, idx2) pairs.

    The pair-at-a-time form detects/describes each interior frame twice;
    per-frame caching halves the front-end cost with bit-identical features
    (round 5 — see :func:`sks_tpu.features.matching.describe_frames`).
    Invalid match slots are padded to the image center (masked out).
    """
    shape = frames.shape[-2:]
    feats = describe_frames(frames, num_corners, num_octaves)
    f_i = jax.tree.map(lambda a: a[idx1], feats)
    f_j = jax.tree.map(lambda a: a[idx2], feats)
    p1, p2, valid, _ = jax.vmap(match_features)(f_i, f_j)
    center = jnp.asarray([shape[1] / 2.0, shape[0] / 2.0], jnp.float32)
    p1 = jnp.where(valid[..., None], p1, center)
    p2 = jnp.where(valid[..., None], p2, center)
    return p1, p2, valid


def _fit_matches(key, p1s, p2s, masks, k_mat, config, plane_normal,
                 frames1=None, frames2=None, pair_offset=0, esm_iters=0):
    """RANSAC + pose for pre-matched pair batches (vmapped, one trace)."""
    from sks_tpu.utils.rng import fold_in_stream

    keys = fold_in_stream(key, p1s.shape[0], offset=pair_offset)
    if esm_iters:
        return jax.vmap(
            lambda k, p1, p2, pm, f1, f2: fit_pair(
                k, p1, p2, pm, k_mat, config, plane_normal, f1, f2,
                esm_iters)
        )(keys, p1s, p2s, masks, frames1, frames2)
    return jax.vmap(
        lambda k, p1, p2, pm: fit_pair(k, p1, p2, pm, k_mat, config,
                                       plane_normal)
    )(keys, p1s, p2s, masks)


def _fit_pairs(key, frames1, frames2, k_mat, config, num_corners,
               num_octaves, plane_normal, pair_offset=0, esm_iters=0):
    """Match + RANSAC + pose for a batch of pairs (vmapped, one trace)."""
    shape = frames1.shape[-2:]
    p1s, p2s, masks = jax.vmap(
        lambda a, b: _match_pad(a, b, num_corners, num_octaves, shape)
    )(frames1, frames2)
    return _fit_matches(key, p1s, p2s, masks, k_mat, config, plane_normal,
                        frames1, frames2, pair_offset, esm_iters)


@partial(jax.jit, static_argnames=("config", "num_corners", "num_octaves",
                                   "plane_depth", "esm_iters"))
def frames_to_poses(
    key: Array,
    frames: Array,
    k_mat: Array,
    config: RansacConfig = RansacConfig(num_hypotheses=1024),
    num_corners: int = 384,
    num_octaves: int = 2,
    plane_depth: float = 1.0,
    plane_normal: Array | None = None,
    esm_iters: int = 0,
):
    """(T, H, W) grayscale frames -> (T, 4, 4) cam->world poses, one jit.

    ``esm_iters > 0`` densely ESM-polishes every pair's RANSAC model against
    the pixels before pose recovery (``slam.tracking.esm_polish_pair``).

    Returns dict: poses, rel (T-1, 4, 4), num_inliers (T-1,).
    """
    if plane_normal is None:
        plane_normal = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
    t = frames.shape[0]
    idx = jnp.arange(t - 1)
    p1s, p2s, masks = _match_pairs_cached(frames, idx, idx + 1, num_corners,
                                          num_octaves)
    r, t_over_d, n, ninl = _fit_matches(
        key, p1s, p2s, masks, k_mat, config, plane_normal,
        frames[:-1], frames[1:], esm_iters=esm_iters,
    )
    rel, poses, _ = chain_metric(r, t_over_d, n, plane_depth)
    return {"poses": poses, "rel": rel, "num_inliers": ninl}


@partial(jax.jit, static_argnames=("config", "num_corners", "num_octaves",
                                   "plane_depth", "strides", "smooth",
                                   "esm_iters"))
def planar_slam(
    key: Array,
    frames: Array,
    k_mat: Array,
    config: RansacConfig = RansacConfig(num_hypotheses=1024),
    num_corners: int = 384,
    num_octaves: int = 2,
    plane_depth: float = 1.0,
    plane_normal: Array | None = None,
    strides: tuple = (4, 8),
    smooth: bool = True,
    esm_iters: int = 8,
):
    """The full planar-SLAM capstone in ONE jit: pixels -> loop-closed poses.

    Detection, description, matching (consecutive AND frame-i<->i+k closure
    candidates), RANSAC homography fits, pose recovery, metric chaining, and
    pose-graph relaxation over odometry + loop-closure edges — the whole
    system a production caller invokes, with every stage device-resident.

    Args:
      frames: (T, H, W) grayscale sequence.
      strides: closure-candidate strides (frame i matched against i+k for
        each k; static — see ``slam.odometry.closure_candidates``).
      smooth: pose-graph relaxation (odometry + inlier-gated closure edges).
        With ``smooth=False`` this reduces to :func:`frames_to_poses` plus
        closure diagnostics.
      esm_iters: static; > 0 densely ESM-polishes every pair fit
        (consecutive and closure) against the pixels before pose recovery.
        DEFAULT ON (8, round 5): the symmetric full-frame polish beats the
        feature-only fit on every bundled photo texture's VO
        (``slam.tracking.esm_polish_pair_symmetric``; pinned by
        tests/test_photo_pipeline.py) — the capstone defaults to accuracy;
        pass 0 for the pure-feature throughput configuration.

    Returns:
      dict: poses (T, 4, 4), rel (T-1, 4, 4), num_inliers (T-1,),
      closure_inliers (E,).  On a rendered closed circuit the closures cut
      ATE ~3.9x vs the raw chain (bench_results/LOOP_CLOSURE.json).
    """
    from sks_tpu.slam.odometry import closure_candidates, vo_trajectory

    t = frames.shape[0]
    idx = jnp.arange(t - 1)
    pairs = closure_candidates(t, strides)
    if pairs:
        # ONE describe_frames serves consecutive AND closure matching.
        cp = jnp.asarray(pairs, jnp.int32)
        i1 = jnp.concatenate([idx, cp[:, 0]])
        i2 = jnp.concatenate([idx + 1, cp[:, 1]])
        p1a, p2a, ma = _match_pairs_cached(frames, i1, i2, num_corners,
                                           num_octaves)
        p1s, p2s, masks = p1a[:t - 1], p2a[:t - 1], ma[:t - 1]
        c1s, c2s, cmasks = p1a[t - 1:], p2a[t - 1:], ma[t - 1:]
    else:
        p1s, p2s, masks = _match_pairs_cached(frames, idx, idx + 1,
                                              num_corners, num_octaves)
    if not pairs:
        # Too few frames for any closure stride (T <= min(strides)): reduce
        # to the plain odometry chain (ADVICE r3 — the empty (0, 2) closure
        # array would crash indexing downstream).
        out = vo_trajectory(
            key, p1s, p2s, k_mat, config, plane_depth=plane_depth,
            smooth=smooth, plane_normal=plane_normal, point_mask=masks,
            frames=frames, esm_iters=esm_iters,
        )
        out["closure_inliers"] = jnp.zeros((0,), jnp.int32)
        return out
    return vo_trajectory(
        key, p1s, p2s, k_mat, config, plane_depth=plane_depth,
        smooth=smooth, plane_normal=plane_normal, point_mask=masks,
        closure_pairs=cp, closure_pts1=c1s, closure_pts2=c2s,
        closure_mask=cmasks, frames=frames, esm_iters=esm_iters,
    )


@partial(jax.jit, static_argnames=("mesh", "config", "num_corners",
                                   "num_octaves", "plane_depth", "axis"))
def sharded_frames_to_poses(
    mesh: Mesh,
    key: Array,
    frames: Array,
    k_mat: Array,
    config: RansacConfig = RansacConfig(num_hypotheses=1024),
    num_corners: int = 384,
    num_octaves: int = 2,
    plane_depth: float = 1.0,
    plane_normal: Array | None = None,
    axis: str = "frame",
):
    """Frame-sharded frames->poses: pairs split across ``mesh[axis]``.

    T-1 (the pair count) must divide the mesh axis size.  Each device runs
    detect/describe/match/RANSAC/pose for its contiguous pair shard with the
    *global* pair index folded into its RNG keys, so results match
    :func:`frames_to_poses` up to float-reassociation tolerance; the
    all_gather moves only (T-1) x (3x3 + 3 + 3 + 1) floats.
    """
    if plane_normal is None:
        plane_normal = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
    t_minus_1 = frames.shape[0] - 1
    n_dev = mesh.shape[axis]
    assert t_minus_1 % n_dev == 0, (t_minus_1, n_dev)
    per_dev = t_minus_1 // n_dev

    frames1 = frames[:-1]
    frames2 = frames[1:]

    def local(key, f1s, f2s, k_mat, plane_normal):
        idx = jax.lax.axis_index(axis)
        r, t_over_d, n, ninl = _fit_pairs(
            key, f1s, f2s, k_mat, config, num_corners, num_octaves,
            plane_normal, pair_offset=idx * per_dev,
        )
        # Tiny per-pair results cross devices; the chain is replicated.
        r = jax.lax.all_gather(r, axis, tiled=True)
        t_over_d = jax.lax.all_gather(t_over_d, axis, tiled=True)
        n = jax.lax.all_gather(n, axis, tiled=True)
        ninl = jax.lax.all_gather(ninl, axis, tiled=True)
        rel, poses, _ = chain_metric(r, t_over_d, n, plane_depth)
        return poses, rel, ninl

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    poses, rel, ninl = fn(key, frames1, frames2, k_mat, plane_normal)
    return {"poses": poses, "rel": rel, "num_inliers": ninl}


@partial(jax.jit, static_argnames=("mesh", "config", "num_corners",
                                   "num_octaves", "plane_depth", "strides",
                                   "smooth", "axis", "esm_iters"))
def sharded_planar_slam(
    mesh: Mesh,
    key: Array,
    frames: Array,
    k_mat: Array,
    config: RansacConfig = RansacConfig(num_hypotheses=1024),
    num_corners: int = 384,
    num_octaves: int = 2,
    plane_depth: float = 1.0,
    plane_normal: Array | None = None,
    strides: tuple = (4, 8),
    smooth: bool = True,
    axis: str = "pair",
    esm_iters: int = 8,
):
    """The sharded capstone: :func:`planar_slam` with ALL pair fits —
    consecutive AND loop-closure — sharded across ``mesh[axis]``.

    Consecutive and closure pairs form ONE combined work list (each item is
    an independent detect/describe/match/RANSAC/pose unit), padded to a
    multiple of the mesh axis size by repeating pair 0 (results discarded),
    and split contiguously across devices.  Per-pair RNG keys are
    precomputed with the SAME stream layout :func:`planar_slam` uses
    (consecutive stream + ``CLOSURE_STREAM_OFFSET`` closure stream), so the
    sharded capstone matches the single-device one up to float-reassociation
    tolerance.  One ``all_gather`` of the tiny (R, t/d, n, inliers) tuples
    crosses devices; the metric chain + pose-graph relaxation
    (``odometry.assemble_trajectory``) are replicated — BASELINE config 5's
    "keyframe-sharded matching + distributed BA" shape at the capstone
    level.

    ``esm_iters > 0`` densely ESM-polishes every sharded pair fit before
    pose recovery, matching :func:`planar_slam`'s option (ADVICE r4) —
    and its round-5 default (8).
    """
    from sks_tpu.slam.odometry import (
        assemble_trajectory,
        closure_candidates,
        fit_pair,
    )
    from sks_tpu.utils.rng import CLOSURE_STREAM_OFFSET, fold_in_stream

    if plane_normal is None:
        plane_normal = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
    t = frames.shape[0]
    consec = [(i, i + 1) for i in range(t - 1)]
    clos = closure_candidates(t, strides)
    pairs = consec + clos
    n_dev = mesh.shape[axis]
    pad = (-len(pairs)) % n_dev
    pidx = jnp.asarray(pairs + [pairs[0]] * pad, jnp.int32)
    f1 = frames[pidx[:, 0]]
    f2 = frames[pidx[:, 1]]
    keys = jnp.concatenate([
        fold_in_stream(key, t - 1),
        fold_in_stream(key, len(clos), offset=CLOSURE_STREAM_OFFSET),
        fold_in_stream(key, pad),  # padding reuses consecutive keys: masked
    ])

    def local(keys, f1s, f2s, k_mat, plane_normal):
        shape = f1s.shape[-2:]
        p1s, p2s, masks = jax.vmap(
            lambda a, b: _match_pad(a, b, num_corners, num_octaves, shape)
        )(f1s, f2s)
        if esm_iters:
            r, td, n, ninl = jax.vmap(
                lambda k, p1, p2, pm, a, b: fit_pair(
                    k, p1, p2, pm, k_mat, config, plane_normal, a, b,
                    esm_iters)
            )(keys, p1s, p2s, masks, f1s, f2s)
        else:
            r, td, n, ninl = jax.vmap(
                lambda k, p1, p2, pm: fit_pair(k, p1, p2, pm, k_mat, config,
                                               plane_normal)
            )(keys, p1s, p2s, masks)
        r = jax.lax.all_gather(r, axis, tiled=True)
        td = jax.lax.all_gather(td, axis, tiled=True)
        n = jax.lax.all_gather(n, axis, tiled=True)
        ninl = jax.lax.all_gather(ninl, axis, tiled=True)
        return r, td, n, ninl

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(), P()),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    r, td, n, ninl = fn(keys, f1, f2, k_mat, plane_normal)
    nc = t - 1
    closure = None
    if clos:
        cp = jnp.asarray(clos, jnp.int32)
        closure = (r[nc:nc + len(clos)], td[nc:nc + len(clos)],
                   ninl[nc:nc + len(clos)], cp)
    return assemble_trajectory(r[:nc], td[:nc], n[:nc], ninl[:nc],
                               plane_depth, smooth, closure=closure)
