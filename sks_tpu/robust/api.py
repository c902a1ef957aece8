"""cv2-style convenience API over the vectorized RANSAC stack.

Migration surface for users of ``cv2.findHomography`` /
``getPerspectiveTransform`` (which the reference's baselines are adapted
from): same call shape, same ``(H, mask)`` return, JAX arrays in and out, one
fixed-shape jit under the hood.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import Array

from sks_tpu.robust.ransac import (
    RansacConfig,
    ransac_homography,
    ransac_homography_adaptive,
)

__all__ = [
    "find_homography",
    "get_perspective_transform",
    "get_affine_transform",
]

_METHODS = ("ransac", "msac", "magsac", "lmeds")


def find_homography(
    src: Array,
    tar: Array,
    method: str = "ransac",
    ransac_reproj_threshold: float = 3.0,
    max_iters: int = 2048,
    solver: str = "aca",
    key: Array | None = None,
    refine_iters: int = 2,
    confidence: float | None = None,
    sampling: str = "uniform",
    point_mask: Array | None = None,
):
    """Robustly fit H mapping src -> tar (the ``cv2.findHomography`` shape).

    Args:
      src, tar: (..., N, 2) matched points, N >= 4.  Leading batch dims are
        vmapped (one fit per batch element; same hypothesis budget each).
      method: 'ransac' (inlier counting), 'msac', 'magsac' (sigma-marginalized
        scoring), or 'lmeds' (threshold-free least-median).
      ransac_reproj_threshold: inlier threshold in pixels (symmetric
        transfer error, like cv2's default semantic).
      max_iters: hypothesis budget.  Without ``confidence`` all hypotheses
        are evaluated at once (fixed shape, no early exit to tune).  With
        ``confidence`` it is the worst-case cap of the early-exit loop.
      solver: minimal solver for hypotheses ('aca', 'sks', 'rho_ge', ...).
      key: PRNG key (default: PRNGKey(0) — deterministic).
      refine_iters: IRLS local-optimization rounds on the consensus set.
      confidence: if set (e.g. 0.995, the cv2 default semantic), run the
        early-exit loop (:func:`ransac_homography_adaptive`): geometrically
        growing chunks (256 -> 1024 -> 4096 -> ... capped at 2^17) until the
        termination bound is met or ``max_iters`` total.
      sampling: 'uniform', or 'prosac' progressive sampling (src/tar must be
        sorted by descending match quality).
      point_mask: optional (..., N) bool validity for padded fixed-shape
        match arrays — masked points never score or refine (every internal
        path supports this; now the cv2-shaped surface does too).

    Returns:
      (H (..., 3, 3) jnp array normalized to H[..., 2, 2]=1,
       mask (..., N) bool inliers).
    """
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, got {method!r}")
    if key is None:
        key = jax.random.PRNGKey(0)
    src = jnp.asarray(src)
    tar = jnp.asarray(tar)

    scoring = "inliers" if method == "ransac" else method

    if confidence is not None:
        chunk = min(256, max_iters)
        config = RansacConfig(
            num_hypotheses=chunk,
            threshold=ransac_reproj_threshold,
            solver=solver,
            refine_iters=refine_iters,
            scoring=scoring,
            sampling=sampling,
        )
        fit = partial(
            ransac_homography_adaptive,
            config=config, confidence=confidence,
            max_chunks=-(-max_iters // chunk),
        )
    else:
        config = RansacConfig(
            num_hypotheses=max_iters,
            threshold=ransac_reproj_threshold,
            solver=solver,
            refine_iters=refine_iters,
            scoring=scoring,
            sampling=sampling,
        )
        fit = partial(ransac_homography, config=config)

    batch_dims = src.ndim - 2
    if batch_dims:
        bshape = src.shape[:-2]
        srcf = src.reshape(-1, *src.shape[-2:])
        tarf = tar.reshape(-1, *tar.shape[-2:])
        from sks_tpu.utils.rng import fold_in_stream

        keys = fold_in_stream(key, srcf.shape[0])
        pmf = (None if point_mask is None
               else jnp.asarray(point_mask).reshape(-1, src.shape[-2]))
        if pmf is None:
            res = jax.vmap(lambda k, s, t: fit(k, s, t))(keys, srcf, tarf)
        else:
            res = jax.vmap(lambda k, s, t, m: fit(k, s, t, point_mask=m))(
                keys, srcf, tarf, pmf
            )
        h = res.h.reshape(*bshape, 3, 3)
        mask = res.inlier_mask.reshape(*bshape, src.shape[-2])
        return h, mask

    res = fit(key, src, tar, point_mask=point_mask)
    return res.h, res.inlier_mask


def get_perspective_transform(src: Array, tar: Array, solver: str = "aca") -> Array:
    """Exact 4-point homography (the ``cv2.getPerspectiveTransform`` shape).

    The reference's GPT-LU baseline is OpenCV's implementation of exactly this
    call (``C++ Codes/modules/GPT.cpp:51-72``, ~1932 flops); here the default
    solver is the 97-flop ACA decomposition (identical result for exact
    4-point input, batched over leading dims).

    Args:
      src, tar: (..., 4, 2) quads.
      solver: any name in ``sks_tpu.ops.SOLVERS`` ('aca', 'sks', 'gpt_lu', ...).

    Returns:
      (..., 3, 3) H with H[..., 2, 2] = 1 mapping src onto tar.
    """
    from sks_tpu.ops import SOLVERS

    return SOLVERS[solver](jnp.asarray(src), jnp.asarray(tar))


def get_affine_transform(src: Array, tar: Array) -> Array:
    """Exact 3-point affine transform (the ``cv2.getAffineTransform`` shape).

    Division-free analogue (see ``sks_tpu.ops.affine``): (..., 3, 2) x2 ->
    (..., 2, 3) affine matrix rows [A | t] with tar = A @ src + t.
    """
    from sks_tpu.ops.affine import affine_3pt

    return affine_3pt(jnp.asarray(src), jnp.asarray(tar))[..., :2, :]
