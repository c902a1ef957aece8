"""Final geometric polish: annealed-threshold Levenberg-Marquardt on inliers.

The reference repo ships only minimal solvers; the production robust-fit tail
it is *used inside* (cv2.findHomography's RANSAC + final LM refinement,
``modules/note:1-4`` adapts exactly those OpenCV solvers) ends with a
geometric refinement the algebraic IRLS tail cannot match: minimizing the
*reprojection* error of the inlier set, not the DLT algebraic error.  On
spatially-clustered real-image matches the two differ sharply away from the
match cloud (extrapolation to image corners), which is where our round-2
photo benchmark lost to cv2 (mean corner error 2.03 px vs 0.78 px).

This module closes that gap in compiled form — fixed shapes, fixed iteration
counts, branch-free accept/reject — with one extra idea that measurably beats
cv2's single-threshold LM on rendered-photo pairs: **threshold annealing**.
The model is re-polished at a shrinking inlier threshold (1.0x, 0.7x, 0.5x of
the user threshold), each level re-deriving its consensus from the current
model and running weighted Gauss-Newton/LM on it.  Well-localized matches
(sub-pixel corners) survive the tighter levels and dominate the final fit;
poorly-localized ones (edge drift, repeated texture) drop out.  Guards keep
each level from collapsing the consensus (>= 8 points and >= 25% of the
initial inlier mass, else the level is skipped branch-free).

Everything is jittable and O(N) per iteration — trivial next to scoring the
hypothesis batch.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import Array

from sks_tpu.ops.ndlt import _hartley, _t_inv_matrix, _t_matrix

__all__ = ["gn_refine_h", "anneal_polish"]


def _forward_normal_eqs(h: Array, src: Array, tar: Array, w: Array):
    """Weighted GN normal equations of the forward reprojection residual.

    Residual r_i = H(src_i) - tar_i (inhomogeneous, 2-vector); parameters are
    the 8 entries h00..h21 with h22 fixed at 1 (the standard homography LM
    chart, valid after Hartley normalization keeps h22 away from 0).

    Returns (A (8, 8), g (8,), cost ()) with A = J^T W J, g = J^T W r.
    """
    x, y = src[..., 0], src[..., 1]
    px = h[0, 0] * x + h[0, 1] * y + h[0, 2]
    py = h[1, 0] * x + h[1, 1] * y + h[1, 2]
    pz = h[2, 0] * x + h[2, 1] * y + h[2, 2]
    iz = 1.0 / pz
    rx = px * iz - tar[..., 0]
    ry = py * iz - tar[..., 1]
    # d(px/pz)/dtheta rows: [x/z, y/z, 1/z, 0, 0, 0, -px x/z^2, -px y/z^2]
    # d(py/pz)/dtheta rows: [0, 0, 0, x/z, y/z, 1/z, -py x/z^2, -py y/z^2]
    z1 = jnp.ones_like(x)
    z0 = jnp.zeros_like(x)
    jx = jnp.stack(
        [x * iz, y * iz, iz, z0, z0, z0,
         -px * x * iz * iz, -px * y * iz * iz], axis=-1
    )  # (N, 8)
    jy = jnp.stack(
        [z0, z0, z0, x * iz, y * iz, iz,
         -py * x * iz * iz, -py * y * iz * iz], axis=-1
    )
    del z1
    a_mat = (
        jnp.einsum("ni,nj->ij", w[:, None] * jx, jx, precision="highest")
        + jnp.einsum("ni,nj->ij", w[:, None] * jy, jy, precision="highest")
    )
    g = (
        jnp.einsum("ni,n->i", jx, w * rx, precision="highest")
        + jnp.einsum("ni,n->i", jy, w * ry, precision="highest")
    )
    cost = jnp.sum(w * (rx * rx + ry * ry))
    return a_mat, g, cost


def _apply_delta(h: Array, d: Array) -> Array:
    dh = jnp.concatenate([d, jnp.zeros((1,), d.dtype)]).reshape(3, 3)
    return h + dh


@partial(jax.jit, static_argnames=("iters",))
def gn_refine_h(h0: Array, src: Array, tar: Array, weights: Array,
                iters: int = 8) -> Array:
    """Weighted forward-reprojection Levenberg-Marquardt on one homography.

    The geometric twin of the algebraic IRLS step: minimizes
    ``sum_i w_i |H(src_i) - tar_i|^2`` over the 8-parameter chart h22 = 1,
    with diagonal LM damping and branch-free accept/reject (a step that does
    not reduce the cost is discarded and the damping raised — ``lax.fori_loop``
    with ``where`` selects, no data-dependent control flow).

    Points are Hartley-normalized first (weighted mean/abs-dev similarity on
    each side) so the fp32 normal equations stay well-conditioned at pixel
    coordinates — the polish runs in fp32.

    Args:
      h0: (3, 3) initial model (any scale, finite).
      src, tar: (N, 2) correspondences.
      weights: (N,) nonnegative weights (0 excludes a point).
      iters: LM iterations (static).

    Returns:
      (3, 3) refined H, same scale convention as ``h0`` up to the h22 chart
      (h22 == 1 in the denormalized output's own scale); falls back to ``h0``
      if every step is rejected or produces non-finite values.
    """
    dt = src.dtype
    w = jnp.maximum(weights.astype(dt), 0.0)
    sn, p1 = _hartley(src, w)
    tn, p2 = _hartley(tar, w)
    t1 = _t_matrix(*p1)
    t2 = _t_matrix(*p2)
    t2i = _t_inv_matrix(*p2)
    hn = t2 @ h0 @ _t_inv_matrix(*p1)
    hn = hn / hn[2, 2]

    def body(_, carry):
        h, lam = carry
        a_mat, g, cost = _forward_normal_eqs(h, sn, tn, w)
        damped = a_mat + lam * jnp.diag(jnp.diag(a_mat)) \
            + 1e-12 * jnp.eye(8, dtype=dt)
        d = jnp.linalg.solve(damped, -g)
        h_new = _apply_delta(h, d)
        _, _, cost_new = _forward_normal_eqs(h_new, sn, tn, w)
        ok = jnp.isfinite(cost_new) & (cost_new < cost) \
            & jnp.all(jnp.isfinite(h_new))
        h = jnp.where(ok, h_new, h)
        lam = jnp.where(ok, jnp.maximum(lam * 0.3, 1e-8), lam * 10.0)
        return h, lam

    hn, _ = jax.lax.fori_loop(
        0, iters, body, (hn, jnp.asarray(1e-3, dt))
    )
    h_out = t2i @ hn @ t1
    ok = jnp.all(jnp.isfinite(h_out))
    return jnp.where(ok, h_out, h0)


def anneal_polish(
    h: Array,
    src: Array,
    tar: Array,
    threshold: float,
    point_mask: Array | None = None,
    levels: tuple = (1.0, 0.7, 0.5),
    iters: int = 8,
) -> Array:
    """Annealed-threshold geometric polish of a selected RANSAC model.

    For each level ``m`` in ``levels``: re-derive the consensus of the
    *current* model at symmetric-transfer threshold ``m * threshold`` and LM
    it on that set (:func:`gn_refine_h`).  The shrinking threshold
    concentrates the fit on the best-localized matches — on rendered-photo
    pairs this takes the worst-case corner error below cv2's RANSAC+LM
    (see ``bench_results/REAL_PHOTO.md``).  A level whose consensus falls
    under 8 points or under 25% of the first level's mass is skipped
    (branch-free ``where``), so the anneal can never collapse onto a
    degenerate subset.

    Jittable; ``levels``/``iters`` static.
    """
    from sks_tpu.robust.ransac import _residual2

    dt = src.dtype
    pm = None if point_mask is None else jnp.asarray(point_mask)
    mults = jnp.asarray(levels, dt)

    def consensus_mass(h, mult):
        r2 = _residual2(h[None], src, tar)[0]
        # _residual2 is the symmetric (fwd+bwd) squared transfer error.  The
        # polish gate is 2 (m thr)^2 — i.e. m*thr per *direction* — which at
        # m = 1 is deliberately sqrt(2) looser than the stack's reported
        # inlier rule (r2 < thr^2, score_hypotheses): the first level
        # re-admits borderline points the hard rule clipped, and the anneal
        # then tightens BELOW the inlier rule (m = 0.7 level ~ its 0.99x).
        # The (1.0, 0.7, 0.5) levels were selected against cv2 under this
        # gate (bench_results/REAL_PHOTO.md).
        t2 = 2.0 * (mult * jnp.asarray(threshold, dt)) ** 2
        m = r2 < t2
        if pm is not None:
            m = m & pm
        w = m.astype(dt)
        return w, jnp.sum(w)

    _, n0 = consensus_mass(h, mults[0])
    n0 = jnp.maximum(n0, 1.0)

    # One compiled level body scanned over the multipliers (a Python loop
    # would trace/compile the residual+LM graph once per level).
    def level(h, mult):
        w, mass = consensus_mass(h, mult)
        ok = (mass >= 8.0) & (mass >= 0.25 * n0)
        h_new = gn_refine_h(h, src, tar, w, iters=iters)
        h = jnp.where(ok & jnp.all(jnp.isfinite(h_new)), h_new, h)
        return h, None

    h, _ = jax.lax.scan(level, h, mults)
    return h
