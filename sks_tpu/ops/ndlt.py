"""NDLT — normalized Direct Linear Transform homography (batched, N >= 4).

Capability parity with ``cv::runKernel_DLT`` (``C++ Codes/modules/DLT.cpp:53-119``)
and the CUDA twin (``GPU_Runtime Test.cu:1034-1160``): Hartley-normalize both
point sets, accumulate the 9x9 normal matrix of the stacked DLT constraints,
take the smallest eigenvector, denormalize.  Differences: batched over
arbitrary leading dims, optional per-point weights (so padded fixed-shape point
sets and IRLS reweighting work under jit), and a branch-free fixed-sweep Jacobi
eigensolver instead of the reference's branchy Golub-Reinsch device SVD.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array

from sks_tpu.ops.linalg import (
    jacobi_eigh,
    jacobi_smallest_col_core,
    mm_highest as _mm,
    smallest_eigvec_sym,
)

__all__ = ["ndlt", "ndlt_core", "ndlt_h"]


def ndlt_core(
    x0, y0, x1, y1, x2, y2, x3, y3,
    X0, Y0, X1, Y1, X2, Y2, X3, Y3,
    sweeps: int = 6,
    jacobi_unroll: bool = False,
    df_eig: str = "invit",
    eig: str = "jacobi",
):
    """Straight-line minimal-set (N=4) NDLT on components.

    Single source for SoA layouts (component-major arrays).
    Exploits the DLT normal matrix's block structure: with per-point
    ``p = (x, y, 1)`` and constraint rows ``[p, 0, -X'p]``, ``[0, p, -Y'p]``,

        LtL = [[S1, 0, Sx], [0, S1, Sy], [Sx, Sy, Sd]]

    where each 3x3 block is a weighted sum of ``p p^T`` with weights
    ``1, -X', -Y', X'^2 + Y'^2`` — 24 scalar sums total instead of a dense
    8x9 stacking.  The smallest eigenvector comes from the lane-parallel
    fixed-sweep Jacobi (:func:`jacobi_smallest_col_core`); same math as
    :func:`ndlt_h` at N=4, unweighted.  Returns 9 entries row-major, up to
    scale.

    ``sweeps=6`` is measured converged for minimal (N=4) pixel-scale sets:
    p99.9 reprojection 1.8e-3 px and max identical to 8 sweeps over 20K
    random problems (cyclic Jacobi is quadratically convergent); 5 sweeps
    degrades p99.9 to 0.32 px.  The N-point weighted path (:func:`ndlt_h`)
    keeps 8 — its spectra vary with the weight set.
    """
    # DF (double-word) components run the identical chain in df64 — the
    # dispatch below covers the three non-arithmetic ops (abs, identity
    # constants, the eigensolver); everything else is +,-,*,/ which the DF
    # operators provide (ops/df64.ndlt_df64_h is the public entry).
    from sks_tpu.ops.df64 import DF as _DF

    is_df = isinstance(x0, _DF)
    if is_df:
        from sks_tpu.ops.df64 import df_where, jacobi_smallest_col_df

        base = x0.hi

        def _abs(v):
            return df_where(v.hi >= 0, v, -v)
    else:
        base = x0
        _abs = jnp.abs
    quarter = 0.25
    # Hartley scales divide by the mean |dev|, which is >= a pixel for any
    # non-coincident quad; the f32-tiny floor only guards all-equal points.
    tiny = float(jnp.finfo(jnp.float32).tiny)

    def hartley(xs, ys):
        cx = (xs[0] + xs[1] + xs[2] + xs[3]) * quarter
        cy = (ys[0] + ys[1] + ys[2] + ys[3]) * quarter
        dx = [x - cx for x in xs]
        dy = [y - cy for y in ys]
        devx = (_abs(dx[0]) + _abs(dx[1]) + _abs(dx[2]) + _abs(dx[3])) * quarter
        devy = (_abs(dy[0]) + _abs(dy[1]) + _abs(dy[2]) + _abs(dy[3])) * quarter
        if is_df:
            devx = df_where(devx.hi > tiny, devx, devx + tiny)
            devy = df_where(devy.hi > tiny, devy, devy + tiny)
        else:
            devx = jnp.maximum(devx, tiny)
            devy = jnp.maximum(devy, tiny)
        sx = 1.0 / devx
        sy = 1.0 / devy
        return ([d * sx for d in dx], [d * sy for d in dy],
                cx, cy, sx, sy)

    nx, ny, cx1, cy1, sx1, sy1 = hartley((x0, x1, x2, x3), (y0, y1, y2, y3))
    tx, ty, cx2, cy2, sx2, sy2 = hartley((X0, X1, X2, X3), (Y0, Y1, Y2, Y3))

    def wsum_ppt(w):
        """Weighted sums of the 6 unique p p^T entries over the 4 points."""
        return (
            sum(w[i] * nx[i] * nx[i] for i in range(4)),  # xx
            sum(w[i] * nx[i] * ny[i] for i in range(4)),  # xy
            sum(w[i] * nx[i] for i in range(4)),          # x
            sum(w[i] * ny[i] * ny[i] for i in range(4)),  # yy
            sum(w[i] * ny[i] for i in range(4)),          # y
            sum(w[i] for i in range(4)),                  # 1
        )

    if is_df:
        ones = [_DF(jnp.ones_like(base), jnp.zeros_like(base))] * 4
        z = _DF(jnp.zeros_like(base), jnp.zeros_like(base))
    else:
        ones = [jnp.ones_like(base)] * 4
        z = jnp.zeros_like(base)
    s1 = wsum_ppt(ones)
    sx_ = wsum_ppt([-t for t in tx])
    sy_ = wsum_ppt([-t for t in ty])
    sd = wsum_ppt([tx[i] * tx[i] + ty[i] * ty[i] for i in range(4)])

    def block(e):
        xx, xy, x, yy, y, o = e
        return [[xx, xy, x], [xy, yy, y], [x, y, o]]

    zb = [[z] * 3 for _ in range(3)]
    b1, bx, by, bd = block(s1), block(sx_), block(sy_), block(sd)
    ltl = [
        [*b1[r], *zb[r], *bx[r]] for r in range(3)
    ] + [
        [*zb[r], *b1[r], *by[r]] for r in range(3)
    ] + [
        [*bx[r], *by[r], *bd[r]] for r in range(3)
    ]

    if is_df:
        if df_eig == "invit":
            # Shifted inverse iteration (df64 LDL^T + 2 solves) seeded by a
            # few f32 Jacobi sweeps on the hi words: same direction accuracy
            # as the converged df64 Jacobi at ~1/40 the df64 ops (measured
            # equal on random + wall-scale quads; see tests/test_df64.py).
            from sks_tpu.ops.df64 import df_lift, invit_smallest_col_df

            ltl_hi = [[e.hi for e in row] for row in ltl]
            seed = [df_lift(s)
                    for s in jacobi_smallest_col_core(ltl_hi, sweeps=3)]
            h = invit_smallest_col_df(ltl, seed)
        elif jacobi_unroll:
            # Static-pair unrolled rotations (no scan index schedule, no
            # dynamic gathers).
            from sks_tpu.ops.df64 import jacobi_smallest_col_df_unrolled

            h = jacobi_smallest_col_df_unrolled(ltl, sweeps=sweeps)
        else:
            h = jacobi_smallest_col_df(ltl, sweeps=sweeps)
    elif eig == "invit":
        # f32 LDL^T shifted inverse iteration (2 seed sweeps + 1
        # factorization + 2 solves): ~half the 6-sweep Jacobi's flops at
        # equal measured accuracy (see linalg.invit_smallest_col_core).
        from sks_tpu.ops.linalg import invit_smallest_col_core

        h = invit_smallest_col_core(ltl)
    else:
        h = jacobi_smallest_col_core(ltl, sweeps=sweeps)

    # Denormalize: H = T2^{-1} Hn T1 (anisotropic Hartley T's).
    rows_t1 = []
    for r in range(3):
        h0, h1, h2 = h[3 * r], h[3 * r + 1], h[3 * r + 2]
        rows_t1.append(
            (h0 * sx1, h1 * sy1, h2 - h0 * sx1 * cx1 - h1 * sy1 * cy1)
        )
    inv_sx2 = 1.0 / sx2
    inv_sy2 = 1.0 / sy2
    out0 = tuple(rows_t1[0][c] * inv_sx2 + cx2 * rows_t1[2][c]
                 for c in range(3))
    out1 = tuple(rows_t1[1][c] * inv_sy2 + cy2 * rows_t1[2][c]
                 for c in range(3))
    return (*out0, *out1, *rows_t1[2])


def _hartley(pts: Array, w: Array):
    """Anisotropic Hartley normalization (per-axis mean absolute deviation).

    Returns (normalized points, (cx, cy, sx, sy)) with x' = sx (x - cx) etc.
    """
    wsum = jnp.sum(w, axis=-1, keepdims=True)
    c = jnp.sum(pts * w[..., None], axis=-2, keepdims=True) / wsum[..., None]
    d = pts - c
    dev = jnp.sum(jnp.abs(d) * w[..., None], axis=-2) / wsum
    s = 1.0 / jnp.maximum(dev, jnp.finfo(pts.dtype).tiny)
    return d * s[..., None, :], (c[..., 0, 0], c[..., 0, 1], s[..., 0], s[..., 1])


def ndlt_h(
    src: Array,
    tar: Array,
    weights: Array | None = None,
    eig_method: str = "jacobi",
) -> Array:
    """Up-to-scale NDLT homography.

    Args:
      src, tar: (..., N, 2) correspondences, N >= 4 (static).
      weights: optional (..., N) nonnegative weights; zero drops a point, so a
        fixed-shape padded batch supports variable point counts under jit.
      eig_method: 'jacobi' (default, branch-free) or 'eigh' (XLA eigensolver).

    Returns:
      (..., 3, 3) homography, unnormalized.
    """
    if weights is None:
        weights = jnp.ones(src.shape[:-1], src.dtype)
    sn, (cx1, cy1, sx1, sy1) = _hartley(src, weights)
    tn, (cx2, cy2, sx2, sy2) = _hartley(tar, weights)

    x, y = sn[..., 0], sn[..., 1]
    xp, yp = tn[..., 0], tn[..., 1]
    one = jnp.ones_like(x)
    zero = jnp.zeros_like(x)
    # Two constraint rows per point: the classic DLT stacking.
    rows_x = jnp.stack(
        [x, y, one, zero, zero, zero, -xp * x, -xp * y, -xp], axis=-1
    )
    rows_y = jnp.stack(
        [zero, zero, zero, x, y, one, -yp * x, -yp * y, -yp], axis=-1
    )
    a = jnp.concatenate([rows_x, rows_y], axis=-2)  # (..., 2N, 9)
    w2 = jnp.concatenate([weights, weights], axis=-1)
    ltl = jnp.einsum("...np,...n,...nq->...pq", a, w2, a,
                     precision="highest")

    if eig_method == "jacobi":
        _, v = jacobi_eigh(ltl)
        h = v[..., :, 0]
    else:
        h = smallest_eigvec_sym(ltl, method=eig_method)
    hm = h.reshape(*h.shape[:-1], 3, 3)

    # Denormalize: H = T2^{-1} @ Hn @ T1 with T = [[sx,0,-sx cx],[0,sy,-sy cy],[0,0,1]].
    t1 = _t_matrix(cx1, cy1, sx1, sy1)
    t2inv = _t_inv_matrix(cx2, cy2, sx2, sy2)
    return _mm(_mm(t2inv, hm), t1)


def _t_matrix(cx, cy, sx, sy):
    z = jnp.zeros_like(cx)
    o = jnp.ones_like(cx)
    return jnp.stack(
        [
            jnp.stack([sx, z, -sx * cx], axis=-1),
            jnp.stack([z, sy, -sy * cy], axis=-1),
            jnp.stack([z, z, o], axis=-1),
        ],
        axis=-2,
    )


def _t_inv_matrix(cx, cy, sx, sy):
    z = jnp.zeros_like(cx)
    o = jnp.ones_like(cx)
    return jnp.stack(
        [
            jnp.stack([1.0 / sx, z, cx], axis=-1),
            jnp.stack([z, 1.0 / sy, cy], axis=-1),
            jnp.stack([z, z, o], axis=-1),
        ],
        axis=-2,
    )


def ndlt(
    src: Array,
    tar: Array,
    weights: Array | None = None,
    eig_method: str = "jacobi",
) -> Array:
    """NDLT homography normalized to ``H[2,2] == 1``."""
    h = ndlt_h(src, tar, weights, eig_method)
    return h / h[..., 2:3, 2:3]
