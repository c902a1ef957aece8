"""HO — Harker-O'Leary homography estimation (batched, N >= 4).

Capability parity with ``cv::runKernel_HO`` / ``my_normalizeDataIsotropic``
(``C++ Codes/modules/HO.cpp:33-270``) and the CUDA twin
(``GPU_Runtime Test.cu:788-1031``).  The method: after isotropic normalization,
the first six homography entries can be eliminated in closed form (a linear
least-squares in two independent 3-unknown blocks), leaving a 2N x 3 system in
``(h7, h8, h9)`` whose 3x3 normal matrix is solved by a smallest-eigenvector —
here in *closed form* (trigonometric 3x3 eigensolver) instead of the
reference's iterative device SVD.

Derivation used here (equivalent, branch-free batched form): with normalized points
``(x,y) -> (X,Y)``, design matrix ``C = [x y 1]`` (N x 3) and ``g = (h7,h8,h9)``,
the DLT constraints read ``C u = diag(X) C g`` and ``C v = diag(Y) C g`` for
``u = (h1,h2,h3)``, ``v = (h4,h5,h6)``.  Least-squares elimination of u, v gives
the residual system ``D g = 0`` with

    D = [(P - I) diag(X) C ; (P - I) diag(Y) C],   P = C (C^T C)^{-1} C^T,

so ``g`` is the smallest eigenvector of ``D^T D`` and then
``u = (C^T C)^{-1} C^T diag(X) C g`` (same for v).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array

from sks_tpu.ops.linalg import (
    mm_highest as _mm,
    smallest_eigvec3_core,
    smallest_eigvec_sym,
)

__all__ = ["ho", "ho_core", "ho_h"]


def ho_core(
    x0, y0, x1, y1, x2, y2, x3, y3,
    X0, Y0, X1, Y1, X2, Y2, X3, Y3,
    eig_method: str = "closed3",
):
    """Straight-line minimal-set (N=4) Harker-O'Leary on components.

    Single source for SoA layouts (component-major arrays):
    isotropic normalization, closed-form elimination of (h1..h6), smallest
    3x3 eigenvector for (h7,h8,h9), back-substitution, denormalization — the
    same math as :func:`ho_h` specialized to 4 unweighted points, fully
    unrolled, no matrix ops.  Returns the 9 homography entries row-major, up
    to scale.

    ``eig_method``: 'closed3' (trigonometric closed form, default) or
    'jacobi' (fixed-sweep component Jacobi — no arccos/cos).  DF (double-word)
    components run the identical chain in df64 with the eigenproblem
    solved by LDL^T inverse iteration (:func:`sks_tpu.ops.df64.
    invit_smallest_col_df`; the public entry is ``ops/df64.ho_df64_h``).
    """
    from sks_tpu.ops.df64 import DF as _DF

    is_df = isinstance(x0, _DF)
    if is_df:
        from sks_tpu.ops.df64 import df_sqrt, df_where

        base = x0.hi
        dtype = base.dtype
        tiny = float(jnp.finfo(dtype).tiny)
        # df64-accurate sqrt(2) (the f32 constant would cap the chain at
        # f32 relative accuracy before the solve even starts).
        sqrt2 = df_sqrt(_DF(jnp.full_like(base, 2.0), jnp.zeros_like(base)))
        _sqrt = df_sqrt

        def _floor_tiny(v):
            return df_where(v.hi > tiny, v, v + tiny)
    else:
        dtype = x0.dtype
        sqrt2 = jnp.asarray(jnp.sqrt(2.0), dtype)
        tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
        _sqrt = jnp.sqrt

        def _floor_tiny(v):
            return jnp.maximum(v, tiny)
    quarter = 0.25

    def iso(xs, ys):
        cx = (xs[0] + xs[1] + xs[2] + xs[3]) * quarter
        cy = (ys[0] + ys[1] + ys[2] + ys[3]) * quarter
        dx = [x - cx for x in xs]
        dy = [y - cy for y in ys]
        mean = (
            sum(_sqrt(dx[i] * dx[i] + dy[i] * dy[i]) for i in range(4))
            * quarter
        )
        s = sqrt2 / _floor_tiny(mean)
        return [d * s for d in dx], [d * s for d in dy], cx, cy, s

    sx, sy, cx1, cy1, s1 = iso((x0, x1, x2, x3), (y0, y1, y2, y3))
    tx, ty, cx2, cy2, s2 = iso((X0, X1, X2, X3), (Y0, Y1, Y2, Y3))

    # G = C^T C with C = [x y 1] (4x3); symmetric, 6 components.
    g00 = sum(sx[i] * sx[i] for i in range(4))
    g01 = sum(sx[i] * sy[i] for i in range(4))
    g02 = sum(sx[i] for i in range(4))
    g11 = sum(sy[i] * sy[i] for i in range(4))
    g12 = sum(sy[i] for i in range(4))
    if is_df:
        g22 = _DF(jnp.full_like(base, 4.0), jnp.zeros_like(base))
    else:
        g22 = jnp.asarray(4.0, dtype) + jnp.zeros_like(g02)

    # G^{-1} via adjugate.
    ca = g11 * g22 - g12 * g12
    cb = g02 * g12 - g01 * g22
    cc = g01 * g12 - g02 * g11
    cd = g00 * g22 - g02 * g02
    ce = g01 * g02 - g00 * g12
    cf = g00 * g11 - g01 * g01
    det = g00 * ca + g01 * cb + g02 * cc
    dinv = 1.0 / det
    gi = (
        (ca * dinv, cb * dinv, cc * dinv),
        (cb * dinv, cd * dinv, ce * dinv),
        (cc * dinv, ce * dinv, cf * dinv),
    )

    def reduced(vals):
        """Residual rows R = (P - I) diag(vals) C and M = C^T diag(vals) C."""
        # M = C^T diag(vals) C, symmetric.
        m = [[None] * 3 for _ in range(3)]
        m[0][0] = sum(vals[i] * sx[i] * sx[i] for i in range(4))
        m[0][1] = m[1][0] = sum(vals[i] * sx[i] * sy[i] for i in range(4))
        m[0][2] = m[2][0] = sum(vals[i] * sx[i] for i in range(4))
        m[1][1] = sum(vals[i] * sy[i] * sy[i] for i in range(4))
        m[1][2] = m[2][1] = sum(vals[i] * sy[i] for i in range(4))
        m[2][2] = sum(vals[i] for i in range(4))
        # K = G^{-1} M (3x3).
        k = [
            [sum(gi[r][j] * m[j][c] for j in range(3)) for c in range(3)]
            for r in range(3)
        ]
        # Row i of R: c_i @ K - vals_i * c_i with c_i = (x_i, y_i, 1).
        rows = []
        for i in range(4):
            proj = [sx[i] * k[0][c] + sy[i] * k[1][c] + k[2][c]
                    for c in range(3)]
            rows.append((proj[0] - vals[i] * sx[i],
                         proj[1] - vals[i] * sy[i],
                         proj[2] - vals[i]))
        return rows, m

    rx, mx = reduced(tx)
    ry, my = reduced(ty)

    # D^T D, symmetric 3x3 accumulated over the 8 residual rows.
    d00 = sum(r[0] * r[0] for r in rx) + sum(r[0] * r[0] for r in ry)
    d01 = sum(r[0] * r[1] for r in rx) + sum(r[0] * r[1] for r in ry)
    d02 = sum(r[0] * r[2] for r in rx) + sum(r[0] * r[2] for r in ry)
    d11 = sum(r[1] * r[1] for r in rx) + sum(r[1] * r[1] for r in ry)
    d12 = sum(r[1] * r[2] for r in rx) + sum(r[1] * r[2] for r in ry)
    d22 = sum(r[2] * r[2] for r in rx) + sum(r[2] * r[2] for r in ry)
    if is_df:
        # 3x3 twin of the NDLT eigensolve: f32 Jacobi seed on the hi words,
        # then df64 LDL^T shifted inverse iteration.
        from sks_tpu.ops.df64 import df_lift, invit_smallest_col_df
        from sks_tpu.ops.linalg import jacobi_smallest_col_core

        dmat = [[d00, d01, d02], [d01, d11, d12], [d02, d12, d22]]
        dmat_hi = [[e.hi for e in row] for row in dmat]
        seed = [df_lift(s)
                for s in jacobi_smallest_col_core(dmat_hi, sweeps=4)]
        gvec = invit_smallest_col_df(dmat, seed)
    elif eig_method == "jacobi":
        from sks_tpu.ops.linalg import jacobi_smallest_col_core

        gvec = jacobi_smallest_col_core(
            [[d00, d01, d02], [d01, d11, d12], [d02, d12, d22]], sweeps=10
        )
    else:
        gvec = smallest_eigvec3_core(d00, d01, d02, d11, d12, d22)

    def back(m):
        w = [sum(m[r][j] * gvec[j] for j in range(3)) for r in range(3)]
        return [sum(gi[r][j] * w[j] for j in range(3)) for r in range(3)]

    u = back(mx)
    v = back(my)
    hn = (u[0], u[1], u[2], v[0], v[1], v[2], gvec[0], gvec[1], gvec[2])

    # Denormalize: H = T2^{-1} Hn T1, isotropic T's.
    # Hn @ T1: col0 *= s1, col1 *= s1, col2 = -s1(cx1 c0 + cy1 c1) + c2.
    rows_t1 = []
    for r in range(3):
        h0, h1, h2 = hn[3 * r], hn[3 * r + 1], hn[3 * r + 2]
        rows_t1.append((h0 * s1, h1 * s1, h2 - s1 * (h0 * cx1 + h1 * cy1)))
    inv_s2 = 1.0 / s2
    out0 = tuple(rows_t1[0][c] * inv_s2 + cx2 * rows_t1[2][c] for c in range(3))
    out1 = tuple(rows_t1[1][c] * inv_s2 + cy2 * rows_t1[2][c] for c in range(3))
    out2 = rows_t1[2]
    return (*out0, *out1, *out2)


def _iso_norm(pts: Array, w: Array):
    """Isotropic normalization: zero centroid, mean distance sqrt(2)."""
    wsum = jnp.sum(w, axis=-1, keepdims=True)
    c = jnp.sum(pts * w[..., None], axis=-2, keepdims=True) / wsum[..., None]
    d = pts - c
    dist = jnp.sqrt(jnp.sum(d * d, axis=-1))
    mean = jnp.sum(dist * w, axis=-1, keepdims=True) / wsum
    s = jnp.sqrt(jnp.asarray(2.0, pts.dtype)) / jnp.maximum(
        mean, jnp.finfo(pts.dtype).tiny
    )
    return d * s[..., None], (c[..., 0, 0], c[..., 0, 1], s[..., 0])


def _inv3_sym(g: Array) -> Array:
    """Closed-form inverse of symmetric 3x3 via adjugate."""
    a, b, c = g[..., 0, 0], g[..., 0, 1], g[..., 0, 2]
    d, e = g[..., 1, 1], g[..., 1, 2]
    f = g[..., 2, 2]
    ca = d * f - e * e
    cb = c * e - b * f
    cc = b * e - c * d
    cd = a * f - c * c
    ce = b * c - a * e
    cf = a * d - b * b
    det = a * ca + b * cb + c * cc
    inv = 1.0 / det
    return (
        jnp.stack(
            [
                jnp.stack([ca, cb, cc], axis=-1),
                jnp.stack([cb, cd, ce], axis=-1),
                jnp.stack([cc, ce, cf], axis=-1),
            ],
            axis=-2,
        )
        * inv[..., None, None]
    )


def ho_h(src: Array, tar: Array, weights: Array | None = None) -> Array:
    """Up-to-scale Harker-O'Leary homography.

    Args:
      src, tar: (..., N, 2), N >= 4 (static).
      weights: optional (..., N); zero drops a point.

    Returns:
      (..., 3, 3) homography, unnormalized.
    """
    if weights is None:
        weights = jnp.ones(src.shape[:-1], src.dtype)
    sn, (cx1, cy1, s1) = _iso_norm(src, weights)
    tn, (cx2, cy2, s2) = _iso_norm(tar, weights)

    x, y = sn[..., 0], sn[..., 1]
    xp, yp = tn[..., 0], tn[..., 1]
    one = jnp.ones_like(x)
    c = jnp.stack([x, y, one], axis=-1) * weights[..., None]  # weighted C
    cw = jnp.stack([x, y, one], axis=-1)

    g3 = jnp.einsum("...ni,...nj->...ij", c, cw,
                    precision="highest")  # C^T W C
    ginv = _inv3_sym(g3)

    def reduced(vals):
        # rows R = (P - I) diag(vals) C, weighted; avoid forming P (N x N):
        # R = C Ginv C^T W diag(vals) C - diag(vals) C.
        dc = vals[..., None] * cw  # diag(vals) C, (..., N, 3)
        ctwd = jnp.einsum("...ni,...nj->...ij", c, dc,
                          precision="highest")  # C^T W diag(vals) C
        proj = jnp.einsum("...ni,...ij,...jk->...nk", cw, ginv, ctwd,
                          precision="highest")
        return proj - dc, ctwd

    rx, mx = reduced(xp)
    ry, my = reduced(yp)
    dtd = jnp.einsum("...ni,...n,...nj->...ij", rx, weights, rx,
                     precision="highest") + jnp.einsum(
        "...ni,...n,...nj->...ij", ry, weights, ry, precision="highest"
    )
    g = smallest_eigvec_sym(dtd, method="closed3")

    u = jnp.einsum("...ij,...jk,...k->...i", ginv, mx, g,
                   precision="highest")
    v = jnp.einsum("...ij,...jk,...k->...i", ginv, my, g,
                   precision="highest")
    hm = jnp.stack([u, v, g], axis=-2)

    # Denormalize with the isotropic T's.
    z = jnp.zeros_like(s1)
    o = jnp.ones_like(s1)
    t1 = jnp.stack(
        [
            jnp.stack([s1, z, -s1 * cx1], axis=-1),
            jnp.stack([z, s1, -s1 * cy1], axis=-1),
            jnp.stack([z, z, o], axis=-1),
        ],
        axis=-2,
    )
    t2inv = jnp.stack(
        [
            jnp.stack([1.0 / s2, z, cx2], axis=-1),
            jnp.stack([z, 1.0 / s2, cy2], axis=-1),
            jnp.stack([z, z, o], axis=-1),
        ],
        axis=-2,
    )
    return _mm(_mm(t2inv, hm), t1)


def ho(src: Array, tar: Array, weights: Array | None = None) -> Array:
    """HO homography normalized to ``H[2,2] == 1``."""
    h = ho_h(src, tar, weights)
    return h / h[..., 2:3, 2:3]
