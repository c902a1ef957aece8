"""Batched small-matrix linear algebra for the solver baselines.

Batched, branch-free replacements for the reference's per-thread numerics: the CUDA device
Golub-Reinsch SVD (``GPU_Runtime Test.cu:527-785``) is branch-heavy,
data-dependent (implicit-shift QR with convergence tests) and hostile to a SIMD
machine; here the same capability is provided by

  * a *fixed-iteration* cyclic Jacobi eigensolver for small symmetric matrices
    (branch-free, unrolled, vectorizes over the batch), and
  * a closed-form smallest-eigenvector for the 3x3 symmetric case,
  * an unrolled no-pivot Gauss-Jordan solve for small dense systems
    (the batched analogue of the CUDA 8x8 LU at ``GPU_Runtime Test.cu:242-357``).

All functions broadcast over leading batch dimensions and preserve dtype.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array

__all__ = [
    "mm_highest",
    "jacobi_eigh",
    "jacobi_smallest_col_core",
    "smallest_eigvec3_core",
    "smallest_eigvec_sym",
    "solve_unrolled",
]


def mm_highest(a: Array, b: Array) -> Array:
    """f32-accurate matmul: a reduced default matmul precision (TF32 on a
    GPU, bf16 passes elsewhere) costs pixels of reprojection error through
    the normalization/denormalization chains of the N>=4 solvers.  Every small
    geometry contraction in this package goes through this (or an einsum with
    ``precision='highest'``)."""
    return jnp.matmul(a, b, precision="highest")


def jacobi_eigh(a: Array, sweeps: int = 8):
    """Eigendecomposition of small symmetric matrices by cyclic Jacobi.

    Branch-free fixed-sweep Jacobi: every (p, q) pair is rotated each sweep with
    an angle that is exactly zero when the off-diagonal entry is zero, so no
    convergence test is needed.  For 9x9 inputs, 8 sweeps reach fp32 roundoff.

    Args:
      a: (..., n, n) symmetric.
      sweeps: number of full cyclic sweeps (static).

    Returns:
      (eigenvalues (..., n) ascending, eigenvectors (..., n, n) columns).
    """
    n = a.shape[-1]
    v = jnp.broadcast_to(jnp.eye(n, dtype=a.dtype), a.shape)
    # Smallest normal; added (un-squared: tiny**2 underflows to 0) under the
    # hypot sqrt so an already-diagonal pair gives t = 0/sqrt(tiny), not 0/0.
    tiny = jnp.asarray(jnp.finfo(a.dtype).tiny, a.dtype)

    def rotate(carry, pq):
        a_, v_ = carry
        p, q = pq
        app = a_[..., p, p]
        aqq = a_[..., q, q]
        apq = a_[..., p, q]
        # Stable Jacobi rotation, written overflow-free so it is differentiable
        # everywhere: the textbook t = sign(theta)/(|theta|+sqrt(theta^2+1))
        # with theta = tau/apq divides by apq (overflows when apq ~ 0, and the
        # overflow NaNs the backward pass even under a where-guard).  Multiply
        # numerator and denominator by |apq| instead:
        #   t = sign(tau) * apq / (|tau| + sqrt(tau^2 + apq^2)),
        # which is |t| <= 1, exactly 0 at apq = 0 (identity rotation), and has
        # finite gradients once the hypot is floored away from 0.
        tau = (aqq - app) * 0.5
        sgn = jnp.where(tau >= 0, 1.0, -1.0).astype(a_.dtype)
        hyp = jnp.sqrt(tau * tau + apq * apq + tiny)
        t = sgn * apq / (sgn * tau + hyp)
        c = 1.0 / jnp.sqrt(t * t + 1)
        s = t * c
        c_, s_ = c[..., None], s[..., None]

        rp = a_[..., p, :]
        rq = a_[..., q, :]
        a_ = a_.at[..., p, :].set(c_ * rp - s_ * rq)
        a_ = a_.at[..., q, :].set(s_ * rp + c_ * rq)
        cp = a_[..., :, p]
        cq = a_[..., :, q]
        a_ = a_.at[..., :, p].set(c_ * cp - s_ * cq)
        a_ = a_.at[..., :, q].set(s_ * cp + c_ * cq)
        vp = v_[..., :, p]
        vq = v_[..., :, q]
        v_ = v_.at[..., :, p].set(c_ * vp - s_ * vq)
        v_ = v_.at[..., :, q].set(s_ * vp + c_ * vq)
        return (a_, v_), None

    pairs = [(p, q) for p in range(n) for q in range(p + 1, n)]

    def sweep(_, carry):
        for pq in pairs:
            carry, _ = rotate(carry, pq)
        return carry

    a, v = jax.lax.fori_loop(0, sweeps, sweep, (a, v))

    w = jnp.diagonal(a, axis1=-2, axis2=-1)
    order = jnp.argsort(w, axis=-1)
    w = jnp.take_along_axis(w, order, axis=-1)
    v = jnp.take_along_axis(v, order[..., None, :], axis=-1)
    return w, v


def _smallest_eigvec_3x3(a: Array) -> Array:
    """Closed-form unit eigenvector of the smallest eigenvalue of symmetric 3x3.

    Analytic eigenvalues via the trigonometric (Cardano) method, eigenvector via
    the largest cross product of rows of ``A - lambda I`` (branch-free).
    """
    dtype = a.dtype
    q = jnp.trace(a, axis1=-2, axis2=-1) / 3.0
    b = a - q[..., None, None] * jnp.eye(3, dtype=dtype)
    p2 = jnp.sum(b * b, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, jnp.finfo(dtype).tiny))
    bn = b / p[..., None, None]
    # Explicit 3x3 determinant (jnp.linalg.det lowers through dot_general,
    # which runs in reduced precision under a TF32/bf16 matmul default).
    detb = (
        bn[..., 0, 0] * (bn[..., 1, 1] * bn[..., 2, 2]
                         - bn[..., 1, 2] * bn[..., 2, 1])
        - bn[..., 0, 1] * (bn[..., 1, 0] * bn[..., 2, 2]
                           - bn[..., 1, 2] * bn[..., 2, 0])
        + bn[..., 0, 2] * (bn[..., 1, 0] * bn[..., 2, 1]
                           - bn[..., 1, 1] * bn[..., 2, 0])
    )
    # Clip strictly inside (-1, 1): arccos' gradient is infinite at the ends,
    # which would NaN the backward pass for exactly-degenerate eigenvalues.
    lim = 1.0 - 8 * jnp.finfo(dtype).eps
    r = jnp.clip(detb / 2.0, -lim, lim)
    phi = jnp.arccos(r) / 3.0
    # Smallest eigenvalue of the three.
    lam = q + 2 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)

    m = a - lam[..., None, None] * jnp.eye(3, dtype=dtype)
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    cands = jnp.stack([c01, c02, c12], axis=-2)
    norms = jnp.sum(cands * cands, axis=-1)
    best = jnp.argmax(norms, axis=-1)
    vec = jnp.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    nrm = jnp.sqrt(jnp.maximum(jnp.sum(vec * vec, axis=-1, keepdims=True),
                               jnp.finfo(dtype).tiny))
    vec = vec / nrm

    # One Rayleigh-shifted inverse-iteration step.  The trigonometric
    # eigenvalue is only O(sqrt(eps))-accurate in the worst case, and the
    # cross-product eigenvector inherits that error — observable as ~1e-8
    # relative error at f64, which downstream denormalization (HO/NDLT)
    # amplifies by ~1e5.  (A - rho I)^{-1} v ∝ adj(A - rho I) v needs no
    # division and one step restores O(eps/gap) accuracy.
    rho = jnp.einsum("...i,...ij,...j->...", vec, a, vec,
                     precision="highest")
    b = a - rho[..., None, None] * jnp.eye(3, dtype=dtype)
    b00, b01, b02 = b[..., 0, 0], b[..., 0, 1], b[..., 0, 2]
    b11, b12, b22 = b[..., 1, 1], b[..., 1, 2], b[..., 2, 2]
    adj = jnp.stack([
        jnp.stack([b11 * b22 - b12 * b12, b02 * b12 - b01 * b22,
                   b01 * b12 - b02 * b11], axis=-1),
        jnp.stack([b02 * b12 - b01 * b22, b00 * b22 - b02 * b02,
                   b01 * b02 - b00 * b12], axis=-1),
        jnp.stack([b01 * b12 - b02 * b11, b01 * b02 - b00 * b12,
                   b00 * b11 - b01 * b01], axis=-1),
    ], axis=-2)
    w = jnp.einsum("...ij,...j->...i", adj, vec, precision="highest")
    wn2 = jnp.sum(w * w, axis=-1, keepdims=True)
    ok = wn2 > jnp.finfo(dtype).tiny
    w = w / jnp.sqrt(jnp.where(ok, wn2, 1.0))
    return jnp.where(ok, w, vec)


def smallest_eigvec_sym(a: Array, method: str = "auto") -> Array:
    """Unit eigenvector for the smallest eigenvalue of a symmetric (..., n, n).

    ``method``: 'auto' (closed form for n==3, Jacobi otherwise), 'jacobi',
    'eigh' (XLA's batched eigensolver), or 'closed3'.
    """
    n = a.shape[-1]
    if method == "auto":
        method = "closed3" if n == 3 else "jacobi"
    if method == "closed3":
        assert n == 3
        return _smallest_eigvec_3x3(a)
    if method == "jacobi":
        _, v = jacobi_eigh(a)
        return v[..., :, 0]
    if method == "eigh":
        _, v = jnp.linalg.eigh(a)
        return v[..., :, 0]
    raise ValueError(f"unknown method {method!r}")


def jacobi_smallest_col_core(a, sweeps: int = 8):
    """Smallest eigenvector of a symmetric matrix given as component lists.

    The lane-parallel twin of :func:`jacobi_eigh` for SoA layouts
    (component-major jnp arrays): ``a`` is an n x n Python
    list-of-lists of broadcastable array components, every rotation is
    unrolled over the static (p, q) pairs, and the sweep loop is a
    ``fori_loop`` whose carry is the flattened component tuple.  Each lane of
    each component runs its own independent Jacobi — there is no cross-lane
    traffic, which is what makes the 9x9 NDLT eigenproblem batchable at
    RANSAC scale (the reference's per-thread Golub-Reinsch SVD,
    ``GPU_Runtime Test.cu:527-785``, is the CUDA answer to the same problem).

    Returns the eigenvector column (tuple of n components) for the smallest
    eigenvalue, branch-free min-diagonal selection.
    """
    n = len(a)
    dtype = a[0][0].dtype
    one = jnp.ones_like(a[0][0])
    zero = jnp.zeros_like(a[0][0])
    v = [[one if i == j else zero for j in range(n)] for i in range(n)]
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)

    def flat(m):
        return tuple(m[i][j] for i in range(n) for j in range(n))

    def unflat(t):
        return [[t[i * n + j] for j in range(n)] for i in range(n)]

    def sweep(_, carry):
        a_ = unflat(carry[0])
        v_ = unflat(carry[1])
        for p in range(n):
            for q in range(p + 1, n):
                app, aqq, apq = a_[p][p], a_[q][q], a_[p][q]
                # Overflow-free rotation; see the jacobi_eigh derivation.
                tau = (aqq - app) * 0.5
                sgn = jnp.where(tau >= 0, 1.0, -1.0).astype(dtype)
                hyp = jnp.sqrt(tau * tau + apq * apq + tiny)
                t = sgn * apq / (sgn * tau + hyp)
                c = 1.0 / jnp.sqrt(t * t + 1.0)
                s = t * c
                for j in range(n):
                    rp, rq = a_[p][j], a_[q][j]
                    a_[p][j] = c * rp - s * rq
                    a_[q][j] = s * rp + c * rq
                for i in range(n):
                    cp, cq = a_[i][p], a_[i][q]
                    a_[i][p] = c * cp - s * cq
                    a_[i][q] = s * cp + c * cq
                    vp, vq = v_[i][p], v_[i][q]
                    v_[i][p] = c * vp - s * vq
                    v_[i][q] = s * vp + c * vq
        return (flat(a_), flat(v_))

    a_f, v_f = jax.lax.fori_loop(0, sweeps, sweep, (flat(a), flat(v)))
    a_ = unflat(a_f)
    v_ = unflat(v_f)

    best_w = a_[0][0]
    best = [v_[i][0] for i in range(n)]
    for j in range(1, n):
        take = a_[j][j] < best_w
        best_w = jnp.where(take, a_[j][j], best_w)
        best = [jnp.where(take, v_[i][j], best[i]) for i in range(n)]
    return tuple(best)


def invit_smallest_col_core(a, seed=None, shift_rel: float = 2.0 ** -22,
                            solves: int = 3, seed_sweeps: int = 3):
    """Smallest eigenvector of a symmetric PSD component matrix by shifted
    inverse iteration: unrolled LDL^T of ``A + eps I`` + chained solves.

    The f32 twin of :func:`sks_tpu.ops.df64.invit_smallest_col_df` (same
    derivation and accuracy argument — see that docstring), cutting the
    NDLT eigensolve from 6 Jacobi sweeps (~216 rotations, ~26K flops) to
    ``seed_sweeps`` sweeps + one ~300-multiply factorization + cheap
    solves (~45% the flops).  The eps-shift sits at ``shift_rel * trace``:
    above f32's rounding floor of the computed lambda_min (~2^-24 ||A||),
    far below lambda_2, so each solve amplifies the null direction by
    ~lambda_2/eps and three solves from a 3-sweep seed land at the
    u*||A||/lambda_2 direction-error bound.  Measured over 20K
    homography-consistent pixel-scale minimal sets vs the 6-sweep Jacobi:
    median 4.6e-5 vs 8.4e-5 px, p99 1.5e-4 vs 2.8e-4, p99.9 1.3e-3 vs
    1.6e-3 (all BETTER); the one regression is the extreme tail (max
    0.77 px vs 0.013 on the single worst-conditioned quad of 20K) — noise
    for RANSAC hypothesis generation, which is what the minimal path
    serves.  f32's headroom is thinner than df64's (only ~2^2 between the
    shift and u*cond for bad quads), hence 3 solves/3 sweeps vs df64's
    2/3.  Fully unrolled.

    Args:
      a: n x n list-of-lists of broadcastable array components (PSD).
      seed: length-n component list (non-orthogonal to the answer); None
        runs ``seed_sweeps`` Jacobi sweeps on ``a`` to build one.
      shift_rel: diagonal shift relative to trace(a).
      solves: inverse-iteration steps sharing the one factorization.

    Returns the eigenvector as a tuple of n components, up to scale.
    """
    n = len(a)
    if seed is None:
        seed = jacobi_smallest_col_core(a, sweeps=seed_sweeps)
    tr = a[0][0]
    for i in range(1, n):
        tr = tr + a[i][i]
    eps = tr * shift_rel
    lmat = [[None] * n for _ in range(n)]
    wmat = [[None] * n for _ in range(n)]
    d = [None] * n
    for j in range(n):
        s = a[j][j] + eps
        for k in range(j):
            s = s - lmat[j][k] * wmat[j][k]
        d[j] = s
        for i in range(j + 1, n):
            t = a[i][j]
            for k in range(j):
                t = t - lmat[i][k] * wmat[j][k]
            wmat[i][j] = t
            lmat[i][j] = t / s
    x = list(seed)
    scale = float(shift_rel)  # exact power of two: lossless range rescale
    for _ in range(solves):
        y = []
        for i in range(n):
            yi = x[i]
            for k in range(i):
                yi = yi - lmat[i][k] * y[k]
            y.append(yi)
        z = [y[i] / d[i] for i in range(n)]
        xn = [None] * n
        for i in reversed(range(n)):
            xi = z[i]
            for k in range(i + 1, n):
                xi = xi - lmat[k][i] * xn[k]
            xn[i] = xi
        x = [v * scale for v in xn]
    return tuple(x)


def smallest_eigvec3_core(a00, a01, a02, a11, a12, a22):
    """Closed-form smallest eigenvector of symmetric 3x3 on components.

    The component-form twin of ``_smallest_eigvec_3x3`` (same math:
    trigonometric eigenvalue, largest row-cross eigenvector, one
    Rayleigh-shifted adjugate inverse-iteration step), for SoA layouts.
    Returns (v0, v1, v2), unit norm.
    """
    dtype = a00.dtype
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
    third = jnp.asarray(1.0 / 3.0, dtype)

    q = (a00 + a11 + a22) * third
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, tiny))
    inv_p = 1.0 / p
    # det(B / p) with B = A - q I.
    detb = (
        (b00 * inv_p) * ((b11 * inv_p) * (b22 * inv_p)
                         - (a12 * inv_p) * (a12 * inv_p))
        - (a01 * inv_p) * ((a01 * inv_p) * (b22 * inv_p)
                           - (a12 * inv_p) * (a02 * inv_p))
        + (a02 * inv_p) * ((a01 * inv_p) * (a12 * inv_p)
                           - (b11 * inv_p) * (a02 * inv_p))
    )
    lim = jnp.asarray(1.0 - 8 * jnp.finfo(dtype).eps, dtype)
    r = jnp.clip(detb * 0.5, -lim, lim)
    phi = jnp.arccos(r) * third
    lam = q + 2.0 * p * jnp.cos(phi + jnp.asarray(2.0 * jnp.pi / 3.0, dtype))

    m00, m11, m22 = a00 - lam, a11 - lam, a22 - lam
    # Rows of A - lam I; candidate eigenvectors are their pairwise crosses.
    r0 = (m00, a01, a02)
    r1 = (a01, m11, a12)
    r2 = (a02, a12, m22)

    def cross(u, w):
        return (u[1] * w[2] - u[2] * w[1],
                u[2] * w[0] - u[0] * w[2],
                u[0] * w[1] - u[1] * w[0])

    def norm2(u):
        return u[0] * u[0] + u[1] * u[1] + u[2] * u[2]

    best = cross(r0, r1)
    best_n = norm2(best)
    for cand in (cross(r0, r2), cross(r1, r2)):
        cn = norm2(cand)
        take = cn > best_n
        best = tuple(jnp.where(take, cand[i], best[i]) for i in range(3))
        best_n = jnp.where(take, cn, best_n)
    inv_n = 1.0 / jnp.sqrt(jnp.maximum(best_n, tiny))
    v0, v1, v2 = best[0] * inv_n, best[1] * inv_n, best[2] * inv_n

    # One Rayleigh-shifted adjugate inverse-iteration step (restores
    # O(eps/gap) accuracy lost to the trigonometric eigenvalue's sqrt(eps)
    # worst case; see _smallest_eigvec_3x3).
    rho = (v0 * (a00 * v0 + a01 * v1 + a02 * v2)
           + v1 * (a01 * v0 + a11 * v1 + a12 * v2)
           + v2 * (a02 * v0 + a12 * v1 + a22 * v2))
    c00, c11, c22 = a00 - rho, a11 - rho, a22 - rho
    adj00 = c11 * c22 - a12 * a12
    adj01 = a02 * a12 - a01 * c22
    adj02 = a01 * a12 - a02 * c11
    adj11 = c00 * c22 - a02 * a02
    adj12 = a01 * a02 - c00 * a12
    adj22 = c00 * c11 - a01 * a01
    w0 = adj00 * v0 + adj01 * v1 + adj02 * v2
    w1 = adj01 * v0 + adj11 * v1 + adj12 * v2
    w2 = adj02 * v0 + adj12 * v1 + adj22 * v2
    wn2 = w0 * w0 + w1 * w1 + w2 * w2
    ok = wn2 > tiny
    inv_w = 1.0 / jnp.sqrt(jnp.where(ok, wn2, 1.0))
    return (jnp.where(ok, w0 * inv_w, v0),
            jnp.where(ok, w1 * inv_w, v1),
            jnp.where(ok, w2 * inv_w, v2))


def solve_unrolled(a: Array, b: Array, pivot: bool = False) -> Array:
    """Solve small dense systems by statically unrolled Gauss-Jordan.

    The batched analogue of the reference's per-thread 8x8 LU
    (``GPU_Runtime Test.cu:242-357``): the elimination order is static, fully
    unrolled at trace time, and vectorizes over the batch; with
    ``pivot=True`` each step does a branch-free argmax row swap
    (one-hot matmul) for partial pivoting.

    Args:
      a: (..., n, n); b: (..., n) or (..., n, k).

    Returns:
      x with b's shape.
    """
    squeeze = b.ndim == a.ndim - 1
    if squeeze:
        b = b[..., None]
    n = a.shape[-1]
    t = jnp.concatenate([a, b], axis=-1)

    for k in range(n):
        if pivot:
            col = jnp.abs(t[..., k:, k])
            rel = jnp.argmax(col, axis=-1)
            sel = jax.nn.one_hot(rel + k, n, dtype=t.dtype)
            pivrow = jnp.einsum("...r,...rc->...c", sel, t,
                                precision="highest")
            # Replace the selected row with row k (swap), branch-free.
            rowk = t[..., k, :]
            t = t + sel[..., :, None] * (rowk[..., None, :] - pivrow[..., None, :])
            t = t.at[..., k, :].set(pivrow)
        piv = t[..., k, k]
        inv = 1.0 / piv
        rowk = t[..., k, :] * inv[..., None]
        t = t.at[..., k, :].set(rowk)
        factors = t[..., :, k]
        update = factors[..., :, None] * rowk[..., None, :]
        mask = jnp.arange(n) != k
        t = jnp.where(mask[:, None], t - update, t)

    x = t[..., n:]
    return x[..., 0] if squeeze else x
