"""Batched Lie-group utilities: SO(3), SE(3), SL(3) exp/log.

Foundation for the pose-graph and bundle-adjustment layers (new capability per
BASELINE.json; the reference has no pose representation).  All maps are
branch-free (Taylor-switched by ``jnp.where``) so they jit/vmap/grad cleanly.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array

__all__ = [
    "hat3",
    "so3_exp",
    "so3_log",
    "se3_exp",
    "se3_log",
    "sl3_exp",
    "sl3_basis",
    "expm3",
    "logm3_near_identity",
]

_EPS = 1e-8


def mm_small(a: Array, b: Array) -> Array:
    """Batched small-matrix product as broadcast multiply-add (elementwise).

    For 3x3/4x4 geometry products a matmul is the wrong tool: each tiny
    product is a separate library call or padded tile, and the package's
    full-f32 accumulation default makes it multi-pass (measured: the
    pose-graph CG loop got 2.6x slower through `@`).  The broadcasting sum
    runs the identical product elementwise in exact f32 — it fuses with its
    neighbours, and is immune to matmul-precision defaults entirely.
    """
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def hat3(w: Array) -> Array:
    """(..., 3) -> (..., 3, 3) skew-symmetric."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    o = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([o, -z, y], axis=-1),
            jnp.stack([z, o, -x], axis=-1),
            jnp.stack([-y, x, o], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(w: Array) -> Array:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation.

    Gradient-safe at w = 0 via the double-where pattern: the untaken generic
    branch is evaluated at theta^2 = 1 (not at a tiny floor), so its value
    AND its cotangent are benign.  A tiny floor like max(th2, 1e-16) is not
    enough — the quotient-rule vjp divides by the floor *squared*, which
    underflows to 0 in f32 and turns the masked branch into NaN.
    """
    th2 = jnp.sum(w * w, axis=-1)
    gen = th2 > _EPS
    th2_f = jnp.where(gen, th2, 1.0)
    th = jnp.sqrt(th2_f)
    a = jnp.where(gen, jnp.sin(th) / th, 1.0 - th2 / 6.0)
    b = jnp.where(gen, (1.0 - jnp.cos(th)) / th2_f, 0.5 - th2 / 24.0)
    k = hat3(w)
    eye = jnp.eye(3, dtype=w.dtype)
    return eye + a[..., None, None] * k + b[..., None, None] * mm_small(k, k)


def so3_log(r: Array) -> Array:
    """(..., 3, 3) rotation -> (..., 3) axis-angle (|w| < pi).

    Gradient-safe at theta -> 0: arccos has an infinite derivative at
    cos = 1, so the generic branch evaluates it on a *clipped* cosine (clip's
    zero gradient in saturation kills the blowup) and the small-angle branch
    expresses the factor through |v|^2 only.
    """
    tr = jnp.trace(r, axis1=-2, axis2=-1)
    cos = jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    v = jnp.stack(
        [
            r[..., 2, 1] - r[..., 1, 2],
            r[..., 0, 2] - r[..., 2, 0],
            r[..., 1, 0] - r[..., 0, 1],
        ],
        axis=-1,
    )
    lim = 1.0 - 1e-6
    cos_c = jnp.clip(cos, -lim, lim)
    th_c = jnp.arccos(cos_c)
    sin_c = jnp.sqrt(1.0 - cos_c * cos_c)
    fac_gen = th_c / (2.0 * sin_c)
    s2 = 0.25 * jnp.sum(v * v, axis=-1)  # sin^2(theta)
    fac_small = 0.5 + s2 / 12.0  # theta ~ sin for small angles
    small = cos > 1.0 - 1e-5
    fac = jnp.where(small, fac_small, fac_gen)
    w_generic = fac[..., None] * v
    # Near pi: |v| -> 0; recover axis from diagonal of (R + I)/2.
    near_pi = cos < -1.0 + 1e-6
    d = jnp.stack([r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]], axis=-1)
    axis2 = jnp.maximum((d + 1.0) * 0.5, 0.0)
    axis = jnp.sqrt(axis2 + _EPS * _EPS)
    axis = axis * jnp.where(v >= 0, 1.0, -1.0)
    nrm = jnp.linalg.norm(axis, axis=-1, keepdims=True)
    # arccos on the clipped cosine again — its gradient is infinite at ±1 and
    # jnp.where does not block NaN gradients of the untaken branch.
    w_pi = th_c[..., None] * axis / jnp.maximum(nrm, _EPS)
    return jnp.where(near_pi[..., None], w_pi, w_generic)


def se3_exp(xi: Array) -> Array:
    """(..., 6) twist [v, w] -> (..., 4, 4) rigid transform."""
    v, w = xi[..., :3], xi[..., 3:]
    r = so3_exp(w)
    th2 = jnp.sum(w * w, axis=-1)
    gen = th2 > _EPS
    # Double-where: untaken branch evaluated at theta^2 = 1 (see so3_exp).
    th2_f = jnp.where(gen, th2, 1.0)
    th = jnp.sqrt(th2_f)
    b = jnp.where(gen, (1.0 - jnp.cos(th)) / th2_f, 0.5 - th2 / 24.0)
    c = jnp.where(gen, (th - jnp.sin(th)) / (th2_f * th), 1.0 / 6.0)
    k = hat3(w)
    eye = jnp.eye(3, dtype=xi.dtype)
    jl = eye + b[..., None, None] * k + c[..., None, None] * mm_small(k, k)
    t = jnp.einsum("...ij,...j->...i", jl, v)
    top = jnp.concatenate([r, t[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], xi.dtype), (*top.shape[:-2], 1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def se3_log(g: Array) -> Array:
    """(..., 4, 4) -> (..., 6) twist [v, w]."""
    r = g[..., :3, :3]
    t = g[..., :3, 3]
    w = so3_log(r)
    th2 = jnp.sum(w * w, axis=-1)
    k = hat3(w)
    eye = jnp.eye(3, dtype=g.dtype)
    half = 0.5
    # J_l^{-1} = I - k/2 + (1/th^2 - (1+cos th)/(2 th sin th)) k^2.
    # Double-where: untaken generic branch evaluated at theta^2 = 1 so both
    # its value and its vjp stay finite in f32 (see so3_exp).
    gen = th2 > 1e-8
    th2_safe = jnp.where(gen, th2, 1.0)
    th_safe = jnp.sqrt(th2_safe)
    coef = jnp.where(
        gen,
        1.0 / th2_safe
        - (1.0 + jnp.cos(th_safe)) / (2.0 * th_safe * jnp.sin(th_safe)),
        1.0 / 12.0 + th2 / 720.0,
    )
    jli = eye - half * k + coef[..., None, None] * mm_small(k, k)
    v = jnp.einsum("...ij,...j->...i", jli, t)
    return jnp.concatenate([v, w], axis=-1)


def sl3_basis(dtype=jnp.float32) -> Array:
    """The 8 generators of sl(3) (traceless 3x3), the homography tangent space.

    Ordering: [tx, ty, rot, scale, shear1, shear2, proj_x, proj_y] — the
    standard SL(3) parameterization of homographies used for direct tracking.
    """
    g = jnp.zeros((8, 3, 3), dtype)
    g = g.at[0, 0, 2].set(1.0)  # tx
    g = g.at[1, 1, 2].set(1.0)  # ty
    g = g.at[2, 0, 1].set(-1.0).at[2, 1, 0].set(1.0)  # rotation
    g = g.at[3, 0, 0].set(1.0).at[3, 1, 1].set(1.0).at[3, 2, 2].set(-2.0)  # scale
    g = g.at[4, 0, 0].set(1.0).at[4, 1, 1].set(-1.0)  # shear (stretch)
    g = g.at[5, 0, 1].set(1.0).at[5, 1, 0].set(1.0)  # shear (skew)
    g = g.at[6, 2, 0].set(1.0)  # projective x
    g = g.at[7, 2, 1].set(1.0)  # projective y
    return g


def expm3(a: Array, terms: int = 12) -> Array:
    """Matrix exponential of a (..., 3, 3) matrix (fixed-term Taylor with
    scaling-and-squaring; branch-free).  For sl(3) coordinate vectors use
    :func:`sl3_exp`."""
    s = 4
    a = a / (2.0**s)
    eye = jnp.eye(3, dtype=a.dtype)
    out = jnp.broadcast_to(eye, a.shape)
    term = jnp.broadcast_to(eye, a.shape)
    for k in range(1, terms):
        term = mm_small(term, a) / k
        out = out + term
    for _ in range(s):
        out = mm_small(out, out)
    return out


def logm3_near_identity(a: Array, terms: int = 10) -> Array:
    """Matrix log of a (..., 3, 3) matrix near the identity.

    Inverse scaling-and-squaring + Mercator series: 4 branch-free matrix
    square roots (Denman-Beavers-style Newton on ``Y^2 = A`` linearized as
    ``Y_{k+1} = Y_k + (A - Y_k^2)/2`` — convergent for ||A - I|| < 1)
    shrink the argument toward I, then ``log(I + X) = X - X^2/2 + ...``.
    Accurate to f32 roundoff for the sub-percent deviations the symmetric
    ESM composition produces; NOT a general matrix log.
    """
    eye = jnp.eye(3, dtype=a.dtype)
    s = 2
    for _ in range(s):
        # One sqrt via damped Newton (3 steps are ample near I).
        y = jnp.broadcast_to(eye, a.shape)
        for _ in range(3):
            y = y + 0.5 * (a - mm_small(y, y))
        a = y
    x = a - eye
    out = jnp.zeros_like(a)
    p = x
    for k in range(1, terms + 1):
        out = out + ((-1.0) ** (k + 1) / k) * p
        p = mm_small(p, x)
    return out * (2.0**s)


def sl3_exp(x: Array, terms: int = 12) -> Array:
    """(..., 8) sl(3) coords -> (..., 3, 3) unit-determinant homography.

    Matrix exponential by fixed-term Taylor with scaling-and-squaring
    (branch-free, jit-friendly; ||A|| is O(1) for tracking updates).
    """
    a = jnp.einsum("...k,kij->...ij", x, sl3_basis(x.dtype))
    # Scaling and squaring: A/2^s, 4 squarings.
    s = 4
    a = a / (2.0**s)
    eye = jnp.eye(3, dtype=x.dtype)
    out = jnp.broadcast_to(eye, a.shape)
    term = jnp.broadcast_to(eye, a.shape)
    for k in range(1, terms):
        term = mm_small(term, a) / k
        out = out + term
    for _ in range(s):
        out = mm_small(out, out)
    return out
