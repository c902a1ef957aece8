"""GPT-LU — 4-point homography via the 8x8 linear system (batched).

Capability parity with ``cv::runKernel_GPT`` (``C++ Codes/modules/GPT.cpp:51-72``,
OpenCV ``getPerspectiveTransform``) and the CUDA per-thread LU
(``GPU_Runtime Test.cu:242-357``): build ``A h = b`` with
``h = (h1..h8)``, ``h9 = 1`` fixed, and solve by LU with partial pivoting —
here a statically unrolled, branch-free Gauss-Jordan that vectorizes over the
batch (:func:`sks_tpu.ops.linalg.solve_unrolled`).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array

from sks_tpu.ops.linalg import solve_unrolled

__all__ = ["gpt_core", "gpt_lu", "build_gpt_system"]


def gpt_core(
    x0, y0, x1, y1, x2, y2, x3, y3,
    X0, Y0, X1, Y1, X2, Y2, X3, Y3,
):
    """Straight-line pivoted 8x8 Gauss-Jordan on scalar-like components.

    The single-source twin of :func:`gpt_lu` for SoA layouts
    (component-major jnp arrays): the 8x9 tableau lives as a Python list of
    component arrays, the elimination order is static, and partial pivoting is
    a branch-free bubble pass (per-lane row swaps via ``where``) — the batched
    answer to the reference's per-thread ``find_pivot``/``eliminate`` LU
    (``GPU_Runtime Test.cu:242-357``).

    Returns the 9 homography entries row-major, ``H[2,2] == 1``.
    """
    xs = (x0, x1, x2, x3)
    ys = (y0, y1, y2, y3)
    Xs = (X0, X1, X2, X3)
    Ys = (Y0, Y1, Y2, Y3)
    # DF (double-word) components run the identical elimination in df64:
    # only the three non-arithmetic ops (constants, |pivot|, the swap
    # select) need dispatch — everything else is +,-,*,/ which the DF
    # operators provide (ops/df64.gpt_df64_h is the public entry).
    from sks_tpu.ops.df64 import DF as _DF

    if isinstance(x0, _DF):
        from sks_tpu.ops.df64 import df_where

        base = x0.hi
        one = _DF(jnp.ones_like(base), jnp.zeros_like(base))
        zero = _DF(jnp.zeros_like(base), jnp.zeros_like(base))

        def _absval(v):
            return jnp.abs(v.hi + v.lo)

        _where = df_where
    else:
        one = jnp.ones_like(x0)
        zero = jnp.zeros_like(x0)
        _absval = jnp.abs
        _where = jnp.where

    # Tableau rows [A | b]: x-constraints then y-constraints (see
    # build_gpt_system).
    t = [
        [xs[i], ys[i], one, zero, zero, zero, -xs[i] * Xs[i],
         -ys[i] * Xs[i], Xs[i]]
        for i in range(4)
    ] + [
        [zero, zero, zero, xs[i], ys[i], one, -xs[i] * Ys[i],
         -ys[i] * Ys[i], Ys[i]]
        for i in range(4)
    ]

    for k in range(8):
        # Partial pivoting: bubble the max-|pivot| row (per lane) into row k.
        # Columns < k are already eliminated (exact zeros), so swaps only need
        # columns k..8.
        for r in range(k + 1, 8):
            swap = _absval(t[r][k]) > _absval(t[k][k])
            for c in range(k, 9):
                a, b = t[k][c], t[r][c]
                t[k][c] = _where(swap, b, a)
                t[r][c] = _where(swap, a, b)
        inv = 1.0 / t[k][k]
        for c in range(k + 1, 9):
            t[k][c] = t[k][c] * inv
        t[k][k] = one
        for r in range(8):
            if r == k:
                continue
            f = t[r][k]
            for c in range(k + 1, 9):
                t[r][c] = t[r][c] - f * t[k][c]
            t[r][k] = zero

    return (t[0][8], t[1][8], t[2][8], t[3][8], t[4][8], t[5][8],
            t[6][8], t[7][8], one)


def build_gpt_system(src: Array, tar: Array):
    """The classic getPerspectiveTransform 8x8 system.

    Rows i in 0..3:   [x, y, 1, 0, 0, 0, -x X, -y X] . h = X
    Rows i in 4..7:   [0, 0, 0, x, y, 1, -x Y, -y Y] . h = Y
    """
    x, y = src[..., 0], src[..., 1]
    xp, yp = tar[..., 0], tar[..., 1]
    one = jnp.ones_like(x)
    zero = jnp.zeros_like(x)
    top = jnp.stack([x, y, one, zero, zero, zero, -x * xp, -y * xp], axis=-1)
    bot = jnp.stack([zero, zero, zero, x, y, one, -x * yp, -y * yp], axis=-1)
    a = jnp.concatenate([top, bot], axis=-2)  # (..., 8, 8)
    b = jnp.concatenate([xp, yp], axis=-1)  # (..., 8)
    return a, b


def gpt_lu(src: Array, tar: Array, method: str = "unrolled") -> Array:
    """4-point homography with ``H[2,2] == 1`` by construction.

    Args:
      src, tar: (..., 4, 2).
      method: 'unrolled' (branch-free pivoted Gauss-Jordan) or 'lax'
        (XLA's batched ``jnp.linalg.solve``).

    Returns:
      (..., 3, 3).
    """
    a, b = build_gpt_system(src, tar)
    if method == "unrolled":
        h8 = solve_unrolled(a, b, pivot=True)
    elif method == "lax":
        h8 = jnp.linalg.solve(a, b[..., None])[..., 0]
    else:
        raise ValueError(f"unknown method {method!r}")
    one = jnp.ones_like(h8[..., :1])
    h = jnp.concatenate([h8, one], axis=-1)
    return h.reshape(*h.shape[:-1], 3, 3)
