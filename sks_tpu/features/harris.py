"""Harris corner detection as pure convolutions (batched, static top-K).

:func:`detect_corners` is single-scale; :func:`detect_corners_pyramid` runs
the same detector over an average-pooled octave pyramid and returns
scale-annotated keypoints for the oriented/scaled descriptors
(``descriptors.oriented_patch_descriptors``) — the scale-invariance half of
the real-image upgrade.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import Array

__all__ = ["harris_response", "detect_corners", "detect_corners_pyramid",
           "subpixel_refine"]


def _filter1d(img: Array, taps, axis: int) -> Array:
    """'Same' 1-D correlation along ``axis`` via zero-padded shifted sums.

    Identical math to a single-channel ``conv_general_dilated`` — but a
    1-channel conv wastes the matrix units (built for many channels) and
    pays the package's full-f32 matmul precision on top.  Shifted adds run
    the same filter elementwise in exact f32.  Taps are static Python floats (baked constants).
    """
    r = len(taps) // 2
    pad = [(0, 0)] * img.ndim
    pad[axis] = (r, r)
    x = jnp.pad(img, pad)  # zero padding = conv 'SAME' semantics
    n = img.shape[axis]
    out = None
    for i, t in enumerate(taps):
        if t == 0.0:
            continue
        sl = [slice(None)] * img.ndim
        sl[axis] = slice(i, i + n)
        term = t * x[tuple(sl)]
        out = term if out is None else out + term
    return out


def _sep_filter(img: Array, taps_h, taps_w) -> Array:
    """Separable 2-D filter: 1-D taps along H then W (zero-padded 'same')."""
    return _filter1d(_filter1d(img, taps_h, img.ndim - 2), taps_w,
                     img.ndim - 1)


def _gauss_taps(sigma: float, radius: int):
    import math

    g = [math.exp(-0.5 * (i / sigma) ** 2) for i in range(-radius, radius + 1)]
    s = sum(g)
    return [v / s for v in g]


def harris_response(img: Array, k: float = 0.04, sigma: float = 1.5) -> Array:
    """Harris corner response of (..., H, W) grayscale images.

    All filters are separable shifted-sum correlations (see
    :func:`_filter1d`): Sobel = [1,2,1]^T (x) [-1,0,1] / 8; the structure
    tensor is smoothed with a separable Gaussian.  Bit-compatible with the
    previous single-channel XLA-conv formulation up to f32 summation order.
    """
    ix = _sep_filter(img, (0.125, 0.25, 0.125), (-1.0, 0.0, 1.0))
    iy = _sep_filter(img, (-1.0, 0.0, 1.0), (0.125, 0.25, 0.125))
    g = _gauss_taps(sigma, 3)
    sxx = _sep_filter(ix * ix, g, g)
    syy = _sep_filter(iy * iy, g, g)
    sxy = _sep_filter(ix * iy, g, g)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def subpixel_refine(resp: Array, yy: Array, xx: Array) -> tuple[Array, Array]:
    """Sub-pixel corner localization by a 3x3 quadratic fit of the response.

    Fits ``r(d) = r0 + g.d + d'Hd/2`` to the 3x3 neighborhood of each integer
    maximum (central differences for the gradient ``g`` and Hessian ``H``) and
    moves the corner to the stationary point ``d* = -H^{-1} g``.  The offset
    is trusted only when the fit is a genuine maximum (``det H > 0``,
    ``tr H < 0``) and lands inside the pixel (|d*| <= 0.75 per axis, clamped
    to +-0.5); otherwise the integer location is kept.  ~20 flops/corner.

    The reference emits integer-grid corners only — its accuracy machinery
    lives in the solver normalization instead (``C++ Codes/modules/
    HO.cpp:33-149``); on real photographs the quantization (up to 0.5 px at
    octave 0, ``2^o/2`` px at octave o) caps the whole pipeline's accuracy,
    so the detector refines at the source.

    Args:
      resp: (H, W) Harris response.
      yy/xx: (K,) int32 integer corner coordinates.

    Returns:
      (yf, xf): (K,) float32 refined coordinates.
    """
    h, w = resp.shape[-2:]
    # Clamp so the 3x3 stencil is always in-bounds (padded/invalid slots may
    # carry arbitrary indices; real corners are >= border >= 1 from the edge).
    yc = jnp.clip(yy, 1, h - 2)
    xc = jnp.clip(xx, 1, w - 2)

    def at(dy, dx):
        return resp[yc + dy, xc + dx].astype(jnp.float32)

    r0 = at(0, 0)
    gx = 0.5 * (at(0, 1) - at(0, -1))
    gy = 0.5 * (at(1, 0) - at(-1, 0))
    hxx = at(0, 1) - 2.0 * r0 + at(0, -1)
    hyy = at(1, 0) - 2.0 * r0 + at(-1, 0)
    hxy = 0.25 * (at(1, 1) - at(1, -1) - at(-1, 1) + at(-1, -1))
    det = hxx * hyy - hxy * hxy
    # d* = -H^{-1} g (2x2 adjugate solve).
    safe = jnp.where(jnp.abs(det) > 1e-20, det, 1.0)
    ox = -(hyy * gx - hxy * gy) / safe
    oy = -(hxx * gy - hxy * gx) / safe
    good = (det > 0) & (hxx + hyy < 0) & (jnp.abs(ox) <= 0.75) \
        & (jnp.abs(oy) <= 0.75)
    ox = jnp.where(good, jnp.clip(ox, -0.5, 0.5), 0.0)
    oy = jnp.where(good, jnp.clip(oy, -0.5, 0.5), 0.0)
    return yc.astype(jnp.float32) + oy, xc.astype(jnp.float32) + ox


@partial(jax.jit, static_argnames=("num_corners", "nms_radius", "border",
                                   "subpixel"))
def detect_corners(
    img: Array,
    num_corners: int = 512,
    nms_radius: int = 4,
    border: int = 16,
    k: float = 0.04,
    subpixel: bool = True,
):
    """Top-K Harris corners with non-max suppression (fixed output shape).

    Args:
      img: (H, W) grayscale.
      num_corners: static K; weaker slots are padded and masked out.
      subpixel: refine each maximum with :func:`subpixel_refine` (default).

    Returns:
      (xy (K, 2) float32 [x, y], score (K,), valid (K,) bool).
    """
    h, w = img.shape[-2:]
    resp = harris_response(img, k)
    # NMS: keep strict local maxima over a (2r+1)^2 window.
    win = 2 * nms_radius + 1
    pooled = jax.lax.reduce_window(
        resp, -jnp.inf, jax.lax.max, (win, win), (1, 1), "SAME"
    )
    is_max = resp >= pooled
    # Suppress borders (descriptor support must fit).
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    inside = (
        (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    )
    resp_sup = jnp.where(is_max & inside, resp, -jnp.inf)

    flat = resp_sup.reshape(-1)
    score, idx = jax.lax.top_k(flat, num_corners)
    yi = idx // w
    xi = idx % w
    if subpixel:
        yy, xx = subpixel_refine(resp, yi, xi)
    else:
        yy = yi.astype(jnp.float32)
        xx = xi.astype(jnp.float32)
    valid = jnp.isfinite(score) & (score > 0)
    return jnp.stack([xx, yy], axis=-1), score, valid


def _downsample2(img: Array) -> Array:
    """2x average-pool (truncates odd edges)."""
    h, w = img.shape[-2:]
    h2, w2 = h // 2, w // 2
    x = img[..., : h2 * 2, : w2 * 2]
    x = x.reshape(*x.shape[:-2], h2, 2, w2, 2)
    return x.mean(axis=(-3, -1))


@partial(jax.jit, static_argnames=("num_corners", "num_octaves", "nms_radius",
                                   "border", "subpixel"))
def detect_corners_pyramid(
    img: Array,
    num_corners: int = 512,
    num_octaves: int = 3,
    nms_radius: int = 4,
    border: int = 16,
    k: float = 0.04,
    subpixel: bool = True,
):
    """Top-K Harris corners over an octave pyramid (fixed output shape).

    Per octave the image is 2x average-pooled and the single-scale detector
    runs unchanged; responses are compared globally (Harris response is
    homogeneous in the local gradient energy, comparable across octaves after
    pooling) and the winners carry their octave's scale.  With ``subpixel``
    (default) every octave's maxima are quadratically refined *in the pooled
    grid* before upscaling, so octave-o corners are continuous rather than
    quantized to ``2^o`` px.

    Returns:
      (xy (K, 2) float32 full-resolution [x, y], score (K,), valid (K,) bool,
       scale (K,) float32 — 2**octave).
    """
    per = num_corners  # detect K per octave, then global top-K
    xys, scores, valids, scales = [], [], [], []
    level = img
    for o in range(num_octaves):
        xy, sc, va = detect_corners(level, per, nms_radius, border, k,
                                    subpixel)
        f = float(2 ** o)
        xys.append(xy * f + (f - 1) / 2.0)  # pooled-pixel center offset
        scores.append(jnp.where(va, sc, -jnp.inf))
        valids.append(va)
        scales.append(jnp.full((per,), f, jnp.float32))
        if o + 1 < num_octaves:
            level = _downsample2(level)
    score_all = jnp.concatenate(scores)
    score, idx = jax.lax.top_k(score_all, num_corners)
    xy = jnp.take(jnp.concatenate(xys, axis=0), idx, axis=0)
    valid = jnp.take(jnp.concatenate(valids), idx) & jnp.isfinite(score)
    scale = jnp.take(jnp.concatenate(scales), idx)
    return xy, score, valid, scale
