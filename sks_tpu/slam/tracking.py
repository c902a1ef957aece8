"""Direct (dense) homography tracking on SL(3): ESM.

The dense complement to the feature+RANSAC front end: instead of detecting
and matching sparse corners, align the raw pixels of a template region to
the current frame by minimizing the photometric error over the 8-parameter
SL(3) homography group — Efficient Second-order Minimization (ESM,
Benhimane & Malis, IROS 2004).  This is the classic real-time planar
tracker used by planar SLAM/AR systems; the reference repo has no tracking
layer at all (its scope ends at the 4-point solve), so this layer is new
capability toward the BASELINE planar-SLAM north star.

Accelerator shape: fixed template size, fixed iteration counts, a
coarse-to-fine pyramid of static depth, branch-free damped Gauss-Newton
(accept/reject by ``where``), everything one jit — and trivially vmappable
over many templates (multi-patch tracking is a batched call).

**Sampling path.**  The inner loop needs three bilinear samples per
template pixel per iteration (warped image + its two gradients).  The
default (``sampler='gather'``, also what ``'auto'`` means) gathers them.
``sampler='matmul'`` reformulates the gather as dense linear algebra: the
y-interpolation becomes a one-hot *row-weight* matrix ``Wy (N, H)`` with
``(1-fy, fy)`` at rows ``(y0, y0+1)``, applied as ONE matmul
``Wy @ [img | gx | gy] (H, 3W)``; the x-interpolation is then an
elementwise masked reduction with the analogous ``Wx (N, W)`` — zero
irregular memory access, bit-identical weights to ``bilinear_sample``
(same clamping).  Its cost is ``N*H*3W`` MACs/iteration instead of ``12N``
loads, a win only where gathers serialize: on an H100 the symmetric
640x480 polish at 8 iterations takes 5.3 ms with gathers, 97 ms with the
f32 matmul and 23 ms with ``'matmul_bf16'`` (PERF.md).

Math (forward compositional, ESM gradient):
  warp  w(x; H) = pi(H x),   update  H <- H . exp(sum_k d_k G_k)
with G_k the sl(3) generators (:func:`sks_tpu.geom.lie.sl3_basis`).  At
d = 0 the Jacobian column k at template pixel p is

  J_k(p) = g(p)^T . dpi(y_p) . (H G_k x_p),      y_p = H x_p,

where dpi is the 2x3 projection differential and g(p) the ESM gradient —
the *mean* of the template gradient and the warped-image gradient, which
buys second-order convergence for one extra sampling pass.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import Array

from sks_tpu.features.descriptors import _bilinear_weights, bilinear_sample
from sks_tpu.geom.lie import sl3_basis, sl3_exp

__all__ = ["esm_track", "esm_track_pyramid", "esm_polish_pair",
           "esm_polish_pair_symmetric", "esm_guard"]


def _grad(img: Array) -> tuple:
    """Edge-clamped central-difference gradients (H, W) -> (gx, gy).

    Edge padding (not wrap): a rolled difference would mix opposite borders
    into the boundary pixels' gradients, injecting garbage rows into the
    ESM normal equations at full weight.
    """
    px = jnp.pad(img, ((0, 0), (1, 1)), mode="edge")
    py = jnp.pad(img, ((1, 1), (0, 0)), mode="edge")
    gx = 0.5 * (px[:, 2:] - px[:, :-2])
    gy = 0.5 * (py[2:, :] - py[:-2, :])
    return gx, gy


@partial(jax.jit,
         static_argnames=("iters", "photometric", "dof", "sampler", "stride"))
def esm_track(
    template: Array,
    image: Array,
    h0: Array,
    origin: Array | None = None,
    iters: int = 20,
    damping: float = 1e-4,
    photometric: bool = True,
    huber: float = 0.1,
    dof: int = 8,
    sampler: str = "auto",
    stride: int = 1,
) -> tuple:
    """Align ``image`` to ``template`` by ESM over SL(3).

    Args:
      template: (th, tw) grayscale template (the reference appearance).
      image: (H, W) current frame.
      h0: (3, 3) initial homography mapping template pixel coords ->
        image pixel coords (e.g. the previous frame's estimate, or the
        feature-RANSAC model to be polished).
      origin: (2,) template's top-left in its own coordinate frame
        (default (0, 0)); template pixel p has homogeneous coords
        (origin + p, 1).
      iters: damped Gauss-Newton iteration CAP (static); the loop exits
        early on convergence (sub-1e-5 accepted step + flat cost) or a
        damping blow-up.  Under vmap the batch runs until every element
        converges (lax.while_loop semantics).
      damping: Levenberg diagonal damping added to J^T J.
      photometric: solve a closed-form gain/bias (I_w ~ a T + b) each
        iteration — brightness constancy rarely holds between real frames
        (exposure, gamma), and an unmodeled gain drags the geometry.
      huber: Huber scale in intensity units; residuals beyond it are
        downweighted (occlusions, out-of-plane pixels, rendering fill).
      dof: leading sl(3) generators to optimize — 2 translation,
        4 similarity, 6 affine, 8 full homography.  Small patches cannot
        constrain the projective parameters; 6-DOF is the standard
        small-patch model (the update stays inside SL(3) either way).
      sampler: 'gather' / 'auto' (bilinear gathers, the faster arm on the
        GPU), 'matmul' (one-hot matmul sampling, see module docstring) or
        'matmul_bf16' (the same in bf16).  Identical results up to float
        summation order (bf16 rounding aside).
      stride: template-pixel subsampling step.  The matmul sampler's cost is
        linear in the number of template pixels (the (N, H) row-weight
        matmul dominates), so stride=2 cuts the per-iteration cost ~4x; the
        warp stays sub-pixel exact (the IMAGE is sampled at full resolution
        — only the set of voting template pixels thins).  CAUTION — this is
        a throughput knob, not a free win: subsampling the template without
        a low-pass aliases its high-frequency content into the normal
        equations, and on the photo-VO protocol stride=2 measured a
        systematic ~1.4x mean ATE regression (worse in 5 of 6
        texture x seed cells), so every polish default stays stride=1.

    Returns:
      (h (3, 3), rms residual () ) — ``h`` maps template coords -> image
      coords; the residual is photometric RMS (gain/bias-compensated) over
      valid (in-bounds) pixels.
    """
    th, tw = template.shape
    dt = template.dtype
    origin = (jnp.zeros((2,), dt) if origin is None
              else jnp.asarray(origin, dt))
    image = jnp.asarray(image, dt)
    ys = jnp.arange(0, th, stride, dtype=dt) + origin[1]
    xs = jnp.arange(0, tw, stride, dtype=dt) + origin[0]
    gy, gx = jnp.meshgrid(ys, xs, indexing="ij")
    # (N, 3) homogeneous template coords (every stride-th pixel).
    n_pix = ys.shape[0] * xs.shape[0]
    xh = jnp.stack(
        [gx.reshape(-1), gy.reshape(-1), jnp.ones(n_pix, dt)], axis=-1
    )
    t_flat = template[::stride, ::stride].reshape(-1)
    tgx, tgy = _grad(template)  # full-res gradients, sampled at the grid
    tg = jnp.stack([tgx[::stride, ::stride].reshape(-1),
                    tgy[::stride, ::stride].reshape(-1)], axis=-1)  # (N, 2)
    gens = sl3_basis(dt)[:dof]  # (dof, 3, 3)
    h0f, w0f = image.shape[0] - 1.0, image.shape[1] - 1.0

    igx, igy = _grad(image)

    use_matmul = sampler in ("matmul", "matmul_bf16")
    # bf16 SAMPLING matmuls (f32 accumulation): quantizes interpolation
    # weights to 8 mantissa bits (~1/256-px sub-pixel resolution) and
    # intensities to ~0.4% — noise the 8-parameter normal equations
    # average over tens of thousands of pixels.  Measured on the photo VO
    # protocol: ATE within noise of the f32 sampler on every texture at
    # ~4x the matmul rate (the polish's dominant cost).
    bf16 = sampler == "matmul_bf16"
    mdt = jnp.bfloat16 if bf16 else dt
    ih, iw_ = image.shape
    if use_matmul:
        # (H, 3W) stack: one row-weight matmul interpolates all three images.
        imgs_cat = jnp.concatenate([image, igx, igy], axis=1).astype(mdt)
        image_s = image.astype(mdt)

    def _dot_f32(a, b):
        return jax.lax.dot_general(
            a, b, (((1,), (0,)), ((), ())),
            precision=None if bf16 else "highest",
            preferred_element_type=jnp.float32,
        )

    def sample3(uv):
        """(iw, gx_w, gy_w) warped image + gradient samples at (N, 2) uv."""
        if not use_matmul:
            return (bilinear_sample(image, uv), bilinear_sample(igx, uv),
                    bilinear_sample(igy, uv))
        wy = _bilinear_weights(uv[:, 1], ih, mdt)  # (N, H)
        wx = _bilinear_weights(uv[:, 0], iw_, dt)  # (N, W)
        rows = _dot_f32(wy, imgs_cat)  # (N, 3W) f32
        r3 = rows.reshape(rows.shape[0], 3, iw_)
        out = jnp.einsum("nkw,nw->kn", r3, wx, precision="highest")
        return out[0], out[1], out[2]

    def sample1(uv):
        """Warped image only (the accept/reject cost probe)."""
        if not use_matmul:
            return bilinear_sample(image, uv)
        wy = _bilinear_weights(uv[:, 1], ih, mdt)
        wx = _bilinear_weights(uv[:, 0], iw_, dt)
        rows = _dot_f32(wy, image_s)  # (N, W) f32
        return jnp.sum(rows * wx, axis=-1)

    def gain_bias(iw, valid):
        """Closed-form a, b minimizing sum valid (a T + b - I_w)^2."""
        if not photometric:
            return jnp.asarray(1.0, dt), jnp.asarray(0.0, dt)
        n = jnp.maximum(jnp.sum(valid), 1.0)
        st = jnp.sum(valid * t_flat)
        si = jnp.sum(valid * iw)
        stt = jnp.sum(valid * t_flat * t_flat)
        sti = jnp.sum(valid * t_flat * iw)
        var = jnp.maximum(stt - st * st / n, 1e-8)
        a = (sti - st * si / n) / var
        a = jnp.clip(a, 0.25, 4.0)
        b = (si - a * st) / n
        return a, b

    def cost_of(h):
        y = xh @ h.T
        zr = y[:, 2]
        z = jnp.maximum(zr, 1e-6)
        uv = y[:, :2] / z[:, None]
        u, v = uv[:, 0], uv[:, 1]
        # Same validity rule as the iteration body (incl. the z > 1e-6
        # cheirality term) so accept/reject compares costs over identical
        # pixel sets near the plane at infinity (ADVICE r3).
        valid = ((u >= 1.0) & (u <= w0f - 1.0)
                 & (v >= 1.0) & (v <= h0f - 1.0)
                 & (zr > 1e-6)).astype(dt)
        iw = sample1(uv)
        a, b = gain_bias(iw, valid)
        r = (iw - (a * t_flat + b)) * valid
        w = jnp.minimum(1.0, huber / jnp.maximum(jnp.abs(r), 1e-12))
        return jnp.sum(w * r * r), valid

    def body(carry):
        h, lam, _, it, _ = carry
        y = xh @ h.T  # (N, 3)
        z = y[:, 2]
        iz = 1.0 / jnp.maximum(z, 1e-6)
        u = y[:, 0] * iz
        v = y[:, 1] * iz
        uv = jnp.stack([u, v], axis=-1)
        iw, gxw, gyw = sample3(uv)  # warped intensities + gradients
        valid = ((u >= 1.0) & (u <= w0f - 1.0)
                 & (v >= 1.0) & (v <= h0f - 1.0)
                 & (z > 1e-6)).astype(dt)
        a, b = gain_bias(iw, valid)
        r = (iw - (a * t_flat + b)) * valid
        # Huber IRLS weights: large residuals (occlusion, off-plane) fade.
        w = jnp.minimum(1.0, huber / jnp.maximum(jnp.abs(r), 1e-12))
        # ESM gradient: mean of (gain-scaled) template and warped gradients.
        wg = jnp.stack([gxw, gyw], axis=-1)
        g = 0.5 * (a * tg + wg) * (valid * w)[:, None]
        # dpi(y) rows: [1/z, 0, -u/z], [0, 1/z, -v/z].
        # J_k = g . dpi(y) . (H G_k x)  -> precompute M_k = H G_k (8, 3, 3).
        m = jnp.einsum("ij,kjl->kil", h, gens)  # (8, 3, 3)
        hgx = jnp.einsum("kil,nl->nki", m, xh)  # (N, 8, 3)
        du = (hgx[..., 0] - u[:, None] * hgx[..., 2]) * iz[:, None]
        dv = (hgx[..., 1] - v[:, None] * hgx[..., 2]) * iz[:, None]
        jac = g[:, 0:1] * du + g[:, 1:2] * dv  # (N, 8)
        a_mat = jac.T @ jac
        a_mat = a_mat + lam * jnp.diag(jnp.diag(a_mat)) \
            + 1e-10 * jnp.eye(dof, dtype=dt)
        rhs = -(jac.T @ (w * r))
        d = jnp.linalg.solve(a_mat, rhs)
        d8 = jnp.zeros((8,), dt).at[:dof].set(d)
        h_new = h @ sl3_exp(d8)
        # Accept only improving, finite steps (branch-free).
        c_old = jnp.sum(w * r * r)
        c_new, _ = cost_of(h_new)
        ok = jnp.isfinite(c_new) & (c_new < c_old) \
            & jnp.all(jnp.isfinite(h_new))
        h = jnp.where(ok, h_new, h)
        # Adaptive LM damping: shrink on accept, grow on reject (a fixed
        # damping re-proposes the same rejected step forever).
        lam = jnp.where(ok, jnp.maximum(lam * 0.3, 1e-6), lam * 8.0)
        nval = jnp.maximum(jnp.sum(valid), 1.0)
        rms = jnp.sqrt(jnp.where(ok, c_new, c_old) / nval)
        # Convergence exit (round 5): ``iters`` is a cap, not a cost.  Done
        # when an accepted step is sub-convergence-scale in BOTH parameters
        # and cost, or when damping has grown past any useful step (stuck
        # at a rejected minimum).  Near-converged polish starts (the
        # esm_polish_pair case: RANSAC leaves ~1 px) exit in a few of the
        # 8 capped iterations.
        small = (jnp.max(jnp.abs(d)) < 1e-5) & (
            c_old - c_new < 1e-5 * (c_old + 1e-30))
        done = (ok & small) | (lam > 1e6)
        return h, lam, rms, it + 1, done

    def cond(carry):
        return (carry[3] < iters) & ~carry[4]

    h, _, rms, _, _ = jax.lax.while_loop(
        cond, body,
        (jnp.asarray(h0, dt), jnp.asarray(damping, dt),
         jnp.asarray(jnp.inf, dt), jnp.asarray(0, jnp.int32),
         jnp.asarray(False)),
    )
    return h, rms


@partial(jax.jit,
         static_argnames=("crop", "iters", "dof", "sampler", "stride"))
def esm_polish_pair(
    img1: Array,
    img2: Array,
    h0: Array,
    crop: tuple | None = None,
    iters: int = 10,
    dof: int = 8,
    sampler: str = "auto",
    stride: int = 1,
) -> tuple:
    """Dense ESM refinement of a pair homography.

    The bridge between the feature front end and the direct tracker: a
    feature-RANSAC model ``h0`` (mapping ``img1`` pixel coords -> ``img2``
    pixel coords, the `find_homography`/`fit_pair` convention) is polished by
    photometric alignment of a central crop of ``img1`` against ``img2`` —
    every pixel in the crop votes, not just the matched corners, so the
    refinement is immune to corner localization error (the round-3 accuracy
    ceiling).  The start is already within ~1 px, so a single-level track
    suffices (no pyramid).

    ESM only accepts photometric-cost-reducing steps, but a photometric
    improvement can still hurt *geometry* when the scene violates the planar
    assumption — callers guarding production fits should re-score the
    returned model against the matches and keep the better one (see
    ``slam.pipeline``).

    Args:
      img1, img2: (H, W) grayscale frames.
      h0: (3, 3) initial homography img1 -> img2.
      crop: static (ch, cw) template size (default: central half-frame).
      iters/dof/sampler: forwarded to :func:`esm_track`.

    Returns:
      (h (3, 3) refined, rms photometric residual ()).
    """
    h_img, w_img = img1.shape
    if crop is None:
        crop = (h_img // 2, w_img // 2)
    ch, cw = crop
    cy, cx = (h_img - ch) // 2, (w_img - cw) // 2
    tpl = img1[cy:cy + ch, cx:cx + cw]
    origin = jnp.asarray([cx, cy], img1.dtype)
    return esm_track(tpl, img2, h0, origin=origin, iters=iters, dof=dof,
                     sampler=sampler, stride=stride)


@partial(jax.jit,
         static_argnames=("border", "iters", "dof", "sampler", "stride",
                          "levels", "fine_iters"))
def esm_polish_pair_symmetric(
    img1: Array,
    img2: Array,
    h0: Array,
    border: int = 16,
    iters: int = 8,
    dof: int = 8,
    sampler: str = "auto",
    stride: int = 1,
    levels: int = 2,
    fine_iters: int = 2,
) -> tuple:
    """Bias-cancelling dense polish: forward AND backward ESM, geodesic mean.

    The round-4 one-direction polish regressed the china VO sequence
    (REAL_PHOTO.md): asymmetric defocus blur between views shifts the
    photometric optimum geometrically, and a match-residual guard cannot
    see a sub-pixel systematic shift that accumulates over the chain.  Two
    measured changes fix it (round 5, all three bundled photo textures):

    * **Full-frame support** (``border``-inset template instead of the
      central half-frame crop): 4x the pixels constrain the projective
      DOFs and average local bias — alone this moved every texture's VO
      ATE below the one-direction polish.
    * **Symmetric composition**: polish img1->img2 AND img2->img1 from the
      inverse start; to first order the blur bias shifts the two optima in
      OPPOSITE directions, so the SL(3) geodesic mean
      ``H_f . exp(0.5 log(H_f^-1 H_b^-1))`` cancels it while averaging the
      independent photometric noise of the two fits.

    Measured (12-frame photo VO, ATE % of path, vs feature-only base /
    round-4 half-frame one-direction polish):
    china 0.66 (1.06 / 1.91), hopper 0.45 (2.22 / 1.06),
    flower 1.00 (3.15 / 1.49) — every texture beats feature-only, which
    is what lets the dense polish default on.

    Args:
      img1, img2: (H, W) grayscale frames.
      h0: (3, 3) initial homography img1 -> img2 (the RANSAC model).
      border: static inset of the full-frame template (avoids warp
        boundary effects).
      stride: template subsampling (default 1): stride=2 runs ~4x faster
        (the polish's cost is linear in voting-pixel count) but measured a
        systematic ~1.4x mean ATE regression across the photo-VO
        texture x seed grid — template aliasing, see :func:`esm_track` —
        so accuracy-default configs keep 1.
      levels: 2 (default) = coarse-to-fine: run the full symmetric polish
        at 1/2 resolution first (2x2-mean low-pass, so no aliasing; 1/4
        the pixels per iteration), then ``fine_iters`` full-resolution
        symmetric iterations from the upscaled model.  1 = single level
        (all ``iters`` at full resolution).  Photo-VO ATE is equal-or-better
        than single-level on every texture x seed cell (mean 0.84 -> 0.79%
        of path over the 6-cell grid).
      fine_iters: full-resolution iteration cap when ``levels >= 2``.
      iters/dof/sampler: forwarded to :func:`esm_track` (iters is a cap —
        the tracker early-exits on convergence).  ``sampler='auto'`` is
        'gather'; of the matmul arms, 'matmul_bf16' measures within noise
        of f32 on every photo texture's VO ATE (china 0.69 vs 0.66, hopper
        0.45 vs 0.45, flower 1.05 vs 1.00).

    Returns:
      (h (3, 3) refined img1->img2, mean fwd/bwd rms photometric residual).
    """
    from sks_tpu.geom.lie import expm3, logm3_near_identity, mm_small

    def sym_once(i1, i2, h_init, bdr, its):
        h_img, w_img = i1.shape
        crop = (h_img - 2 * bdr, w_img - 2 * bdr)
        h_f, rms_f = esm_polish_pair(i1, i2, h_init, crop=crop, iters=its,
                                     dof=dof, sampler=sampler, stride=stride)
        h0i = jnp.linalg.inv(h_init)
        h0i = h0i / h0i[2, 2]
        h_b, rms_b = esm_polish_pair(i2, i1, h0i, crop=crop, iters=its,
                                     dof=dof, sampler=sampler, stride=stride)
        hbi = jnp.linalg.inv(h_b)
        hfn = h_f / h_f[2, 2]
        hbn = hbi / hbi[2, 2]
        # Both normalized models estimate i1->i2; their deviation from
        # agreement is the (mostly antisymmetric) bias + noise.
        d = mm_small(jnp.linalg.inv(hfn), hbn)
        d = d / d[2, 2]
        h_sym = mm_small(hfn, expm3(0.5 * logm3_near_identity(d)))
        ok = jnp.all(jnp.isfinite(h_sym))
        h_out = jnp.where(ok, h_sym,
                          jnp.where(jnp.all(jnp.isfinite(h_f)), h_f, h_init))
        return h_out, 0.5 * (rms_f + rms_b)

    dt = img1.dtype
    h_cur = jnp.asarray(h0, dt)
    if levels >= 2:
        # Coarse pass at 1/2 resolution: proper 2x2-mean low-pass (unlike
        # the stride knob's raw subsampling, no aliasing) at ~1/16 the
        # per-iteration matmul cost.  H conjugates by the similarity
        # S = diag(1/2, 1/2, 1): H_half = S H S^{-1}.
        i1c, i2c = _down2(img1), _down2(img2)
        s_dn = jnp.asarray([[0.5, 0, 0], [0, 0.5, 0], [0, 0, 1]], dt)
        s_up = jnp.asarray([[2.0, 0, 0], [0, 2.0, 0], [0, 0, 1]], dt)
        h_half = mm_small(s_dn, mm_small(h_cur, s_up))
        h_half, _ = sym_once(i1c, i2c, h_half / h_half[2, 2],
                             max(border // 2, 4), iters)
        h_up = mm_small(s_up, mm_small(h_half, s_dn))
        h_cur = jnp.where(jnp.all(jnp.isfinite(h_up)),
                          h_up / h_up[2, 2], h_cur)
        fine = fine_iters
    else:
        fine = iters
    return sym_once(img1, img2, h_cur, border, fine)


def esm_guard(h_base: Array, h_esm: Array, p1: Array, p2: Array,
              inlier_mask: Array, tol: float = 1.1) -> Array:
    """Geometry guard for the dense polish: accept the ESM model only if it
    does not degrade the *matched-feature* fit.

    A photometric-cost improvement can be a geometric loss when the
    brightness-constancy assumption bends (asymmetric defocus blur between
    views is the measured failure: the photometric optimum under blur shifts
    the geometry by pixels).  The matched inliers are an independent witness:
    on every measured regression the median symmetric-transfer residual of
    the base model's inliers rose by >= 20% under the ESM model, while on
    every win it was flat or better — so the guard accepts iff

        median r2_esm(inliers) <= tol * median r2_base(inliers).

    Returns a scalar bool (traceable; combine with ``jnp.where``).
    """
    from sks_tpu.robust.ransac import _residual2

    r2b = _residual2(h_base[None], p1, p2)[0]
    r2e = _residual2(h_esm[None], p1, p2)[0]
    nan = jnp.asarray(jnp.nan, r2b.dtype)
    medb = jnp.nanmedian(jnp.where(inlier_mask, r2b, nan))
    mede = jnp.nanmedian(jnp.where(inlier_mask, r2e, nan))
    return jnp.all(jnp.isfinite(h_esm)) & (mede <= tol * medb)


def _down2(img: Array) -> Array:
    """2x2 mean downsample (even-cropped)."""
    h2, w2 = (img.shape[0] // 2) * 2, (img.shape[1] // 2) * 2
    x = img[:h2, :w2]
    return 0.25 * (x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2]
                   + x[1::2, 1::2])


@partial(jax.jit, static_argnames=("levels", "iters", "sampler"))
def esm_track_pyramid(
    template: Array,
    image: Array,
    h0: Array,
    levels: int = 3,
    iters: int = 15,
    sampler: str = "auto",
) -> tuple:
    """Coarse-to-fine ESM: track at 1/2^(levels-1) ... full resolution.

    Extends the convergence basin to motions of tens of pixels (single-level
    ESM is local).  The homography is rescaled between levels with the
    similarity conjugation H_l = S_l H S_l^{-1}, S_l = diag(1/2^l, 1/2^l, 1).

    Returns (h (3, 3), rms at the finest level).
    """
    dt = template.dtype

    def scaled(h, s):
        s_mat = jnp.asarray([[s, 0.0, 0.0], [0.0, s, 0.0], [0.0, 0.0, 1.0]],
                            dt)
        s_inv = jnp.asarray(
            [[1.0 / s, 0.0, 0.0], [0.0, 1.0 / s, 0.0], [0.0, 0.0, 1.0]], dt
        )
        return s_mat @ h @ s_inv

    # Static pyramid (shapes halve per level).
    tpl = [template]
    img = [image]
    for _ in range(levels - 1):
        tpl.append(_down2(tpl[-1]))
        img.append(_down2(img[-1]))

    h = jnp.asarray(h0, dt)
    rms = jnp.asarray(jnp.inf, dt)
    for lvl in range(levels - 1, -1, -1):
        s = 0.5 ** lvl
        h_l = scaled(h, s)
        h_l, rms = esm_track(tpl[lvl], img[lvl], h_l, iters=iters,
                             sampler=sampler)
        h = scaled(h_l, 1.0 / s)
    return h, rms
