"""Photometric planar image synthesis: textured planes under exact homographies.

The reference grounds every harness in one real wall scene's SIFT matches
(``CPU_Runtime Test/orig_pts_wall.txt``, sampled by ``main.cpp:21-30`` and
``GPU_Runtime Test.cu:52-78``).  Copying that data is off the table, and this
environment has no network, so the real-image role is filled the synthesis
way: a procedurally textured plane is *rendered* under exact plane-induced
homographies with photometric nuisances (gain/bias/gamma, sensor noise,
blur), and the feature pipeline runs on the **pixels** — matches are
image-derived, never sampled from ground truth.  Ground truth H/poses remain
available for honest scoring (HPatches-style planar pairs with exact GT).

All functions are jittable and seeded; nothing is stored on disk.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import Array

from sks_tpu.features.descriptors import bilinear_sample
from sks_tpu.geom.homography import apply_homography, homography_from_pose

__all__ = [
    "plane_texture",
    "photo_texture",
    "available_photos",
    "warp_image",
    "photometric_jitter",
    "gaussian_blur",
    "planar_pair",
    "planar_pair_boxes",
    "planar_sequence",
]

# Real photographs shipped inside locally installed packages (no network
# needed).  A real photo as the plane texture grounds the feature pipeline in
# genuine photographic statistics — sensor texture, lighting gradients,
# natural edge distributions — the role the reference's wall photo plays for
# its SIFT fixture (`CPU_Runtime Test/orig_pts_wall.txt`).  Three distinct
# scenes (portrait / close-up flora / urban architecture) so the photo
# protocol is not anchored to one image's statistics.
_PHOTO_CANDIDATES = {
    # matplotlib's sample portrait (512x600 RGB photograph).
    "hopper": ("matplotlib", "mpl-data/sample_data/grace_hopper.jpg"),
    # scikit-learn's sample photos (427x640 RGB photographs).
    "flower": ("sklearn", "datasets/images/flower.jpg"),
    "china": ("sklearn", "datasets/images/china.jpg"),
}


def available_photos() -> tuple:
    """Names of bundled photographs actually present in this environment."""
    return tuple(
        name for name in _PHOTO_CANDIDATES
        if photo_texture(name=name, _probe=True) is not None
    )


def photo_texture(shape: tuple = (480, 640), dtype=jnp.float32,
                  name: str = "hopper", _probe: bool = False):
    """A real photograph as a [0, 1] grayscale plane texture, or None.

    Loads the named bundled photo (see ``_PHOTO_CANDIDATES``), converts to
    luminance, center-crops to the target aspect ratio (no anisotropic
    stretch — the photographic statistics survive the resize), and resizes
    to ``shape``.  Returns None when the photo or loader (PIL) is missing so
    callers can fall back to :func:`plane_texture` — keeps the module
    import-clean in minimal envs.
    """
    import os
    from importlib import resources

    try:
        from PIL import Image
    except ImportError:
        return None
    if name not in _PHOTO_CANDIDATES:
        raise ValueError(
            f"unknown photo {name!r}; candidates: {sorted(_PHOTO_CANDIDATES)}"
        )
    pkg, rel = _PHOTO_CANDIDATES[name]
    try:
        path = str(resources.files(pkg).joinpath(rel))
    except (ImportError, ModuleNotFoundError):
        return None
    if not os.path.isfile(path):
        return None
    if _probe:
        return path
    img = Image.open(path).convert("L")
    arr = jnp.asarray(img, dtype) / 255.0
    # Center-crop to the target aspect ratio before resizing.
    h0, w0 = arr.shape
    th, tw = shape
    if h0 * tw > w0 * th:  # too tall: crop rows
        keep = max(1, (w0 * th) // tw)
        off = (h0 - keep) // 2
        arr = arr[off:off + keep, :]
    elif h0 * tw < w0 * th:  # too wide: crop cols
        keep = max(1, (h0 * tw) // th)
        off = (w0 - keep) // 2
        arr = arr[:, off:off + keep]
    # resize's linear kernel can overshoot [0, 1] by ~1 ulp at crop edges.
    return jnp.clip(jax.image.resize(arr, shape, "linear"), 0.0, 1.0)


def plane_texture(key: Array, shape: tuple = (480, 640), octaves: int = 5,
                  dtype=jnp.float32) -> Array:
    """Multi-octave value-noise texture with corner-rich structure in [0, 1].

    Octave 0 is thresholded into high-contrast cells (brick/mondrian-like
    edges and corners for the detector); finer octaves add texture the
    descriptors can discriminate.
    """
    h, w = shape
    keys = jax.random.split(key, octaves + 1)
    img = jnp.zeros(shape, dtype)
    amp = 1.0
    total = 0.0
    for o in range(octaves):
        gh = max(2, (h // 64) * (2 ** o))
        gw = max(2, (w // 64) * (2 ** o))
        grid = jax.random.uniform(keys[o], (gh, gw), dtype)
        up = jax.image.resize(grid, shape, "linear")
        if o == 0:
            # Quantize the coarsest octave: sharp edges, strong corners.
            up = jnp.round(up * 4.0) / 4.0
            layer_amp = 1.5
        else:
            layer_amp = amp
        img = img + layer_amp * up
        total += layer_amp
        amp *= 0.55
    img = img / total
    lo, hi = jnp.min(img), jnp.max(img)
    return (img - lo) / jnp.maximum(hi - lo, 1e-6)


def warp_image(img: Array, h_mat: Array, out_shape: tuple | None = None,
               fill: float = 0.5) -> Array:
    """Render the view of ``img`` under homography ``h_mat``.

    ``h_mat`` maps source pixels -> output pixels (the GT direction used
    everywhere else); rendering inverse-warps: out(x') = img(H^{-1} x').
    Out-of-source pixels get ``fill``.
    """
    if out_shape is None:
        out_shape = img.shape[-2:]
    hh, ww = out_shape
    hi = jnp.linalg.inv(h_mat)
    ys = jnp.arange(hh, dtype=img.dtype)
    xs = jnp.arange(ww, dtype=img.dtype)
    gy, gx = jnp.meshgrid(ys, xs, indexing="ij")
    pts = jnp.stack([gx, gy], axis=-1).reshape(-1, 2)
    src = apply_homography(hi, pts)
    vals = bilinear_sample(img, src)
    h0, w0 = img.shape[-2:]
    inside = (
        (src[:, 0] >= 0.0) & (src[:, 0] <= w0 - 1.0)
        & (src[:, 1] >= 0.0) & (src[:, 1] <= h0 - 1.0)
    )
    vals = jnp.where(inside, vals, fill)
    return vals.reshape(hh, ww)


def photometric_jitter(key: Array, img: Array, noise: float = 0.01,
                       max_gain: float = 0.25, max_bias: float = 0.1) -> Array:
    """Sensor-style nuisances: gain/bias, gamma, additive Gaussian noise."""
    kg, kb, kgam, kn = jax.random.split(key, 4)
    gain = 1.0 + jax.random.uniform(kg, (), img.dtype, -max_gain, max_gain)
    bias = jax.random.uniform(kb, (), img.dtype, -max_bias, max_bias)
    gamma = jnp.exp(jax.random.uniform(kgam, (), img.dtype, -0.2, 0.2))
    x = jnp.clip(img * gain + bias, 0.0, 1.0) ** gamma
    x = x + noise * jax.random.normal(kn, img.shape, img.dtype)
    return jnp.clip(x, 0.0, 1.0)


def gaussian_blur(img: Array, sigma: float, radius: int | None = None) -> Array:
    """Separable Gaussian blur (defocus/motion-nuisance model for pairs)."""
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    xs = jnp.arange(-radius, radius + 1, dtype=img.dtype)
    k = jnp.exp(-0.5 * (xs / sigma) ** 2)
    k = k / jnp.sum(k)
    pad = [(radius, radius), (0, 0)]
    x = jnp.pad(img, pad, mode="edge")
    x = jax.vmap(lambda col: jnp.convolve(col, k, mode="valid"),
                 in_axes=1, out_axes=1)(x)
    x = jnp.pad(x, [(0, 0), (radius, radius)], mode="edge")
    x = jax.vmap(lambda row: jnp.convolve(row, k, mode="valid"))(x)
    return x


def _random_scene(kr: Array, ks: Array, shape: tuple, focal: float,
                  max_angle: float, max_shift: float):
    """Shared scene draw for the pair renderers: intrinsics, a random
    camera pose, the main plane (frontal, depth 3), and its induced
    homography.  Single source so the plain and parallax protocols cannot
    silently diverge in camera model."""
    from sks_tpu.utils.synth import random_rotation

    h, w = shape
    k_mat = jnp.asarray(
        [[focal, 0.0, w / 2.0], [0.0, focal, h / 2.0], [0.0, 0.0, 1.0]],
        jnp.float32,
    )
    r = random_rotation(kr, (), max_angle, jnp.float32)
    t = jax.random.uniform(ks, (3,), jnp.float32, -max_shift, max_shift)
    n = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
    d = jnp.asarray(3.0, jnp.float32)
    h_true = homography_from_pose(k_mat, k_mat, r, t, n, d)
    return k_mat, r, t, n, d, h_true


@partial(jax.jit, static_argnames=("shape", "blur_sigma"))
def planar_pair(key: Array, shape: tuple = (480, 640), focal: float = 600.0,
                max_angle: float = 0.15, max_shift: float = 0.25,
                noise: float = 0.01, texture: Array | None = None,
                blur_sigma: float = 0.0):
    """One HPatches-style planar pair: (img1, img2, H_true 1->2 pixels).

    img1 is a fronto-parallel view of the textured plane; img2 the same plane
    from a perturbed camera (exact plane-induced homography), with independent
    photometric jitter on both views.  ``texture`` optionally supplies the
    plane's pixels (e.g. a real photograph via :func:`photo_texture` — the
    HPatches ``v_*`` viewpoint protocol: one real planar scene, many poses);
    default is the procedural :func:`plane_texture`.  ``blur_sigma`` > 0
    defocus-blurs the second view (hard-protocol nuisance); larger
    ``max_angle``/``max_shift`` give stronger viewpoint/scale change (the z
    component of the shift changes apparent scale by up to
    1/(1 - max_shift/3)).
    """
    if texture is not None:
        # shape is static: a mismatched texture would silently build K for
        # the wrong frame (principal point off-center) — fail at trace time.
        assert tuple(texture.shape[-2:]) == tuple(shape), (
            f"texture shape {texture.shape[-2:]} != requested {shape}"
        )
    kt, kr, ks, kp1, kp2 = jax.random.split(key, 5)
    k_mat, r, t, n, d, h_true = _random_scene(kr, ks, shape, focal,
                                              max_angle, max_shift)
    base = plane_texture(kt, shape) if texture is None else texture
    img1 = photometric_jitter(kp1, base, noise)
    img2 = photometric_jitter(kp2, warp_image(base, h_true), noise)
    if blur_sigma > 0.0:
        img2 = gaussian_blur(img2, blur_sigma)
    return img1, img2, h_true


def _box_params(key: Array, num_boxes: int, shape: tuple, plane_depth: float):
    """Random off-plane box geometry: rects in the canonical view + depths.

    Boxes lie in planes parallel to the main plane but CLOSER to the camera
    (depth in [0.55, 0.8] x plane depth), so their between-view motion is a
    different homography — genuine parallax, not noise.
    """
    h, w = shape
    kx, ky, kw_, kh_, kd = jax.random.split(key, 5)
    bw = jax.random.uniform(kw_, (num_boxes,), jnp.float32, 0.10, 0.22) * w
    bh = jax.random.uniform(kh_, (num_boxes,), jnp.float32, 0.10, 0.22) * h
    x0 = jax.random.uniform(kx, (num_boxes,), jnp.float32, 0.08, 0.70) * w
    y0 = jax.random.uniform(ky, (num_boxes,), jnp.float32, 0.08, 0.70) * h
    depth = jax.random.uniform(kd, (num_boxes,), jnp.float32, 0.55, 0.80) \
        * plane_depth
    return x0, y0, bw, bh, depth


#: Static texel resolution of every box sprite (sampled through the warp, so
#: the on-screen size is the traced rect, not this).
_BOX_TEX = 64


def _composite_boxes(img, box_texs, params, k_mat, r, t, n,
                     shape) -> tuple:
    """Composite off-plane boxes over a rendered view; returns (img, mask).

    Each box lives in a plane parallel to the main one at its own depth; its
    canonical->view homography is the plane-induced one at that depth.  Boxes
    are composited far-to-near (exact occlusion); ``mask`` marks pixels
    covered by any box in THIS view (GT visibility for match classification).
    """
    x0, y0, bw, bh, depth = params
    h, w = shape
    ys = jnp.arange(h, dtype=img.dtype)
    xs = jnp.arange(w, dtype=img.dtype)
    gy, gx = jnp.meshgrid(ys, xs, indexing="ij")
    pix = jnp.stack([gx, gy], axis=-1).reshape(-1, 2)
    mask_any = jnp.zeros((h * w,), bool)

    order = jnp.argsort(-depth)  # far first, near last (near wins overlap)
    for j in range(x0.shape[0]):
        b = order[j]
        h_box = homography_from_pose(k_mat, k_mat, r, t, n, depth[b])
        p_canon = apply_homography(jnp.linalg.inv(h_box), pix)
        u = (p_canon[:, 0] - x0[b]) / bw[b]
        v = (p_canon[:, 1] - y0[b]) / bh[b]
        inside = (u >= 0.0) & (u < 1.0) & (v >= 0.0) & (v < 1.0)
        uv = jnp.stack([u * (_BOX_TEX - 1), v * (_BOX_TEX - 1)], axis=-1)
        tex = box_texs[b]
        vals = bilinear_sample(tex, uv)
        img = jnp.where(inside.reshape(h, w), vals.reshape(h, w), img)
        mask_any = mask_any | inside
    return img, mask_any.reshape(h, w)


@partial(jax.jit, static_argnames=("shape", "blur_sigma", "num_boxes"))
def planar_pair_boxes(key: Array, shape: tuple = (480, 640),
                      focal: float = 600.0, max_angle: float = 0.15,
                      max_shift: float = 0.25, noise: float = 0.01,
                      texture: Array | None = None, blur_sigma: float = 0.0,
                      num_boxes: int = 4):
    """A planar pair with off-plane structure: the parallax protocol.

    Like :func:`planar_pair`, plus ``num_boxes`` textured rectangles floating
    in planes CLOSER to the camera than the main plane (the
    reference's wall fixture is a real 3-D scene whose off-plane matches
    are *in* the data, ``orig_pts_wall.txt``).  Matches on a box surface are
    consistent with that box's own plane-induced homography, NOT the main
    plane's — *structured* outliers that form coherent alternative models,
    the failure mode i.i.d.-outlier RANSAC confidence bounds ignore.

    Returns (img1, img2, h_true, mask1, mask2): ``h_true`` is the MAIN
    plane's homography (the model a planar fit should recover); ``mask1/2``
    are exact per-view box-coverage masks (GT visibility) so callers can
    classify matches as on-plane vs off-plane.
    """
    if texture is not None:
        assert tuple(texture.shape[-2:]) == tuple(shape), (
            f"texture shape {texture.shape[-2:]} != requested {shape}"
        )
    kt, kr, ks, kp1, kp2, kbx, kbt = jax.random.split(key, 7)
    k_mat, r, t, n, d, h_true = _random_scene(kr, ks, shape, focal,
                                              max_angle, max_shift)
    base = plane_texture(kt, shape) if texture is None else texture

    params = _box_params(kbx, num_boxes, shape, 3.0)
    # Box textures: same generator statistics as the plane (corner-rich).
    box_texs = jax.vmap(
        lambda k: plane_texture(k, (_BOX_TEX, _BOX_TEX), octaves=3)
    )(jax.random.split(kbt, num_boxes))

    eye = jnp.eye(3, dtype=jnp.float32)
    zero = jnp.zeros((3,), jnp.float32)
    v1, mask1 = _composite_boxes(base, box_texs, params, k_mat, eye, zero,
                                 n, shape)
    v2_plane = warp_image(base, h_true)
    v2, mask2 = _composite_boxes(v2_plane, box_texs, params, k_mat, r, t,
                                 n, shape)
    img1 = photometric_jitter(kp1, v1, noise)
    img2 = photometric_jitter(kp2, v2, noise)
    if blur_sigma > 0.0:
        img2 = gaussian_blur(img2, blur_sigma)
    return img1, img2, h_true, mask1, mask2


@partial(jax.jit, static_argnames=("shape", "num_frames", "loop"))
def planar_sequence(key: Array, num_frames: int = 16,
                    shape: tuple = (240, 320), focal: float = 300.0,
                    noise: float = 0.005, texture: Array | None = None,
                    loop: bool = False):
    """A camera orbiting over a textured plane: frames + GT poses.

    Smooth trajectory (lateral sweep with gentle yaw); every frame is a
    render of the same plane texture under the exact pose-induced
    homography.  ``texture`` optionally supplies the plane pixels (e.g. a
    real photograph) like :func:`planar_pair`.  ``loop=True`` closes the
    trajectory (the camera returns toward its start pose) so frame 0 and
    frame T-1 overlap — the protocol for loop-closure experiments.  Returns
    (frames (T, H, W), poses_gt (T, 4, 4) cam->world, k_mat (3, 3)) with the
    plane at z = d in frame 0 (d = 3).
    """
    from sks_tpu.utils.synth import random_rotation

    if texture is not None:
        assert tuple(texture.shape[-2:]) == tuple(shape), (
            f"texture shape {texture.shape[-2:]} != requested {shape}"
        )
    kt, kp, kn0 = jax.random.split(key, 3)
    h, w = shape
    k_mat = jnp.asarray(
        [[focal, 0.0, w / 2.0], [0.0, focal, h / 2.0], [0.0, 0.0, 1.0]],
        jnp.float32,
    )
    d = jnp.asarray(3.0, jnp.float32)
    n = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
    base = plane_texture(kt, shape) if texture is None else texture

    ts = jnp.arange(num_frames, dtype=jnp.float32) / max(num_frames - 1, 1)
    if loop:
        # Closed circuit: sinusoidal out-and-back in x, a figure-ready y
        # bulge, no net push-in; the final pose nearly coincides with the
        # start (genuine loop-closure geometry).
        tx = 0.5 * jnp.sin(ts * 2 * jnp.pi)
        ty = 0.25 * (1.0 - jnp.cos(ts * 2 * jnp.pi))
        tz = 0.08 * jnp.sin(ts * 2 * jnp.pi)
        yaw = 0.10 * jnp.sin(ts * 2 * jnp.pi)
        roll = 0.05 * jnp.sin(ts * 2 * jnp.pi)
    else:
        # Lateral sweep + slight push-in + gentle yaw/roll ramp.
        tx = 0.8 * ts
        ty = 0.2 * jnp.sin(ts * jnp.pi)
        tz = 0.15 * ts
        yaw = 0.12 * ts
        roll = 0.06 * jnp.sin(ts * 2 * jnp.pi)

    def rot(yaw_i, roll_i):
        cy, sy = jnp.cos(yaw_i), jnp.sin(yaw_i)
        cr, sr = jnp.cos(roll_i), jnp.sin(roll_i)
        ry = jnp.asarray([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], jnp.float32)
        rz = jnp.asarray([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]], jnp.float32)
        return ry @ rz

    def frame(i):
        r = rot(yaw[i], roll[i])
        t = jnp.stack([tx[i], ty[i], tz[i]])
        # World (= frame-0 camera) -> camera i: X_c = R X_w + t.
        h_i = homography_from_pose(k_mat, k_mat, r, t, n, d)
        img = warp_image(base, h_i)
        img = photometric_jitter(jax.random.fold_in(kn0, i), img, noise)
        top = jnp.concatenate([r, t[:, None]], axis=-1)
        g = jnp.concatenate(
            [top, jnp.asarray([[0.0, 0.0, 0.0, 1.0]], jnp.float32)], axis=0
        )
        return img, g

    frames, g_w2c = jax.vmap(frame)(jnp.arange(num_frames))
    # cam->world poses for ATE: inverse of world->cam.
    r = g_w2c[:, :3, :3]
    t = g_w2c[:, :3, 3]
    rt = jnp.swapaxes(r, -1, -2)
    ti = -jnp.einsum("...ij,...j->...i", rt, t, precision="highest")
    top = jnp.concatenate([rt, ti[..., None]], axis=-1)
    bot = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32), (num_frames, 1, 4)
    )
    poses = jnp.concatenate([top, bot], axis=-2)
    return frames, poses, k_mat
