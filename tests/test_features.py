"""Feature pipeline: detection localizes corners; matching survives warps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sks_tpu.features import detect_corners, match_frames, patch_descriptors
from sks_tpu.features.matching import match_descriptors


def _checker(size=128, cell=16, dtype=jnp.float32):
    ys, xs = jnp.meshgrid(jnp.arange(size), jnp.arange(size), indexing="ij")
    return (((ys // cell) + (xs // cell)) % 2).astype(dtype)


def test_detect_corners_on_checkerboard():
    img = _checker()
    xy, score, valid = detect_corners(img, num_corners=64, border=8)
    k = int(valid.sum())
    assert k >= 20, k
    # Valid detections lie near cell intersections (multiples of 16).
    pts = np.asarray(xy)[np.asarray(valid)]
    off = np.minimum(pts % 16, 16 - (pts % 16)).max(axis=-1)
    assert np.median(off) <= 2.0, np.median(off)


def test_descriptors_match_under_shift():
    key = jax.random.PRNGKey(0)
    big = jax.random.uniform(key, (160, 160), jnp.float32)
    img1 = big[:128, :128]
    img2 = big[7:135, 11:139]  # pure translation (dx=11, dy=7 in img1 coords)
    pts1, pts2, valid = match_frames(img1, img2, num_corners=128)
    assert int(valid.sum()) > 20
    d = np.asarray(pts1 - pts2)[np.asarray(valid)]
    # Matches should consistently recover the translation.
    med = np.median(d, axis=0)
    assert np.allclose(med, [11.0, 7.0], atol=1.0), med


def test_match_descriptors_identity():
    key = jax.random.PRNGKey(1)
    d = jax.random.normal(key, (64, 32), jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    idx, valid = match_descriptors(d, d, ratio=0.95)
    assert np.array_equal(np.asarray(idx), np.arange(64))
    assert bool(valid.all())


def test_end_to_end_homography_from_images():
    """detect+match feeds RANSAC: recover a known translation homography."""
    from sks_tpu.robust import RansacConfig, ransac_homography

    key = jax.random.PRNGKey(2)
    big = jax.random.uniform(key, (200, 200), jnp.float32)
    img1 = big[:128, :128]
    img2 = big[5:133, 9:137]
    pts1, pts2, valid = match_frames(img1, img2, num_corners=256)
    config = RansacConfig(num_hypotheses=256, threshold=2.0, refine_iters=1)
    res = ransac_homography(key, pts1, pts2, config, point_mask=valid)
    h = np.asarray(res.h)
    assert abs(h[0, 2] - (-9.0)) < 0.5, h  # x' = x - 9
    assert abs(h[1, 2] - (-5.0)) < 0.5, h
    assert abs(h[0, 0] - 1.0) < 0.01


@pytest.mark.slow
@pytest.mark.parametrize("orientation", ["centroid", "gradient"])
def test_oriented_descriptors_rotation_invariant(orientation):
    """Oriented descriptors of a rotated view match the unrotated ones;
    axis-aligned descriptors do not .
    Covers both the ORB intensity-centroid and the cheap smoothed-gradient
    reference orientation (the round-4 pipeline default)."""
    from sks_tpu.data.images import plane_texture, warp_image
    from sks_tpu.features.descriptors import oriented_patch_descriptors

    img = plane_texture(jax.random.PRNGKey(3), (192, 192))
    ang = 0.6  # ~34 degrees of camera roll
    c, s = float(jnp.cos(ang)), float(jnp.sin(ang))
    cx = cy = 96.0
    h_rot = jnp.asarray(
        [[c, -s, cx - c * cx + s * cy],
         [s, c, cy - s * cx - c * cy],
         [0.0, 0.0, 1.0]], jnp.float32)
    img2 = warp_image(img, h_rot)

    xy1, _, v1 = detect_corners(img, 128, border=32)
    from sks_tpu.geom.homography import apply_homography
    xy2 = apply_homography(h_rot, xy1)  # same physical points, rotated view

    d1o, _ = oriented_patch_descriptors(img, xy1, orientation=orientation)
    d2o, _ = oriented_patch_descriptors(img2, xy2, orientation=orientation)
    sim_oriented = jnp.sum(d1o * d2o, axis=-1)

    d1a = patch_descriptors(img, xy1)
    d2a = patch_descriptors(img2, xy2)
    sim_axis = jnp.sum(d1a * d2a, axis=-1)

    med_o = float(jnp.median(sim_oriented[v1]))
    med_a = float(jnp.median(sim_axis[v1]))
    assert med_o > 0.8, (med_o, med_a)
    assert med_o > med_a + 0.15, (med_o, med_a)


def test_pyramid_detects_coarse_corners():
    """2x-magnified structure is found at octave 1 with scale annotation."""
    from sks_tpu.features.harris import detect_corners_pyramid

    img = _checker(256, cell=64)  # huge cells: corners live at coarse scale
    xy, score, valid, scale = detect_corners_pyramid(img, 64, num_octaves=3,
                                                     border=8)
    assert int(valid.sum()) >= 9
    assert float(scale[valid].max()) >= 2.0  # some picked beyond octave 0


@pytest.mark.slow
def test_planar_pair_end_to_end_ransac():
    """Rendered pair -> oriented matches -> RANSAC recovers the GT H."""
    from sks_tpu.data.images import planar_pair
    from sks_tpu.features.matching import match_frames_oriented
    from sks_tpu.geom.homography import apply_homography
    from sks_tpu.robust import find_homography

    img1, img2, h_true = planar_pair(jax.random.PRNGKey(11), (240, 320))
    p1, p2, valid, _ = match_frames_oriented(img1, img2, 384, 3)
    a = jnp.asarray(np.asarray(p1)[np.asarray(valid)])
    b = jnp.asarray(np.asarray(p2)[np.asarray(valid)])
    assert a.shape[0] >= 30, a.shape
    h, mask = find_homography(a, b, ransac_reproj_threshold=3.0,
                              max_iters=1024)
    corners = jnp.asarray([[0.0, 0.0], [320.0, 0.0], [0.0, 240.0],
                           [320.0, 240.0]])
    err = float(jnp.max(jnp.linalg.norm(
        apply_homography(h, corners) - apply_homography(h_true, corners),
        axis=-1)))
    assert err < 3.0, err


def test_subpixel_refinement_accuracy():
    """Sub-pixel Harris: blobs at known non-integer
    centers are localized ~5-7x better than the integer grid allows."""
    from sks_tpu.features.harris import detect_corners

    rng = np.random.RandomState(0)
    H, W = 128, 128
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.zeros((H, W), np.float32)
    centers = []
    for gy in range(3, 12, 3):
        for gx in range(3, 12, 3):
            cy = gy * 10 + rng.uniform(-0.5, 0.5)
            cx = gx * 10 + rng.uniform(-0.5, 0.5)
            centers.append((cx, cy))
            img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 2.0**2))
    img = jnp.asarray(img)

    def mean_err(subpixel):
        xy, _, va = detect_corners(img, 16, border=8, subpixel=subpixel)
        xy = np.asarray(xy)[np.asarray(va)]
        errs = []
        for cx, cy in centers:
            d = np.sqrt((xy[:, 0] - cx) ** 2 + (xy[:, 1] - cy) ** 2)
            if d.min() < 2:
                errs.append(d.min())
        assert len(errs) == len(centers)
        return float(np.mean(errs))

    e_int, e_sub = mean_err(False), mean_err(True)
    assert e_sub < 0.15, e_sub
    assert e_sub < 0.5 * e_int, (e_sub, e_int)


def test_subpixel_shift_equivariance():
    """A 0.5-px image translation moves refined corners by ~0.5 px."""
    from sks_tpu.features.harris import detect_corners

    rng = np.random.RandomState(1)
    base = rng.rand(80, 80).astype(np.float32)
    # Band-limit so bilinear shifting is faithful.
    from sks_tpu.features.harris import _gauss_taps, _sep_filter

    g = _gauss_taps(2.0, 5)
    img = np.asarray(_sep_filter(jnp.asarray(base), g, g))
    dx = 0.5
    xs = np.arange(80) - dx
    x0 = np.floor(xs).astype(int) % 80
    f = xs - np.floor(xs)
    shifted = img[:, x0] * (1 - f) + img[:, (x0 + 1) % 80] * f
    xy1, _, v1 = detect_corners(jnp.asarray(img), 12, border=10)
    xy2, _, v2 = detect_corners(jnp.asarray(shifted.astype(np.float32)), 12,
                                border=10)
    a = np.asarray(xy1)[np.asarray(v1)]
    b = np.asarray(xy2)[np.asarray(v2)]
    shifts = []
    for p in a:
        d = np.linalg.norm(b - p, axis=1)
        j = d.argmin()
        if d[j] < 1.5:
            shifts.append(b[j, 0] - p[0])
    assert len(shifts) >= 5
    # Median detected shift within 0.15 px of the true 0.5.
    assert abs(float(np.median(shifts)) - dx) < 0.15, np.median(shifts)


@pytest.mark.parametrize("which", ["patch", "oriented"])
def test_auto_sampler_is_gather(which):
    """sampler='auto' is the gather arm on every backend, bit for bit."""
    from sks_tpu.features.descriptors import oriented_patch_descriptors

    img = jax.random.uniform(jax.random.PRNGKey(1), (64, 80), jnp.float32)
    xy = jax.random.uniform(jax.random.PRNGKey(2), (24, 2), jnp.float32,
                            12.0, 52.0)
    if which == "patch":
        auto = patch_descriptors(img, xy)
        gather = patch_descriptors(img, xy, sampler="gather")
    else:
        auto = oriented_patch_descriptors(img, xy)[0]
        gather = oriented_patch_descriptors(img, xy, sampler="gather")[0]
    assert np.array_equal(np.asarray(auto), np.asarray(gather))
