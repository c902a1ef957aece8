"""Direct ESM homography tracking on SL(3) (slam/tracking.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sks_tpu.geom.homography import apply_homography, homography_from_pose
from sks_tpu.slam.tracking import esm_track, esm_track_pyramid


def _scene(key, shape=(120, 160)):
    from sks_tpu.data.images import plane_texture, warp_image
    from sks_tpu.utils.synth import random_rotation

    base = plane_texture(key, shape)
    k_mat = jnp.asarray(
        [[150.0, 0.0, 80.0], [0.0, 150.0, 60.0], [0.0, 0.0, 1.0]]
    )
    r = random_rotation(jax.random.fold_in(key, 1), (), 0.12, jnp.float32)
    t = jnp.asarray([0.15, -0.1, 0.08], jnp.float32)
    h_true = homography_from_pose(
        k_mat, k_mat, r, t, jnp.asarray([0.0, 0.0, 1.0]), jnp.asarray(3.0)
    )
    return base, warp_image(base, h_true), h_true


def _max_corner_err(h, h_true, corners):
    d = apply_homography(h, corners) - apply_homography(h_true, corners)
    return float(jnp.max(jnp.linalg.norm(d, axis=-1)))


def test_esm_subpixel_on_pure_warp(key):
    """From identity (~20 px motion), ESM reaches sub-pixel on a pure warp."""
    base, img2, h_true = _scene(key)
    oy, ox = 28, 32
    tpl = base[oy:oy + 64, ox:ox + 96]
    origin = jnp.asarray([float(ox), float(oy)])
    corners = jnp.asarray(
        [[ox, oy], [ox + 96, oy], [ox, oy + 64], [ox + 96, oy + 64]],
        jnp.float32,
    )
    assert _max_corner_err(jnp.eye(3), h_true, corners) > 10.0  # real motion
    h, rms = esm_track(tpl, img2, jnp.eye(3), origin=origin, iters=120)
    assert _max_corner_err(h, h_true, corners) < 0.5
    assert float(rms) < 0.03


@pytest.mark.slow
def test_esm_pyramid_with_photometric_nuisances(key):
    """Coarse-to-fine ESM under independent gain/bias/gamma + noise.

    The gain/bias compensation is a linear fit to a gamma curve, so a
    few-px bias remains — the tracker's role here is a dense motion prior /
    RANSAC polish, which this bound reflects.
    """
    from sks_tpu.data.images import planar_pair

    img1, img2, h_true = planar_pair(
        key, (120, 160), noise=0.003, focal=150.0, max_angle=0.1,
        max_shift=0.15,
    )
    h, rms = esm_track_pyramid(img1, img2, jnp.eye(3), levels=3, iters=60)
    corners = jnp.asarray(
        [[10.0, 10.0], [150.0, 10.0], [10.0, 110.0], [150.0, 110.0]]
    )
    assert _max_corner_err(h, h_true, corners) < 4.0
    assert float(rms) < 0.06


def test_esm_batched_vmap(key):
    """Multi-template tracking is one vmapped call (fixed shapes).

    Small patches track frame-to-frame from the previous estimate (here a
    few-px perturbation of GT) — the multi-patch production shape; the
    wide-basin case is the pyramid test above.
    """
    base, img2, h_true = _scene(key)
    tpls = jnp.stack([base[20:52, 30:78], base[60:92, 70:118]])
    origins = jnp.asarray([[30.0, 20.0], [70.0, 60.0]])
    h_prev = jnp.asarray(h_true, jnp.float32) @ jnp.asarray(
        [[1.0, 0.0, 2.0], [0.0, 1.0, -1.5], [0.0, 0.0, 1.0]], jnp.float32
    )
    h0 = jnp.broadcast_to(h_prev, (2, 3, 3))
    # 6-DOF affine: a 48x32 patch cannot constrain the projective params.
    hs, rms = jax.vmap(
        lambda t, o, h: esm_track(t, img2, h, origin=o, iters=80, dof=6)
    )(tpls, origins, h0)
    assert hs.shape == (2, 3, 3)
    for i, (ox, oy, w, hgt) in enumerate([(30, 20, 48, 32), (70, 60, 48, 32)]):
        corners = jnp.asarray(
            [[ox, oy], [ox + w, oy], [ox, oy + hgt], [ox + w, oy + hgt]],
            jnp.float32,
        )
        assert _max_corner_err(hs[i], h_true, corners) < 2.0, i  # content-limited


def test_esm_matmul_sampler_matches_gather():
    """The one-hot matmul sampling path must agree with the gather path
    (identical bilinear weights; float summation order differs)."""
    import numpy as np

    from sks_tpu.slam.tracking import esm_track

    rng = np.random.RandomState(0)
    img = jnp.asarray(
        np.cumsum(np.cumsum(rng.rand(96, 128), 0), 1) / 1000, jnp.float32
    )
    tpl = img[20:52, 30:78]
    h0 = jnp.asarray(
        [[1.0, 0.0, 31.5], [0.0, 1.0, 18.9], [0.0, 0.0, 1.0]], jnp.float32
    )
    hg, rg = esm_track(tpl, img, h0, iters=12, sampler="gather")
    hm, rm = esm_track(tpl, img, h0, iters=12, sampler="matmul")
    assert float(jnp.max(jnp.abs(hg - hm))) < 5e-3
    assert abs(float(rg) - float(rm)) < 1e-4
    # Both recover the true (30, 20) translation.
    for h in (hg, hm):
        assert abs(float(h[0, 2]) - 30.0) < 0.1
        assert abs(float(h[1, 2]) - 20.0) < 0.1


def test_esm_auto_sampler_is_gather():
    """esm_track's default sampler='auto' runs the gather arm, bit for bit."""
    import numpy as np

    from sks_tpu.slam.tracking import esm_track

    rng = np.random.RandomState(1)
    img = jnp.asarray(
        np.cumsum(np.cumsum(rng.rand(64, 80), 0), 1) / 1000, jnp.float32
    )
    tpl = img[16:40, 20:52]
    h0 = jnp.asarray(
        [[1.0, 0.0, 20.5], [0.0, 1.0, 15.6], [0.0, 0.0, 1.0]], jnp.float32
    )
    ha, ra = esm_track(tpl, img, h0, iters=4)
    hg, rg = esm_track(tpl, img, h0, iters=4, sampler="gather")
    assert np.array_equal(np.asarray(ha), np.asarray(hg))
    assert float(ra) == float(rg)
