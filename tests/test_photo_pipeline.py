"""Real-photograph pipeline: a genuine photo's pixels through the full stack.

The reference grounds its harnesses in one real wall photo's SIFT matches
(``CPU_Runtime Test/orig_pts_wall.txt``; sampled by ``main.cpp:21-30``).
Here a real photograph bundled with the local environment (matplotlib's
``grace_hopper.jpg``) is the planar scene: rendered under exact homographies
(HPatches ``v_*`` viewpoint protocol), matched from pixels, robust-fit, and
scored against exact GT — the real-image grounding the wall scene provides,
plus the ground truth it lacks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sks_tpu.data.images import photo_texture, planar_pair


def test_photo_texture_loads():
    tex = photo_texture((120, 160))
    if tex is None:
        pytest.skip("no bundled photograph in this environment")
    assert tex.shape == (120, 160)
    assert float(tex.min()) >= 0.0 and float(tex.max()) <= 1.0
    # A photograph, not a constant: meaningful dynamic range.
    assert float(tex.max() - tex.min()) > 0.5


@pytest.mark.slow
def test_photo_pair_parity_vs_cv2():
    cv2 = pytest.importorskip("cv2")
    from sks_tpu.bench.real_pipeline import pair_parity

    rows = pair_parity(0, 2, shape=(240, 320), texture="photo")
    scored = [r for r in rows if "skipped" not in r]
    assert len(scored) == 2
    for r in scored:
        assert r["matches"] >= 50  # real-photo pixels produce real matches
        assert r["inlier_agreement"] >= 0.95  # cv2 parity on the same matches
        # Accuracy gate (round-2 regression: a 10.6 px corner error passed
        # silently while inlier agreement stayed 99%): the fitted model must
        # be within 2.5x of cv2's corner error AND under an absolute ceiling.
        assert r["corner_err_ours_px"] <= max(
            2.5 * r["corner_err_cv2_px"], 1.5
        ), r


@pytest.mark.slow
def test_photo_pair_parity_vs_cv2_hard():
    """Hard-protocol accuracy gate (an earlier gate covered only 2 easy
    pairs while the hard protocol's worst pair sat at 2x cv2 ungated).  With sub-pixel Harris the hard protocol now beats cv2
    (bench_results/REAL_PHOTO.md); this pins it from regressing."""
    cv2 = pytest.importorskip("cv2")
    from sks_tpu.bench.real_pipeline import pair_parity

    # Full protocol resolution: at 240x320 the hard nuisances (blur +
    # strong viewpoint) leave too few well-localized matches and BOTH
    # fitters degrade (cv2 itself at 14 px on one pair) — the gate is
    # about OUR fit vs cv2 on a working pair, not about tiny-image limits.
    rows = pair_parity(0, 3, shape=(480, 640), texture="photo",
                       protocol="hard")
    scored = [r for r in rows if "skipped" not in r]
    assert len(scored) >= 2
    for r in scored:
        assert r["matches"] >= 40
        # No hard pair may exceed 2x cv2's corner error (nor a 4 px ceiling).
        assert r["corner_err_ours_px"] <= max(
            2.0 * r["corner_err_cv2_px"], 1.5
        ), r
        assert r["corner_err_ours_px"] <= 4.0, r
    mean_ours = np.mean([r["corner_err_ours_px"] for r in scored])
    mean_cv2 = np.mean([r["corner_err_cv2_px"] for r in scored])
    # The headline claim: hard-protocol mean at-or-below cv2 (small slack for
    # the reduced 3-pair gate sample).
    assert mean_ours <= 1.2 * mean_cv2, (mean_ours, mean_cv2)


def test_available_photos_lists_bundled():
    from sks_tpu.data.images import available_photos

    names = available_photos()
    if not names:
        pytest.skip("no bundled photographs in this environment")
    # The three-texture protocol needs at least two distinct scenes here.
    assert "hopper" in names


def test_photo_pair_recovers_gt():
    """Image-derived matches on the photo recover the exact GT homography."""
    tex = photo_texture((240, 320))
    if tex is None:
        pytest.skip("no bundled photograph in this environment")
    from sks_tpu.features.matching import match_frames_oriented
    from sks_tpu.geom.homography import apply_homography
    from sks_tpu.robust import find_homography

    key = jax.random.PRNGKey(1)
    img1, img2, h_true = planar_pair(key, (240, 320), texture=tex)
    p1, p2, valid, _ = match_frames_oriented(img1, img2, 512, 3)
    v = np.asarray(valid)
    a, b = np.asarray(p1)[v], np.asarray(p2)[v]
    assert a.shape[0] >= 30
    h, mask = find_homography(jnp.asarray(a), jnp.asarray(b),
                              ransac_reproj_threshold=3.0, max_iters=1024,
                              key=jax.random.fold_in(key, 9))
    assert int(np.asarray(mask).sum()) >= 20
    # Transfer error at the *matched* inliers (interpolation region) vs GT.
    pts = jnp.asarray(a)[np.asarray(mask)]
    d = apply_homography(h, pts) - apply_homography(h_true, pts)
    err = float(jnp.median(jnp.linalg.norm(d, axis=-1)))
    assert err < 1.5, err


@pytest.mark.slow
def test_parallax_protocol_gate():
    """Parallax regression gate: off-plane structured
    outliers must NEVER leak into the inlier set, and overall corner error
    stays at-or-below cv2's on the same matches (PARALLAX.json pinned)."""
    cv2 = pytest.importorskip("cv2")
    from sks_tpu.bench.real_pipeline import pair_parity

    rows = pair_parity(0, 3, shape=(480, 640), texture="photo",
                       protocol="parallax")
    scored = [r for r in rows if "skipped" not in r]
    assert len(scored) >= 2
    for r in scored:
        # Zero off-plane inlier leak — the planar fit must reject every
        # match on the off-plane boxes (the round-4 headline).
        assert r["offplane_inlier_leak_ours"] == 0, r
        assert r["offplane_match_frac"] > 0.02, r  # protocol is non-trivial
    mean_ours = np.mean([r["corner_err_ours_px"] for r in scored])
    mean_cv2 = np.mean([r["corner_err_cv2_px"] for r in scored])
    # Overall at-or-below cv2 (small slack for the 3-pair gate sample).
    assert mean_ours <= 1.2 * mean_cv2, (mean_ours, mean_cv2)


@pytest.mark.slow
@pytest.mark.parametrize("texture", ["china", "hopper", "flower"])
def test_guarded_esm_never_degrades_vo(texture):
    """The dense-polish default-on contract: on every
    bundled photo texture, guarded symmetric ESM polish must IMPROVE (or at
    worst match) the feature-only VO ATE.  The round-4 half-frame
    one-direction polish violated this on china (1.06 -> 1.91 % of path);
    the round-5 symmetric full-frame polish measures 0.66/0.45/1.00 vs
    1.06/2.22/3.15 feature-only."""
    from sks_tpu.bench.real_pipeline import sequence_ate

    if photo_texture((64, 64), name=texture) is None:
        pytest.skip(f"bundled photograph {texture!r} unavailable")
    base = sequence_ate(0, 12, texture=texture, esm_iters=0)
    esm = sequence_ate(0, 12, texture=texture, esm_iters=8)
    # 5% slack absorbs cross-platform float noise; the measured margins are
    # 1.6x-5x, far outside it.
    assert esm["ate_rmse"] <= 1.05 * base["ate_rmse"], (texture, base, esm)
