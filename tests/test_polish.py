"""Direct tests for robust/polish.py.

The annealed-threshold LM polish flipped the headline real-photo benchmark
but was previously exercised only implicitly through RANSAC — these tests pin
its contract directly: (a) annealing beats single-level LM on clustered
matches with heteroscedastic localization error, (b) the >=8-point /
>=25%-mass gate skips collapsing levels, (c) polish never degrades an exact
model, (d) the LMedS branch (gn_refine_h on the robust-sigma consensus).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sks_tpu.geom.homography import apply_homography
from sks_tpu.robust import RansacConfig, ransac_homography
from sks_tpu.robust.polish import anneal_polish, gn_refine_h
from sks_tpu.utils.synth import random_plane_homographies


def _corner_err(h, h_true, shape=(480, 640)):
    hh, ww = shape
    corners = jnp.asarray(
        [[0.0, 0.0], [ww, 0.0], [0.0, hh], [ww, hh]], jnp.float32
    )
    d = apply_homography(h, corners) - apply_homography(h_true, corners)
    return float(jnp.max(jnp.linalg.norm(d, axis=-1)))


def _clustered(key, n=120, frac_bad=0.3, drift=2.5, good_noise=0.05):
    """Clustered matches: 70% sub-pixel localized, 30% with a fixed ~2.5 px
    localization error in a random direction (edge drift / repeated texture
    — the structured, non-Gaussian error real corner detectors produce).

    The regime anneal_polish exists for: extrapolation to the image corners
    is controlled by which points dominate the fit, and the tighter levels
    can separate the sub-pixel points from the drifted ones.
    """
    k1, k2, k3, k4 = jax.random.split(key, 4)
    h_true = random_plane_homographies(k1, (), dtype=jnp.float32)
    # Cluster: a 200x150 box well inside the 640x480 frame.
    src = jax.random.uniform(k2, (n, 2), jnp.float32) \
        * jnp.asarray([200.0, 150.0], jnp.float32) \
        + jnp.asarray([220.0, 160.0], jnp.float32)
    tar = apply_homography(h_true, src)
    nb = int(n * frac_bad)
    ang = jax.random.uniform(k3, (n,), jnp.float32, 0.0, 2 * jnp.pi)
    off = drift * jnp.stack([jnp.cos(ang), jnp.sin(ang)], -1)
    noise = jax.random.normal(k4, (n, 2), jnp.float32) * good_noise
    tar = tar + noise + jnp.where(jnp.arange(n)[:, None] < nb, off, 0.0)
    return src, tar, h_true


def _perturbed(h_true, key, scale=1.0):
    """Perturb H so induced reprojection shifts are ~scale px (entry scales
    matched to pixel coordinates: a 1e-3 bump on h20 alone moves projections
    by hundreds of px)."""
    mags = jnp.asarray(
        [[1e-3, 1e-3, 0.5], [1e-3, 1e-3, 0.5], [2e-6, 2e-6, 0.0]],
        jnp.float32,
    ) * scale
    d = jax.random.normal(key, (3, 3), jnp.float32) * mags
    return h_true / h_true[2, 2] + d


def test_anneal_beats_single_level_on_clustered():
    """(a) Annealing concentrates the fit on well-localized matches and wins
    the corner-extrapolation comparison against one full-threshold LM level
    (median over seeds — per-seed noise can favor either)."""
    wins, ratios = 0, []
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        src, tar, h_true = _clustered(key)
        h0 = _perturbed(h_true, jax.random.fold_in(key, 9), scale=0.3)
        h_ann = anneal_polish(h0, src, tar, 3.0, levels=(1.0, 0.7, 0.5))
        h_one = anneal_polish(h0, src, tar, 3.0, levels=(1.0,))
        e_ann = _corner_err(h_ann, h_true)
        e_one = _corner_err(h_one, h_true)
        ratios.append(e_ann / max(e_one, 1e-9))
        wins += e_ann <= e_one
    assert wins >= 6, (wins, ratios)
    assert float(np.median(ratios)) < 0.85, ratios


def test_mass_gate_skips_collapsing_levels(key):
    """(b) Levels whose consensus falls under the >=8-point / >=25%-mass
    guards are skipped, branch-free."""
    k2, k3 = jax.random.split(key)
    # Near-identity homography: symmetric residual ~ 2 * (injected noise)^2,
    # so the level gates land exactly where the noise bands are designed.
    h_true = jnp.asarray(
        [[1.02, 0.01, 5.0], [-0.01, 0.98, -3.0], [1e-5, -1e-5, 1.0]],
        jnp.float32,
    )
    n, thr = 70, 3.0
    src = jax.random.uniform(k2, (n, 2), jnp.float32) * 400.0 + 100.0
    tar = apply_homography(h_true, src)
    # 60 points with residual in (0.9, 0.98) * thr: inside the level-1.0
    # consensus, well outside the 0.7/0.5 gates.  10 exact points: they pass
    # every gate but are only 10/70 = 14% of the level-1.0 mass < 25% -- the
    # mass guard must skip the tight levels.
    mag = jax.random.uniform(k3, (n,), jnp.float32, 0.9 * thr, 0.98 * thr)
    mag = jnp.where(jnp.arange(n) < 10, 0.0, mag)
    ang = jax.random.uniform(jax.random.fold_in(k3, 1), (n,), jnp.float32,
                             0.0, 2 * jnp.pi)
    tar = tar + mag[:, None] * jnp.stack([jnp.cos(ang), jnp.sin(ang)], -1)
    h_full = anneal_polish(h_true, src, tar, thr, levels=(1.0, 0.7, 0.5))
    h_one = anneal_polish(h_true, src, tar, thr, levels=(1.0,))
    assert np.allclose(np.asarray(h_full), np.asarray(h_one)), (
        "tight levels under the 25%-mass guard must be skipped"
    )
    # <8 points at the FIRST level: every level is skipped and the model
    # passes through bit-unchanged.
    h6 = anneal_polish(h_true, src[:6], tar[:6], thr)
    assert np.array_equal(np.asarray(h6), np.asarray(h_true))


def test_polish_never_degrades_exact(key):
    """(c) On exact correspondences the polish keeps (or recovers) the model
    to numerical precision."""
    k1, k2 = jax.random.split(key)
    h_true = random_plane_homographies(k1, (), dtype=jnp.float32)
    src = jax.random.uniform(k2, (64, 2), jnp.float32) * 500.0 + 50.0
    tar = apply_homography(h_true, src)
    h = anneal_polish(h_true / h_true[2, 2], src, tar, 3.0)
    assert _corner_err(h, h_true) < 1e-2
    # And from a perturbed start it converges back to the truth.
    h0 = _perturbed(h_true, jax.random.fold_in(key, 3), scale=0.2)
    h = anneal_polish(h0, src, tar, 3.0)
    assert _corner_err(h, h_true) < _corner_err(h0, h_true)
    assert _corner_err(h, h_true) < 0.05


def test_gn_refine_respects_zero_weights(key):
    """gn_refine_h must ignore zero-weight (outlier/padded) points."""
    k1, k2, k3 = jax.random.split(key, 3)
    h_true = random_plane_homographies(k1, (), dtype=jnp.float32)
    src = jax.random.uniform(k2, (64, 2), jnp.float32) * 500.0 + 50.0
    tar = apply_homography(h_true, src)
    # Corrupt 16 points wildly; give them weight 0.
    tar = tar.at[:16].add(jax.random.normal(k3, (16, 2), jnp.float32) * 200.0)
    w = jnp.where(jnp.arange(64) < 16, 0.0, 1.0)
    h0 = _perturbed(h_true, jax.random.fold_in(key, 5))
    h = gn_refine_h(h0, src, tar, w)
    assert _corner_err(h, h_true) < 0.05, _corner_err(h, h_true)


@pytest.mark.parametrize("final_polish", [True, False])
def test_lmeds_branch(key, final_polish):
    """(d) The LMedS selection + polish path: threshold-free fit on
    contaminated data recovers the model; the polish branch (gn_refine_h on
    the robust-sigma consensus) runs and does not hurt."""
    k1, k2, k3 = jax.random.split(key, 3)
    h_true = random_plane_homographies(k1, (), dtype=jnp.float32)
    n = 200
    src = jax.random.uniform(k2, (n, 2), jnp.float32) * 500.0 + 50.0
    tar = apply_homography(h_true, src)
    tar = tar + jax.random.normal(k3, (n, 2)) * 0.3
    junk = jax.random.uniform(jax.random.fold_in(k3, 1), (60, 2),
                              jnp.float32, 0.0, 600.0)
    tar = tar.at[:60].set(junk)
    config = RansacConfig(num_hypotheses=1024, scoring="lmeds",
                          final_polish=final_polish)
    res = ransac_homography(key, src, tar, config)
    assert int(res.num_inliers) > 100
    err = _corner_err(res.h, h_true)
    assert err < 3.0, err
