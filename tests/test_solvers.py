"""Solver correctness pyramid (SURVEY.md §4):

1. analytic oracle — exact plane-induced H, solver must recover it up to scale;
2. cross-solver consistency — all 4-point solvers agree on the same inputs;
3. composition invariants — zero reprojection residual on the 4 points;
4. degeneracy masks;
5. dtype polymorphism (f32/f64) with per-dtype tolerances.

Everything runs jitted (see conftest.jit_of) — eager dispatch compiles every
scalar op separately and is orders of magnitude slower.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import jit_of
from sks_tpu.ops import (
    SOLVERS,
    aca,
    aca_h,
    aca_rect,
    aca_valid_mask,
    sks,
    sks_h,
    sks_valid_mask,
    ndlt,
    ho,
)
from sks_tpu.geom.homography import normalize_h, reprojection_error
from sks_tpu.ops.aca_rect import rect_corners
from sks_tpu.utils.synth import random_correspondences, rect_offset_pairs

TOL = {jnp.dtype("float32"): 2e-3, jnp.dtype("float64"): 1e-9}
B = 32

_max_reproj = jit_of(lambda h, s, t: jnp.max(reprojection_error(h, s, t)))
_fro = jit_of(lambda h: normalize_h(h, "fro"))


def h_close(h1, h2, tol):
    """Up-to-scale comparison via Frobenius canonical form."""
    return np.allclose(np.asarray(_fro(h1)), np.asarray(_fro(h2)), atol=tol)


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_oracle_recovery(name, key, dtype, synth):
    """Every solver recovers the exact plane-induced homography up to scale."""
    src, tar, h_true = synth(key, B, 4, 0.0, dtype)
    h_est = jit_of(SOLVERS[name])(src, tar)
    tol = TOL[dtype] * (50 if name in ("ndlt", "ho") else 1)
    assert h_close(h_est, h_true, tol), f"{name} failed oracle"


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_reprojection_residual(name, key, dtype, synth):
    """H maps the 4 source points onto the 4 target points."""
    src, tar, _ = synth(key, B, 4, 0.0, dtype)
    h = jit_of(SOLVERS[name])(src, tar)
    err = float(_max_reproj(h, src, tar))
    # Pixel-scale tolerance; coordinates are O(500).
    lim = 0.05 if dtype == jnp.float32 else 1e-6
    assert err < lim, f"{name} residual {err}"


def test_cross_solver_consistency(key, dtype, synth):
    """All 4-point solvers solve the same exact problem — results must agree."""
    src, tar, _ = synth(key, B, 4, 0.0, dtype)
    hs = {n: _fro(jit_of(f)(src, tar)) for n, f in SOLVERS.items()}
    ref = hs.pop("aca")
    for n, h in hs.items():
        tol = TOL[dtype] * (50 if n in ("ndlt", "ho") else 5)
        assert np.allclose(np.asarray(ref), np.asarray(h), atol=tol), n


def test_up_to_scale_matches_normalized(key, synth):
    src, tar, _ = synth(key, B, 4, 0.0, jnp.float64)
    assert h_close(jit_of(aca_h)(src, tar), jit_of(aca)(src, tar), 1e-9)
    assert h_close(jit_of(sks_h)(src, tar), jit_of(sks)(src, tar), 1e-9)


def test_n_point_solvers(key, dtype, synth):
    """NDLT/HO handle N > 4 (least squares) and recover exact H with N = 12."""
    src, tar, h_true = synth(key, B, 12, 0.0, dtype)
    for f in (ndlt, ho):
        h = jit_of(f)(src, tar)
        assert h_close(h, h_true, TOL[dtype] * 50)


@pytest.mark.slow
def test_n_point_weighted_padding(key, synth):
    """Zero-weight padding gives the same answer as the unpadded problem."""
    dtype = jnp.float64
    src, tar, _ = synth(key, B, 8, 0.0, dtype)
    pad_src = jnp.concatenate([src, jnp.zeros((B, 4, 2), dtype)], axis=1)
    pad_tar = jnp.concatenate([tar, jnp.zeros((B, 4, 2), dtype)], axis=1)
    w = jnp.concatenate([jnp.ones((B, 8), dtype), jnp.zeros((B, 4), dtype)], axis=1)
    for f in (ndlt, ho):
        h_ref = _fro(jit_of(f)(src, tar))
        h_pad = _fro(jit_of(f)(pad_src, pad_tar, w))
        assert np.allclose(np.asarray(h_ref), np.asarray(h_pad), atol=1e-8)


@pytest.mark.slow
def test_noise_least_squares_beats_minimal(key, synth):
    """With noise and N=16, the LS solvers should beat a minimal 4-pt solve."""
    dtype = jnp.float64
    src, tar, h_true = synth(key, B, 16, 1.0, dtype)
    h_ls = jit_of(ndlt)(src, tar)
    h_min = jit_of(aca)(src[:, :4], tar[:, :4])
    e_ls = jnp.mean(reprojection_error(h_ls, src, tar))
    e_min = jnp.mean(reprojection_error(h_min, src, tar))
    assert float(e_ls) < float(e_min)


def test_aca_rect(key, dtype):
    """Rect specialization agrees with general ACA on rect sources."""
    origin, wh, tar = jit_of(
        lambda k: rect_offset_pairs(k, (B,), dtype=dtype)
    )(key)
    corners = rect_corners(origin, wh)
    h_rect = jit_of(aca_rect)(tar, origin, wh)
    h_gen = jit_of(aca)(corners, tar)
    assert h_close(h_rect, h_gen, TOL[dtype])
    err = float(_max_reproj(h_rect, corners, tar))
    assert err < (0.05 if dtype == jnp.float32 else 1e-6)


def test_aca_square_and_qr(key, dtype):
    """Square / unit-square (QR) specializations agree with the general rect."""
    from sks_tpu.ops import aca_qr, aca_square

    origin, wh, tar = jit_of(
        lambda k: rect_offset_pairs(k, (B,), dtype=dtype)
    )(key)
    side = wh[..., 0]
    wh_sq = jnp.stack([side, side], axis=-1)
    h_sq = jit_of(aca_square)(tar, origin, side)
    h_ref = jit_of(aca_rect)(tar, origin, wh_sq)
    assert h_close(h_sq, h_ref, TOL[dtype])
    err = float(_max_reproj(h_sq, rect_corners(origin, wh_sq), tar))
    assert err < (0.05 if dtype == jnp.float32 else 1e-6)

    # QR case: unit square at the origin.
    unit_o = jnp.zeros_like(origin)
    unit_s = jnp.ones_like(wh)
    h_qr = jit_of(aca_qr)(tar)
    h_ref = jit_of(aca_rect)(tar, unit_o, unit_s)
    assert h_close(h_qr, h_ref, TOL[dtype] * 10)
    err = float(_max_reproj(h_qr, rect_corners(unit_o, unit_s), tar))
    assert err < (0.05 if dtype == jnp.float32 else 1e-6)


def test_degeneracy_masks(key, synth):
    src, tar, _ = synth(key, B, 4, 0.0, jnp.float64)
    jmask_a = jit_of(aca_valid_mask)
    jmask_s = jit_of(sks_valid_mask)
    assert bool(jnp.all(jmask_a(src, tar)))
    assert bool(jnp.all(jmask_s(src, tar)))
    # Make anchors collinear: P on segment M-N.
    bad = src.at[:, 2].set(0.5 * (src[:, 0] + src[:, 1]))
    assert not bool(jnp.any(jmask_a(bad, tar)))
    # SKS: M == N degenerate.
    bad2 = src.at[:, 1].set(src[:, 0])
    assert not bool(jnp.any(jmask_s(bad2, tar)))


def test_batch_broadcasting(key, synth):
    """Ops accept arbitrary leading batch dims."""
    src, tar, _ = synth(key, 30, 4, 0.0, jnp.float32)
    src = src.reshape(2, 3, 5, 4, 2)
    tar = tar.reshape(2, 3, 5, 4, 2)
    h = jit_of(aca)(src, tar)
    assert h.shape == (2, 3, 5, 3, 3)
    assert float(_max_reproj(h, src, tar)) < 0.1


@pytest.mark.slow
def test_dtype_preserved(key, synth):
    src, tar, _ = synth(key, 4, 4, 0.0, jnp.float32)
    src64, tar64 = src.astype(jnp.float64), tar.astype(jnp.float64)
    for name, f in SOLVERS.items():
        jf = jit_of(f)
        assert jf(src, tar).dtype == jnp.float32, name
        assert jf(src64, tar64).dtype == jnp.float64, name


def test_jit_and_vmap_compose(key, synth):
    """Solvers are jit/vmap/grad-compatible (functional transforms)."""
    src, tar, _ = synth(key, B, 4, 0.0, jnp.float32)
    h1 = jit_of(aca)(src, tar)
    h2 = jit_of(jax.vmap(aca))(src, tar)
    assert np.allclose(np.asarray(h1), np.asarray(h2), atol=1e-5)

    def loss(s):
        return jnp.sum(aca(s, tar) ** 2)

    g = jit_of(jax.grad(loss))(src)
    assert g.shape == src.shape
    assert bool(jnp.all(jnp.isfinite(g)))


def test_ndlt_invit_eig_matches_jacobi(key, synth):
    """The f32 LDL^T inverse-iteration eigensolver (~45% the flops of the
    6-sweep Jacobi) is equal-or-better at median and p99 reprojection on
    homography-consistent quads."""
    from sks_tpu.ops.ndlt import ndlt_core

    src, tar, _ = synth(key, 4096, 4, 0.0, jnp.float32)
    comps = [src[:, i, j] for i in range(4) for j in range(2)]
    comps_t = [tar[:, i, j] for i in range(4) for j in range(2)]

    def resid(h):
        hm = np.stack([np.asarray(e, np.float64) for e in h], -1)
        hm = hm.reshape(-1, 3, 3)
        hm = hm / hm[:, 2:3, 2:3]
        s = np.concatenate([np.asarray(src, np.float64),
                            np.ones((src.shape[0], 4, 1))], -1)
        p = np.einsum("bij,bkj->bki", hm, s)
        p = p[..., :2] / p[..., 2:3]
        return np.abs(p - np.asarray(tar, np.float64)).max(axis=(1, 2))

    r_inv = resid(jit_of(
        lambda *a: ndlt_core(*a, eig="invit"))(*comps, *comps_t))
    r_jac = resid(jit_of(
        lambda *a: ndlt_core(*a, eig="jacobi"))(*comps, *comps_t))
    assert np.median(r_inv) <= 1.5 * np.median(r_jac), (
        np.median(r_inv), np.median(r_jac))
    assert np.quantile(r_inv, 0.99) <= 2.0 * np.quantile(r_jac, 0.99), (
        np.quantile(r_inv, 0.99), np.quantile(r_jac, 0.99))


def test_dlt_condition_flags_collinear_corners():
    """The smoke's conditioning measure: a rectangle is near its floor,
    three collinear corners (on both sides, as an exact H keeps them) blow it
    up, and scaling the pixels changes nothing."""
    from chip_smoke import dlt_condition

    sq = np.array([[0.0, 0.0], [640.0, 0.0], [640.0, 480.0], [0.0, 480.0]])
    line = sq.copy()
    line[1] = [320.0, 240.0]  # on the diagonal through corners 0 and 2
    k = dlt_condition(np.stack([sq, sq, line]),
                      np.stack([sq, sq * 0.5, line * 0.5 + 7.0]))
    assert k[0] < 10 and abs(k[1] - k[0]) < 1e-9 * k[0], k
    assert k[2] > 1e6, k


@pytest.mark.parametrize("name", [
    "aca", "sks", "rho_ge", "gpt_lu", "ho",
    pytest.param("ndlt", marks=pytest.mark.slow),  # 9x9 Jacobi trace ~60s
])
def test_f32_corner_reprojection_within_smoke_bound(name):
    """float32 exact-quad solves hold the smoke's max corner reprojection
    bound on every quad within its condition-number limit."""
    from chip_smoke import KAPPA_MAX, dlt_condition

    src, tar, _ = jit_of(
        lambda k: random_correspondences(k, (4096,), 4, 0.0, jnp.float32)
    )(jax.random.PRNGKey(1))
    held = dlt_condition(np.asarray(src), np.asarray(tar)) <= KAPPA_MAX
    assert held.mean() > 0.99
    h = np.asarray(jit_of(SOLVERS[name])(src, tar), np.float64)
    s = np.asarray(src, np.float64)
    hom = np.concatenate([s, np.ones_like(s[..., :1])], -1)
    p = np.einsum("bij,bkj->bki", h, hom)
    rep = np.linalg.norm(p[..., :2] / p[..., 2:] - np.asarray(tar, np.float64),
                         axis=-1).max(axis=-1)
    assert rep[held].max() <= 5e-3, rep[held].max()
