"""df64 (double-float) arithmetic: fp64-parity accuracy from fp32 words.

Checks the error-free transforms are exact and that the df64 ACA chain reaches
near-fp64 accuracy (BASELINE.json config 1: "C++ CPU runtime test, fp64
parity") — orders of magnitude beyond plain fp32 on the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import jit_of
from sks_tpu.geom.homography import normalize_h
from sks_tpu.ops import aca
from sks_tpu.ops.df64 import (
    DF,
    _two_prod,
    _two_sum,
    aca_df64,
    df_from_f64,
    df_to_f64,
)

B = 64


def test_error_free_transforms(key):
    """two_sum / two_prod residuals are *exact* (verified in fp64)."""
    k1, k2 = jax.random.split(key)
    a = jax.random.uniform(k1, (1024,), jnp.float32, -1e3, 1e3)
    b = jax.random.uniform(k2, (1024,), jnp.float32, 1e-4, 1.0)

    s, e = jit_of(_two_sum)(a, b)
    exact = a.astype(jnp.float64) + b.astype(jnp.float64)
    got = s.astype(jnp.float64) + e.astype(jnp.float64)
    assert np.array_equal(np.asarray(exact), np.asarray(got))

    p, e = jit_of(_two_prod)(a, b)
    exact = a.astype(jnp.float64) * b.astype(jnp.float64)
    got = p.astype(jnp.float64) + e.astype(jnp.float64)
    assert np.array_equal(np.asarray(exact), np.asarray(got))


def test_df_mul_accuracy(key):
    """DF products carry ~2x the fp32 significand."""
    k1, k2 = jax.random.split(key)
    x64 = jax.random.uniform(k1, (4096,), jnp.float64, 0.5, 2.0)
    y64 = jax.random.uniform(k2, (4096,), jnp.float64, 0.5, 2.0)
    z = jit_of(lambda a, b: df_from_f64(a) * df_from_f64(b))(x64, y64)
    rel = np.abs(np.asarray(df_to_f64(z) - x64 * y64) / np.asarray(x64 * y64))
    assert rel.max() < 1e-13


def test_aca_df64_beats_f32(key, synth):
    """df64 ACA ~ fp64 accuracy; >= 10^3 tighter than fp32 on the same inputs."""
    src64, tar64, _ = synth(key, B, 4, 0.0, jnp.float64)
    h_ref = np.asarray(jit_of(aca)(src64, tar64))

    h32 = np.asarray(
        jit_of(aca)(src64.astype(jnp.float32), tar64.astype(jnp.float32))
    ).astype(np.float64)
    hdf = jit_of(lambda s, t: aca_df64(df_from_f64(s), df_from_f64(t)))(
        src64, tar64
    )
    hdf64 = np.asarray(df_to_f64(hdf))

    scale = np.abs(h_ref).max(axis=(-2, -1), keepdims=True)
    err32 = np.abs(h32 - h_ref).max() / scale.max()
    errdf = (np.abs(hdf64 - h_ref) / scale).max()
    assert errdf < 1e-10
    assert errdf < err32 / 1e3


def test_df64_hi_is_rounded_result(key, synth):
    """The hi word alone is the fp64 result correctly rounded to fp32."""
    src64, tar64, _ = synth(key, B, 4, 0.0, jnp.float64)
    h_ref = np.asarray(jit_of(aca)(src64, tar64))
    hdf = jit_of(aca_df64)(
        src64.astype(jnp.float32), tar64.astype(jnp.float32)
    )
    assert hdf.hi.dtype == jnp.float32
    # Inputs were rounded to fp32 first, so allow input-rounding noise relative
    # to the matrix scale — but hi must be far tighter than fp32 arithmetic.
    scale = np.abs(h_ref).max(axis=(-2, -1), keepdims=True)
    err = (np.abs(np.asarray(hdf.hi).astype(np.float64) - h_ref) / scale).max()
    assert err < 1e-4


@pytest.mark.slow
def test_df64_jit_vmap_compose(key, synth):
    """DF is a pytree (NamedTuple of arrays): jit/vmap work unchanged."""
    src, tar, _ = synth(key, B, 4, 0.0, jnp.float32)
    f = jax.jit(jax.vmap(aca_df64))
    out = f(src, tar)
    assert isinstance(out, DF)
    assert out.hi.shape == (B, 3, 3)
    assert bool(jnp.all(jnp.isfinite(out.hi)))


def test_sks_df64_matches_f64_jitted(key):
    """sks_df64 under jit tracks true fp64 (guards the _pin EFT shields —
    without them XLA:CPU's simplifier zeroes the error words)."""
    from sks_tpu.geom.homography import normalize_h
    from sks_tpu.ops.df64 import df_to_f64, sks_df64_h
    from sks_tpu.ops.sks import sks_h
    from sks_tpu.utils.synth import random_quad_pairs

    src64, tar64 = jit_of(lambda k: random_quad_pairs(k, 256, jnp.float64))(key)
    src, tar = src64.astype(jnp.float32), tar64.astype(jnp.float32)
    h_df = df_to_f64(jax.jit(sks_df64_h)(src, tar))
    h64 = jit_of(sks_h)(src.astype(jnp.float64), tar.astype(jnp.float64))
    d = float(jnp.max(jnp.abs(normalize_h(h_df, "fro")
                              - normalize_h(h64, "fro"))))
    assert d < 1e-10, d


def test_residual2_df64_accuracy(key):
    """df64 scoring residuals track fp64 ~500x closer than f32."""
    from sks_tpu.ops import aca_h
    from sks_tpu.ops.df64 import residual2_df64
    from sks_tpu.robust.ransac import _residual2
    from sks_tpu.utils.synth import random_correspondences, random_quad_pairs

    src, tar = jit_of(lambda k: random_quad_pairs(k, 64, jnp.float32))(key)
    h = jit_of(aca_h)(src, tar)
    h = h / h[..., 2:3, 2:3]  # normalized scale (raw 1e20-scale is ~100x
    # looser but still df64-exact where f32 overflows outright)
    ps, pt, _ = jit_of(
        lambda k: random_correspondences(k, (), 64, 1.0, jnp.float32)
    )(jax.random.fold_in(key, 1))
    r_df = jax.jit(residual2_df64)(h, ps, pt)
    r_64 = _residual2(h.astype(jnp.float64), ps.astype(jnp.float64),
                      pt.astype(jnp.float64))
    r_32 = _residual2(h, ps, pt)
    # Points near a hypothesis's horizon give infinite residuals on every
    # path; compare where the fp64 residual is finite and well-scaled.
    ok = (jnp.isfinite(r_64) & (r_64 > 1e-6) & (r_64 < 1e12)
          & jnp.isfinite(r_32))
    rel_df = float(jnp.max(jnp.where(ok, jnp.abs(r_df - r_64) / r_64, 0.0)))
    rel_32 = float(jnp.max(jnp.where(ok, jnp.abs(r_32 - r_64) / r_64, 0.0)))
    assert rel_df < rel_32 / 50, (rel_df, rel_32)


@pytest.mark.slow
def test_ndlt_df64_fixture_grade(key):
    """df64 NDLT reaches fp64-grade accuracy where plain f32 fails by ~1e3 px
    (the golden-test exclusion this test made deletable)."""
    import numpy as np

    from sks_tpu.data.fixture import GT_H, load_correspondences
    from sks_tpu.geom.homography import apply_homography
    from sks_tpu.ops.df64 import df_to_f64, ndlt_df64_h

    src, _ = load_correspondences()
    src = jnp.asarray(src)
    rng = np.random.default_rng(3)
    idx = np.stack([rng.choice(src.shape[0], 4, replace=False)
                    for _ in range(64)])
    s4 = jnp.take(src, jnp.asarray(idx), axis=0).astype(jnp.float32)
    t4 = apply_homography(jnp.asarray(GT_H, jnp.float32), s4)
    h = df_to_f64(jax.jit(ndlt_df64_h)(s4, t4))
    h = h / h[..., 2:3, 2:3]
    err = jnp.max(jnp.abs(apply_homography(h, s4[:, None].astype(jnp.float64))
                          - t4[:, None]), axis=(-3, -2, -1))
    assert float(jnp.median(err)) < 1.0, float(jnp.median(err))


def test_ndlt_df64_invit_matches_jacobi(key):
    """The LDL^T inverse-iteration eigensolver (the ~40x cheaper default)
    reaches the converged df64 Jacobi's direction accuracy on wall-scale
    quads — the substitution that took the df64 NDLT Table-8 row from 0.45x
    to >10x the reference's native fp64 (DF64_TABLE8.json)."""
    import numpy as np

    from sks_tpu.ops.df64 import df_to_f64, ndlt_df64_h

    rng = np.random.default_rng(11)
    src = jnp.asarray(rng.uniform(0, 640, (256, 4, 2)), jnp.float32)
    tar = jnp.asarray(rng.uniform(0, 640, (256, 4, 2)), jnp.float32)

    def reproj(h):
        h = np.asarray(h)
        h = h / h[..., 2:3, 2:3]
        s = np.concatenate([np.asarray(src, np.float64),
                            np.ones((256, 4, 1))], -1)
        p = np.einsum("bij,bkj->bki", h, s)
        p = p[..., :2] / p[..., 2:3]
        return np.abs(p - np.asarray(tar, np.float64)).max(axis=(1, 2))

    r_inv = reproj(df_to_f64(jax.jit(
        lambda s, t: ndlt_df64_h(s, t, df_eig="invit"))(src, tar)))
    r_jac = reproj(df_to_f64(jax.jit(
        lambda s, t: ndlt_df64_h(s, t, df_eig="jacobi"))(src, tar)))
    # Both fp64-grade on the defining quad; invit no worse than Jacobi.
    assert float(np.median(r_inv)) < 1e-8, float(np.median(r_inv))
    assert float(np.median(r_inv)) <= 4.0 * float(np.median(r_jac)), (
        float(np.median(r_inv)), float(np.median(r_jac)))


@pytest.mark.slow
def test_baseline_df64_solvers_fixture_grade(key):
    """GE/GPT/HO df64 reach fp64-grade residuals on wall-scale quads —
    completing the df64 family to all six solvers (the reference's GPU
    table is fp64 throughout)."""
    import numpy as np

    from sks_tpu.ops.df64 import df_to_f64, ge_df64_h, gpt_df64_h, ho_df64_h

    rng = np.random.default_rng(17)
    n = 128
    src = jnp.asarray(rng.uniform(0, 640, (n, 4, 2)), jnp.float32)
    tar = jnp.asarray(rng.uniform(0, 640, (n, 4, 2)), jnp.float32)

    def reproj(h):
        h = np.asarray(h)
        h = h / h[..., 2:3, 2:3]
        s = np.concatenate([np.asarray(src, np.float64),
                            np.ones((n, 4, 1))], -1)
        p = np.einsum("bij,bkj->bki", h, s)
        p = p[..., :2] / p[..., 2:3]
        return np.abs(p - np.asarray(tar, np.float64)).max(axis=(1, 2))

    for name, fn, tol in (("ge", ge_df64_h, 1e-7),
                          ("gpt", gpt_df64_h, 1e-8),
                          ("ho", ho_df64_h, 1e-7)):
        r = reproj(df_to_f64(jax.jit(fn)(src, tar)))
        assert float(np.median(r)) < tol, (name, float(np.median(r)))


@pytest.mark.slow
def test_ransac_df64_scoring_smoke(key):
    """RansacConfig(df64_scoring=True) runs end-to-end and rejects outliers."""
    from sks_tpu.robust.ransac import RansacConfig, ransac_homography
    from sks_tpu.utils.synth import random_correspondences

    src, tar, _ = jit_of(
        lambda k: random_correspondences(k, (), 128, 0.5, jnp.float32))(key)
    tar = tar.at[:32].set(
        jax.random.uniform(jax.random.fold_in(key, 1), (32, 2),
                           jnp.float32, 0, 640))
    cfg = RansacConfig(num_hypotheses=512, threshold=3.0, df64_scoring=True)
    res = ransac_homography(key, src, tar, cfg)
    assert int(res.num_inliers) > 80, int(res.num_inliers)
