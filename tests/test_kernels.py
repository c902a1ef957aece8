"""The fused solve+score Triton kernel (Pallas interpreter on the CPU), and
the straight-line solver cores against the batched ops they single-source.

The kernel runs here in Pallas's interpreter, which executes the same kernel
body the card compiles, so indexing and padding bugs are caught without a
GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import jit_of
from sks_tpu.bench.fused_probe import aca_solve_score
from sks_tpu.geom.homography import normalize_h
from sks_tpu.ops import SOLVERS_H, aca_h
from sks_tpu.robust.ransac import score_hypotheses
from sks_tpu.utils.synth import random_correspondences, random_quad_pairs

B = 256


@pytest.mark.parametrize("name", [
    "rho_ge", "gpt_lu", "ho",
    pytest.param("ndlt", marks=pytest.mark.slow),  # 9x9 Jacobi trace ~60s
])
def test_baseline_cores_match_aos_ops(key, name):
    """Component cores == the AoS ops they single-source (f64, exact math)."""
    from sks_tpu.ops.ge import ge_core
    from sks_tpu.ops.gpt import gpt_core
    from sks_tpu.ops.ho import ho_core
    from sks_tpu.ops.ndlt import ndlt_core

    core = {"rho_ge": ge_core, "gpt_lu": gpt_core, "ho": ho_core,
            "ndlt": ndlt_core}[name]
    src, tar = jit_of(lambda k: random_quad_pairs(k, 64, jnp.float64))(key)

    def comps(p):
        return [p.reshape(-1, 8)[:, i] for i in range(8)]

    hc = jit_of(
        lambda s, t: jnp.stack(core(*comps(s), *comps(t)), -1).reshape(-1, 3, 3)
    )(src, tar)
    ha = jit_of(SOLVERS_H[name])(src, tar)
    a = np.asarray(normalize_h(hc, "fro"))
    b = np.asarray(normalize_h(ha, "fro"))
    assert np.allclose(a, b, atol=1e-9), np.max(np.abs(a - b))


def _points(key, n):
    ps, pt, _ = jit_of(
        lambda k: random_correspondences(k, (), n, 1.0, jnp.float32)
    )(key)
    return ps, pt


def test_pallas_solve_score_matches_reference(key):
    """Fused kernel inlier counts == score_hypotheses (ties excepted)."""
    src, tar = jit_of(lambda k: random_quad_pairs(k, B, jnp.float32))(key)
    ps, pt = _points(key, 64)
    counts = np.asarray(aca_solve_score(src, tar, ps, pt, 3.0, block_b=128,
                                        block_n=16))
    # Reference scoring counts r2_fwd + r2_bwd < thr^2 (the same symmetric
    # metric).
    sc, _ = score_hypotheses(aca_h(src, tar), ps, pt, 3.0)
    assert counts.shape == (B,)
    assert np.allclose(counts, np.asarray(sc), atol=0.5), (
        counts[:8],
        np.asarray(sc)[:8],
    )


@pytest.mark.parametrize("scoring", ["msac", "magsac"])
def test_fused_soft_scores_padded_weighted(key, scoring):
    """Soft scores with N and B off the block sizes and zero-weight points.

    B=200 and N=70 pad to the 64-wide blocks inside the wrapper; the last 10
    points carry weight 0, like padded fixed-shape match arrays.
    """
    src, tar = jit_of(lambda k: random_quad_pairs(k, 200, jnp.float32))(key)
    ps, pt = _points(key, 70)
    pm = jnp.arange(70) < 60
    got = np.asarray(aca_solve_score(
        src, tar, ps, pt, 3.0, point_weights=pm, scoring=scoring,
        block_b=64, block_n=64))
    ref, _ = score_hypotheses(aca_h(src, tar), ps, pt, 3.0, point_mask=pm,
                              scoring=scoring)
    assert got.shape == (200,)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_fused_bf16_storage_matches_f32_on_bf16_inputs(key):
    """bf16-stored minimal sets score as the f32 kernel on the same values."""
    src, tar = jit_of(lambda k: random_quad_pairs(k, 128, jnp.float32))(key)
    s16, t16 = src.astype(jnp.bfloat16), tar.astype(jnp.bfloat16)
    ps, pt = _points(key, 64)
    a = aca_solve_score(s16, t16, ps, pt, 3.0)
    b = aca_solve_score(s16.astype(jnp.float32), t16.astype(jnp.float32),
                        ps, pt, 3.0)
    assert np.array_equal(np.asarray(a), np.asarray(b))


def test_fused_rejects_median_scoring(key):
    src, tar = jit_of(lambda k: random_quad_pairs(k, 8, jnp.float32))(key)
    with pytest.raises(ValueError):
        aca_solve_score(src, tar, src[:, 0], tar[:, 0], 3.0, scoring="lmeds")
