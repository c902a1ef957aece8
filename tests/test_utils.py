"""Aux subsystems: FLOP registry vs XLA cost analysis, checks, checkpointing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import jit_of
from sks_tpu.utils.checks import checked_solver, nonfinite_fraction
from sks_tpu.utils.flops import FLOPS, roofline_hps
from sks_tpu.utils.profiling import cost_analysis


def test_flops_registry_vs_xla(key, synth):
    """XLA's counted flops for batched ACA must be within ~2x of the paper
    count (XLA counts the stack/reshape shuffles too)."""
    src, tar, _ = synth(key, 256, 4, 0.0, jnp.float32)
    from sks_tpu.ops import aca_h

    ca = cost_analysis(aca_h, src, tar)
    if not ca or "flops" not in ca:
        pytest.skip("backend reports no cost analysis")
    per = ca["flops"] / 256
    # XLA also counts the AoS unpack / stack shuffle arithmetic; the paper
    # count is a lower bound within an order of magnitude.
    assert per <= FLOPS["aca"]["solve"] * 8, per
    assert per >= FLOPS["aca"]["solve"] * 0.5, per


def test_roofline():
    # H100 SXM 3350 GB/s, 100 B/hyp -> 3.35e10 H/s ceiling
    assert 3.3e10 < roofline_hps(3350.0) < 3.4e10


def test_checked_solver_flags_degenerate(key, synth):
    src, tar, _ = synth(key, 8, 4, 0.0, jnp.float32)
    err, h = checked_solver("aca")(src, tar)
    err.throw()  # clean batch: no error
    bad = src.at[:, 2].set(0.5 * (src[:, 0] + src[:, 1]))  # collinear anchors
    bad = bad.at[:, 3].set(bad[:, 0])  # and duplicate point -> 0/0
    err, h = checked_solver("aca")(bad, tar)
    with pytest.raises(Exception):
        err.throw()


def test_nonfinite_fraction(key, synth):
    src, tar, _ = synth(key, 16, 4, 0.0, jnp.float32)
    from sks_tpu.ops import aca

    h = jit_of(aca)(src, tar)
    assert float(nonfinite_fraction(h)) == 0.0
    h_bad = h.at[0, 0, 0].set(jnp.nan)
    assert abs(float(nonfinite_fraction(h_bad)) - 1 / 16) < 1e-6


@pytest.mark.slow
def test_checkpoint_roundtrip(tmp_path, key, synth):
    from sks_tpu.slam.checkpoint import latest_step, restore_state, save_state

    state = {"h": jnp.eye(3), "step": jnp.asarray(7)}
    save_state(tmp_path / "ckpt", 3, state)
    assert latest_step(tmp_path / "ckpt") == 3
    out = restore_state(tmp_path / "ckpt")
    assert np.allclose(np.asarray(out["h"]), np.eye(3))
    assert int(out["step"]) == 7


def test_package_pins_f32_matmul_precision():
    """Importing sks_tpu must pin full-f32 matmul accumulation: a reduced
    matmul default (TF32 on a GPU) puts ~0.1% error on 3x3 geometry products
    (measured once: a polish denormalization collapsed a 205-inlier
    consensus to 53 while identical code was correct on CPU)."""
    import jax

    import sks_tpu  # noqa: F401

    assert str(jax.config.jax_default_matmul_precision) == "highest"


@pytest.mark.parametrize("env_dir", [None, "from-env"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    """$JAX_COMPILATION_CACHE_DIR wins untouched; else <repo>/.jax_cache."""
    from pathlib import Path

    from sks_tpu.utils.compile_cache import REPO_CACHE_DIR, enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / env_dir))
    try:
        got = enable_compile_cache()
        if env_dir is None:
            assert got == str(REPO_CACHE_DIR)
            assert REPO_CACHE_DIR == Path(__file__).resolve().parents[1] / ".jax_cache"
            assert jax.config.jax_compilation_cache_dir == got
        else:
            assert got == str(tmp_path / env_dir)
            # Sets nothing: JAX reads the variable itself.
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
