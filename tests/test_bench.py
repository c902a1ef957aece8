"""Benchmark machinery: chained timing fns compile/run and stay serialized."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from functools import partial

from conftest import jit_of

from sks_tpu.bench.harness import time_jitted
from sks_tpu.bench.table8 import aos_chained, measure_chained, to_markdown
from sks_tpu.utils.synth import random_quad_pairs


def _pairs(key, b=128):
    return jit_of(lambda k: random_quad_pairs(k, b, jnp.float32))(key)


@pytest.mark.slow
def test_aos_chained_all_solvers(key):
    src, tar = _pairs(key)
    for name in ("aca", "sks", "rho_ge", "gpt_lu", "ho", "ndlt"):
        out = aos_chained(src, tar, 3, name=name)
        assert np.isfinite(float(out)), name


def test_aos_chained_dynamic_k_single_compile(key):
    """K is a traced operand: different K values reuse one executable."""
    src, tar = _pairs(key)
    fn = partial(aos_chained, name="aca")
    v1 = float(fn(src, tar, 2))
    v2 = float(fn(src, tar, 7))
    # Chain injection is below roundoff: results agree to fp32 precision.
    assert np.isclose(v1, v2, rtol=1e-5), (v1, v2)


def test_measure_chained_returns_sane_step(key):
    src, tar = _pairs(key)
    fn = partial(aos_chained, name="aca")
    sec = measure_chained(lambda k: float(fn(src, tar, k)),
                          min_window_s=0.05, repeats=2)
    assert 0.0 < sec < 1.0


def test_time_jitted_shape(key):
    src, tar = _pairs(key)
    from sks_tpu.ops import aca

    res = time_jitted(jit_of(aca), src, tar, budget_s=0.05, repeats=2)
    assert res.seconds_per_call > 0
    assert res.throughput(128) > 0


def test_markdown_rendering():
    rows = [{
        "solver": "aca", "impl": "xla", "batch": 128,
        "dtype": "float32", "us_per_batch": 12.5, "h_per_s": 1e7,
        "ref_us_per_batch_cuda_f64": 3.19,
    }]
    md = to_markdown(rows)
    assert "aca" in md and "0.26x" in md


def test_device_peaks_unknown_kind_raises():
    from sks_tpu.bench.headline import DEVICE_PEAKS, device_peaks

    for kind, peaks in DEVICE_PEAKS.items():
        assert device_peaks(kind) is peaks and peaks["hbm_gbps"] > 0
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks("cpu")


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_off_the_gpu(tmp_path, where):
    """On the CPU, or without the library beside it, chip_smoke.py exits
    non-zero and never prints the ok line."""
    import os
    import shutil
    import subprocess
    import sys
    from pathlib import Path

    script = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0, r.stdout
    assert '"ok"' not in r.stdout
