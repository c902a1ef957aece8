"""df64 Table-8 rows: the double-word solvers against the reference's fp64.

The reference GPU table is fp64 (`GPU_Runtime Test.cu:81-240` — all kernels
`double`).  The repo's df64 double-word solvers (`ops/df64.py`: the same
straight-line cores run on (hi, lo) fp32 pairs, ~49-bit precision) give
fp64-grade results from fp32 arithmetic; this bench times them.  Whether they
beat the card's native fp64 is an open measurement (ROADMAP D3).

Layout: the (B, 4, 2) minimal sets users pass (`df64_aos_chained`).

Timing: the chained two-point-K methodology of `bench/table8.py`
(`measure_chained` — serialized device-side iterations, differential fit).
Accuracy: max |H_df64 - H_f32| and the df64-evaluated reprojection residual
of both, on an exact synthetic batch (f64 ground-truth cross-checks live in
tests/test_df64.py).

Run: python -m sks_tpu.bench.df64_table [--out PATH]
"""

from __future__ import annotations

import json
from functools import partial

import jax
import jax.numpy as jnp

from sks_tpu.bench.table8 import REFERENCE_TABLE8_US, measure_chained
from sks_tpu.ops.df64 import (
    aca_df64,
    residual2_df64,
    sks_df64,
)
from sks_tpu.utils.synth import random_correspondences

__all__ = ["run"]

_DF64_FNS = {"aca": aca_df64, "sks": sks_df64}


@partial(jax.jit, static_argnames=("name",))
def df64_aos_chained(src, tar, k, *, name: str):
    """K chained df64 solves on (B, 4, 2) inputs (cf. table8.aos_chained).

    The scalar data dependency serializes iterations; carrying the full
    (2, B, 3, 3) hi/lo output keeps XLA from dead-code-eliminating lanes.
    """
    fn = _DF64_FNS[name]
    init = jnp.zeros((2, *src.shape[:-2], 3, 3), src.dtype)

    def body(_, hh):
        s = src + hh[0].reshape(-1)[8] * 1e-38
        h = fn(s, tar)
        return jnp.stack([h.hi, h.lo])

    out = jax.lax.fori_loop(0, k, body, init)
    return jnp.sum(out[..., 2, 2])


@partial(jax.jit, static_argnames=("chunks",))
def ndlt_df64_chained(src, tar, k, chunks: int = 8):
    """K chained df64 NDLT solves on (B, 4, 2) inputs.

    The df64 normal-matrix chain materializes (B, 9, 9) hi/lo intermediates
    (~648 MB at B=1M), so the batch runs as ``chunks`` sequential
    ``lax.map`` slices, so the intermediates fit in device memory.
    """
    from sks_tpu.ops.df64 import ndlt_df64_h

    b = src.shape[0]
    init = jnp.zeros((2, b, 3, 3), src.dtype)

    def body(_, hh):
        s = src + hh[0].reshape(-1)[8] * 1e-38

        def one(args):
            h = ndlt_df64_h(args[0], args[1])
            return jnp.stack([h.hi, h.lo])

        out = jax.lax.map(one, (s.reshape(chunks, b // chunks, 4, 2),
                                tar.reshape(chunks, b // chunks, 4, 2)))
        return jnp.moveaxis(out, 1, 0).reshape(2, b, 3, 3)

    out = jax.lax.fori_loop(0, k, body, init)
    return jnp.sum(out[..., 2, 2])


def accuracy_check(batch: int = 1024):
    """df64 vs f32 solver accuracy on one exact batch (df64-scored)."""
    from sks_tpu.ops import SOLVERS

    key = jax.random.PRNGKey(3)
    src, tar, _ = random_correspondences(key, (batch,), 4, 0.0, jnp.float32)
    out = {}
    for name in ("aca", "sks"):
        h32 = SOLVERS[name](src, tar)
        hdf = _DF64_FNS[name](src, tar)
        # Reprojection residuals evaluated in df64 arithmetic for both:
        # h (B, 3, 3) x points (B, 4, 2) broadcast to (B, 4) residuals.
        r32 = jnp.sqrt(jnp.max(residual2_df64(h32, src, tar)))
        rdf = jnp.sqrt(jnp.max(residual2_df64(hdf, src, tar)))
        out[name] = {
            "max_abs_h_delta": float(jnp.max(jnp.abs(hdf.hi - h32))),
            "max_reproj_px_f32": float(r32),
            "max_reproj_px_df64": float(rdf),
        }
    # The four baselines (residuals scored in df64; up-to-scale H is fine —
    # the symmetric transfer divides out scale).
    from sks_tpu.ops.df64 import ge_df64_h, gpt_df64_h, ho_df64_h, ndlt_df64_h

    for name, dffn in (("ndlt", ndlt_df64_h), ("rho_ge", ge_df64_h),
                       ("gpt_lu", gpt_df64_h), ("ho", ho_df64_h)):
        h32 = SOLVERS[name](src, tar)
        hdf = jax.jit(dffn)(src, tar)
        out[name] = {
            "max_reproj_px_f32": float(
                jnp.sqrt(jnp.max(residual2_df64(h32, src, tar)))),
            "max_reproj_px_df64": float(
                jnp.sqrt(jnp.max(residual2_df64(hdf, src, tar)))),
        }
    return out


def run(out_path: str | None = None):
    dev = jax.devices()[0]
    key = jax.random.PRNGKey(0)
    rows = []
    for b in (100_000, 1_000_000):
        sq, tq, _ = random_correspondences(key, (b,), 4, 0.0, jnp.float32)
        jax.block_until_ready((sq, tq))
        for name in ("aca", "sks"):
            ref = REFERENCE_TABLE8_US[name].get(b)
            sec = measure_chained(
                lambda k: float(df64_aos_chained(sq, tq, k, name=name))
            )
            row = {
                "solver": name, "b": b,
                "df64_xla_us": sec * 1e6,
                "ref_cuda_fp64_us": ref,
                "speedup_vs_ref": ref / (sec * 1e6) if ref else None,
            }
            rows.append(row)
            print(row, flush=True)
        if b == 100_000:
            sec = measure_chained(lambda k: float(ndlt_df64_chained(sq, tq, k)))
            row = {"solver": "ndlt", "b": b, "df64_xla_us": sec * 1e6,
                   "ref_cuda_fp64_us": REFERENCE_TABLE8_US["ndlt"].get(b)}
            rows.append(row)
            print(row, flush=True)
    result = {
        "config": {"platform": dev.platform,
                   "device_kind": dev.device_kind,
                   "device_count": len(jax.devices()),
                   "note": "df64 (double-fp32) vs reference CUDA fp64 "
                           "Table 8; chained two-point-K timing"},
        "rows": rows,
        "accuracy": accuracy_check(),
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
        print("wrote", out_path)
    return result


def main(argv=None):
    """Console entry point (``sks-df64-table``)."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run(args.out)


if __name__ == "__main__":
    main()
