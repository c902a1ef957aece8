"""Reference-Table-8-shaped solver sweep with chained device timing.

Reproduces the full benchmark matrix of the reference's GPU harness
(``GPU_Runtime Test.cu:1457-1490``, numbers in BASELINE.md Table 8): per-batch
latency of all six solvers across RANSAC-motivated batch sizes — with the
chained-loop methodology (K serialized solver invocations inside one
dispatch, two-point K fit, :func:`measure_chained`), because launch and host
overhead dwarf the small-batch kernels.  The chain count K is a *traced* loop
bound here so every (solver, B) cell costs exactly one compilation.  Each row
times the ``(B, 4, 2)`` op users call (``SOLVERS_H``).

Run ``python -m sks_tpu.bench.table8 [--full] [--out PATH]`` on the desired
backend; emits a markdown table and a JSON artifact with the reference numbers
alongside.  Reference GPU values are CUDA fp64; the JSON records our dtype so
comparisons stay honest.
"""

from __future__ import annotations

import json
import time
from functools import partial

import jax
import jax.numpy as jnp

from sks_tpu.ops import SOLVERS_H
from sks_tpu.utils.synth import random_quad_pairs

__all__ = ["aos_chained", "measure_chained", "run_table"]

#: Reference Table 8 (BASELINE.md): {solver: {B: us_per_batch}}, CUDA fp64.
REFERENCE_TABLE8_US = {
    "ndlt": {1: 469, 10: 617, 100: 794, 1_000: 807, 10_000: 1_350,
             100_000: 15_000, 1_000_000: 151_000},
    "ho": {1: 55.1, 10: 65.5, 100: 79.3, 1_000: 80.8, 10_000: 135,
           100_000: 1_190, 1_000_000: 11_200},
    "gpt_lu": {1: 29.6, 10: 30.8, 100: 31.1, 1_000: 31.2, 10_000: 50.7,
               100_000: 845, 1_000_000: 8_390},
    "rho_ge": {1: 4.69, 10: 4.69, 100: 4.74, 1_000: 6.17, 10_000: 10.1,
               100_000: 66.7, 1_000_000: 589},
    "sks": {1: 4.20, 10: 4.26, 100: 4.31, 1_000: 4.83, 10_000: 7.45,
            100_000: 49.9, 1_000_000: 436},
    "aca": {1: 3.11, 10: 3.16, 100: 3.19, 1_000: 3.20, 10_000: 5.26,
            100_000: 29.3, 1_000_000: 245},
}


@partial(jax.jit, static_argnames=("name",))
def aos_chained(src, tar, k, *, name: str):
    """K chained solves of ``SOLVERS_H[name]`` on (B, 4, 2) inputs.

    The scalar data dependency (element [0, 2, 2] of the previous batch of
    homographies, scaled below pixel roundoff) serializes iterations; carrying
    the full (B, 3, 3) output keeps XLA from dead-code-eliminating any lane.
    Returns a checksum scalar (forces completion on readback).
    """
    solver = SOLVERS_H[name]
    init = jnp.zeros((*src.shape[:-2], 3, 3), src.dtype)

    def body(_, h):
        s = src + h.reshape(-1)[8] * 1e-38
        return solver(s, tar)

    out = jax.lax.fori_loop(0, k, body, init)
    return jnp.sum(out[..., 2, 2])


def measure_chained(call, min_window_s: float = 0.25, repeats: int = 3,
                    k_cap: int = 1_000_000) -> float:
    """Seconds per chained step from a window-guaranteed two-point K fit.

    ``call(k)`` must run the chained loop K times and block until done.  K is
    traced in the chained fns above, so every probe reuses one executable.

    K2 is escalated geometrically until the *differential* time
    ``t(K2) - t(1)`` exceeds ``min_window_s``, so timing jitter is a small
    fraction of the fitted window however short one step is.
    """

    def once(k):
        t0 = time.perf_counter()
        call(k)
        return time.perf_counter() - t0

    call(1)  # compile + warm
    t_base = once(1)
    if t_base >= min_window_s:
        # One step is already a resolvable window.
        t2 = once(2)
        return max(t2 - t_base, 1e-9)

    k2 = 4
    t2 = once(k2)
    while t2 - t_base < min_window_s and k2 < k_cap:
        k2 *= 4
        t2 = once(k2)

    k1 = max(1, k2 // 4)

    def best(k):
        b = float("inf")
        for _ in range(repeats):
            b = min(b, once(k))
        return b

    t1 = best(k1)
    t2 = best(k2)
    return max((t2 - t1) / (k2 - k1), 1e-9)


_DEFAULT_B = (1, 100, 10_000, 1_000_000)
_FULL_B = (1, 10, 100, 1_000, 10_000, 100_000, 1_000_000)


def run_table(full: bool = False, dtype=jnp.float32, seed: int = 0):
    """Run the sweep on the live backend.  Returns a list of row dicts."""
    rows = []
    key = jax.random.PRNGKey(seed)

    def ref_us(name, b):
        table = REFERENCE_TABLE8_US.get(name, {})
        return table.get(b) or table.get(min(table, key=lambda x: abs(x - b)))

    batches = _FULL_B if full else _DEFAULT_B
    for name in ("aca", "sks", "rho_ge", "gpt_lu", "ho", "ndlt"):
        for b in batches:
            src, tar = jax.jit(
                lambda k: random_quad_pairs(k, b, dtype), static_argnums=()
            )(key)
            jax.block_until_ready((src, tar))
            fn = partial(aos_chained, name=name)
            sec = measure_chained(lambda k: float(fn(src, tar, k)))
            rows.append({
                "solver": name, "impl": "xla", "batch": b,
                "dtype": str(jnp.dtype(dtype)),
                "us_per_batch": sec * 1e6,
                "h_per_s": b / sec,
                "ref_us_per_batch_cuda_f64": ref_us(name, b),
            })
            print(f"{name:8} xla    B={b:>8}: {sec*1e6:10.2f} us/batch "
                  f"({b/sec:.3e} H/s)", flush=True)
    return rows


def to_markdown(rows) -> str:
    lines = [
        "| solver | impl | B | us/batch | H/s | ref CUDA f64 us | speedup |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        ref = r["ref_us_per_batch_cuda_f64"]
        sp = f"{ref / r['us_per_batch']:.2f}x" if ref else "-"
        lines.append(
            f"| {r['solver']} | {r['impl']} | {r['batch']} "
            f"| {r['us_per_batch']:.2f} | {r['h_per_s']:.3e} "
            f"| {ref if ref else '-'} | {sp} |"
        )
    return "\n".join(lines)


def main(argv=None):
    """Console entry point (``sks-table8``)."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="all 7 reference batch sizes (slower)")
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)

    backend = jax.default_backend()
    rows = run_table(full=args.full)
    print()
    print(to_markdown(rows))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"backend": backend, "rows": rows}, f, indent=1)
        print(f"\nwrote {args.out}")


if __name__ == "__main__":
    main()
