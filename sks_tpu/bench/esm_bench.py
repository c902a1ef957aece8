"""ESM tracker throughput: gather vs one-hot matmul sampling.

The ``sampler='matmul'`` path (see ``slam/tracking.py`` module docstring)
turns the three bilinear samples per pixel per iteration into one row-weight
matmul + a masked column reduction; this bench measures what that buys
against plain gathers on the current device.

Config: a batch of 64 templates (64x64) tracked in their own 128x128 frames
for 10 iterations each, vmapped into one jit, with distinct initial
homographies per repeat; blocking is via scalar readback (``float(...)``).

Run: python -m sks_tpu.bench.esm_bench [--out PATH]
"""

from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp

from sks_tpu.slam.tracking import esm_track

__all__ = ["run"]


def _make_batch(key, batch=64, tpl=64, img=128):
    """Smooth random textures; template = center crop, truth = translation."""
    k1, k2 = jax.random.split(key)
    x = jax.random.uniform(k1, (batch, img + 8, img + 8), jnp.float32)
    # Separable box-smooth (twice) so bilinear structure is trackable.
    for _ in range(3):
        x = 0.25 * (x[:, :-2, 1:-1] + x[:, 2:, 1:-1]
                    + x[:, 1:-1, :-2] + x[:, 1:-1, 2:])
        x = jnp.pad(x, ((0, 0), (1, 1), (1, 1)), mode="edge")
    imgs = x[:, :img, :img]
    o = (img - tpl) // 2
    tpls = imgs[:, o:o + tpl, o:o + tpl]
    t0 = jnp.asarray([[1.0, 0.0, o], [0.0, 1.0, o], [0.0, 0.0, 1.0]],
                     jnp.float32)
    # Perturbed starts: ~2 px translation error per template.
    d = jax.random.uniform(k2, (batch, 2), jnp.float32, -2.0, 2.0)
    h0 = jnp.broadcast_to(t0, (batch, 3, 3)).at[:, :2, 2].add(d)
    return tpls, imgs, h0


def run(batch: int = 64, tpl: int = 64, img: int = 128, iters: int = 10,
        reps: int = 5, out_path: str | None = None):
    dev = jax.devices()[0]
    result = {
        "metric": "esm_templates_tracked_per_sec_per_chip",
        "batch_templates": batch, "template": [tpl, tpl],
        "image": [img, img], "iters_per_track": iters,
        "device_kind": dev.device_kind,
    }
    keys = jax.random.split(jax.random.PRNGKey(0), reps + 1)
    for sampler in ("gather", "matmul"):
        vf = jax.vmap(
            lambda t, i, h: esm_track(t, i, h, iters=iters,
                                      sampler=sampler)[0]
        )
        fit = jax.jit(lambda t, i, h: jnp.sum(vf(t, i, h)))
        batches = [_make_batch(k, batch, tpl, img) for k in keys]
        float(fit(*batches[0]))  # compile + run
        samples = []
        for b in batches[1:]:
            t0 = time.perf_counter()
            float(fit(*b))
            samples.append(time.perf_counter() - t0)
        samples.sort()
        sec = samples[len(samples) // 2]
        result[sampler] = {
            "sec_per_batch_track": sec,
            "templates_per_sec": batch / sec,
            "esm_iterations_per_sec": batch * iters / sec,
        }
        print(sampler, round(batch / sec, 1), "templates/s")
    g = result["gather"]["templates_per_sec"]
    m = result["matmul"]["templates_per_sec"]
    result["matmul_speedup"] = m / g
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
        print("wrote", out_path)
    return result


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    run(batch=args.batch, iters=args.iters, out_path=args.out)
