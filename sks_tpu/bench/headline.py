"""Headline benchmark: batched ACA homography throughput on one card.

Console entry point ``sks-bench`` (also the repo-root ``bench.py``, a thin
shim over this module).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Baseline: the reference's CUDA ACA at B=1M runs 245 us per batch on the paper's
GPU (BASELINE.md, Table 8) => ~4.08e9 homographies/s.

Methodology: device-side chained loop (:func:`sks_tpu.bench.table8.
measure_chained`) — K serialized solves of the ``(B, 4, 2)`` batch users pass
to ``aca_h``, in one dispatch, two-point K fit to cancel dispatch overhead.
Same work per step as the reference's CUDA kernel (16 floats in, 9 out per
hypothesis, 100 B).  The roofline is the device's memory bandwidth from
:data:`DEVICE_PEAKS`.

Run: python bench.py [--batch B]
"""

import json
import sys

BASELINE_H_PER_S = 1_000_000 / 245e-6  # reference CUDA ACA @ B=1M

#: Published peaks by ``jax.devices()[0].device_kind``.  Source: NVIDIA H100
#: SXM data sheet (700 W): HBM3 3.35 TB/s.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0},
}


def device_peaks(device_kind: str) -> dict:
    """The peak table entry for ``device_kind``; an unknown kind is an error."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add it to "
            "sks_tpu.bench.headline.DEVICE_PEAKS with its source"
        ) from None


def main(argv=None):
    import argparse

    import jax
    import jax.numpy as jnp

    from sks_tpu.bench.table8 import aos_chained, measure_chained
    from sks_tpu.utils.compile_cache import enable_compile_cache
    from sks_tpu.utils.flops import bytes_per_hypothesis, roofline_hps
    from sks_tpu.utils.synth import random_quad_pairs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1 << 20)
    batch = ap.parse_args(argv).batch
    enable_compile_cache()
    device_kind = jax.devices()[0].device_kind
    peaks = device_peaks(device_kind)
    src, tar = jax.block_until_ready(jax.jit(
        lambda k: random_quad_pairs(k, batch, jnp.float32)
    )(jax.random.PRNGKey(0)))
    sec = measure_chained(
        lambda k: float(aos_chained(src, tar, k, name="aca")))
    hps = batch / sec
    gbps = hps * bytes_per_hypothesis(4) / 1e9
    print(json.dumps({
        "metric": "aca_homographies_per_sec_per_chip",
        "value": hps,
        "unit": "H/s",
        "vs_baseline": hps / BASELINE_H_PER_S,
        "platform": jax.devices()[0].platform,
        "device_kind": device_kind,
        "device_count": len(jax.devices()),
        "batch": batch,
        "hbm_spec_gbps": peaks["hbm_gbps"],
        "effective_gbps": gbps,
        "roofline_hps_hbm": roofline_hps(peaks["hbm_gbps"]),
        "roofline_fraction": gbps / peaks["hbm_gbps"],
    }))


if __name__ == "__main__":
    sys.exit(main())
