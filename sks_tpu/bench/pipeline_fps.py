"""Pipeline-level frames/s: the BASELINE config-5 artifact.

Measures the ONE-JIT frames->poses pipeline (``slam.pipeline``) end to end —
pixels in, trajectory out — with the chained-dispatch methodology
(``bench/table8.measure_chained``): K serialized pipeline invocations in one dispatch,
two-point K fit to cancel dispatch overhead.  Run on the card for frames/s;
the 8-way CPU-mesh equality (sharded ==
single-device, bit-identical) is proven in tests/test_pipeline.py and the
driver dryrun.

Run:  python -m sks_tpu.bench.pipeline_fps [--frames 16] [--shape 240 320]
      [--out PATH]
"""

from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp

from sks_tpu.robust.ransac import RansacConfig
from sks_tpu.slam.pipeline import frames_to_poses

__all__ = ["measure_pipeline_fps", "measure_capstone_fps"]


def measure_pipeline_fps(num_frames: int = 16, shape=(240, 320),
                         num_corners: int = 384, hypotheses: int = 1024,
                         k1: int = 2, k2: int = 8, esm_iters: int = 0) -> dict:
    """Frames/s of the one-jit pipeline on the default backend (chained)."""
    from sks_tpu.data.images import planar_sequence

    key = jax.random.PRNGKey(0)
    # Render on CPU (data prep, not the benchmark), ship to device once.
    with jax.default_device(jax.devices("cpu")[0]):
        frames, _, k_mat = planar_sequence(key, num_frames, shape)
    frames = jax.device_put(frames, jax.devices()[0])
    k_mat = jax.device_put(k_mat, jax.devices()[0])
    jax.block_until_ready(frames)

    config = RansacConfig(
        num_hypotheses=hypotheses, threshold=2.0, refine_iters=2,
    )

    @jax.jit
    def chained(key, frames, k):
        # k is traced: one compilation serves both K points of the fit.
        def body(_, carry):
            # Serialize AND defeat loop-invariant code motion: the previous
            # checksum feeds both the key and a sub-roundoff frame nudge
            # (carry * 1e-38 == 0 in f32, but XLA cannot prove it), so the
            # FULL pipeline — detection, description, matching — re-executes
            # every iteration.  Without the nudge XLA hoists everything
            # key-independent out of the loop and the "steady state" times
            # only RANSAC+chaining (measured 30x optimistic — the round-3
            # 2,100 pairs/s artifact had exactly this flaw).
            k_step = jax.random.fold_in(key, (carry * 0.0).astype(jnp.int32))
            out = frames_to_poses(k_step, frames + carry * 1e-38, k_mat,
                                  config, num_corners=num_corners,
                                  esm_iters=esm_iters)
            return jnp.sum(out["poses"][:, :3, 3]) + carry * 1e-30

        return jax.lax.fori_loop(0, k, body, jnp.asarray(0.0, jnp.float32))

    def run(k):
        float(chained(key, frames, k))  # compile + warm
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            float(chained(key, frames, k))
            best = min(best, time.perf_counter() - t0)
        return best

    t1 = run(k1)
    t2 = run(k2)
    sec_per_invoke = max((t2 - t1) / (k2 - k1), 1e-9)
    # Each invoke ingests T frames and fits T-1 pairs.  In steady-state
    # video, every new frame contributes exactly one new pair, so pairs/s IS
    # the sustained frames/s; the chunked rate T/invoke is also reported.
    pps = (num_frames - 1) / sec_per_invoke
    return {
        "metric": "pipeline_pairs_per_sec_per_chip",
        "frames": num_frames,
        "esm_iters": esm_iters,
        "shape": list(shape),
        "num_corners": num_corners,
        "hypotheses_per_pair": hypotheses,
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "sec_per_pipeline_invoke": sec_per_invoke,
        "pairs_per_sec_steady_state_frames_per_sec": pps,
        "frames_per_chunked_invoke_per_sec": num_frames / sec_per_invoke,
    }


def measure_capstone_fps(num_frames: int = 16, shape=(240, 320),
                         num_corners: int = 384, hypotheses: int = 1024,
                         strides=(4, 8), k1: int = 2, k2: int = 8,
                         esm_iters: int = 0) -> dict:
    """Pairs/s of the FULL planar_slam capstone (closures + pose graph).

    Unlike :func:`measure_pipeline_fps` (odometry chain only), this times
    the one-call system a production caller invokes: consecutive AND
    closure-candidate matching/fitting, metric chaining, and pose-graph
    relaxation, all in one jit.
    """
    from sks_tpu.data.images import planar_sequence
    from sks_tpu.slam.odometry import closure_candidates
    from sks_tpu.slam.pipeline import planar_slam

    key = jax.random.PRNGKey(0)
    with jax.default_device(jax.devices("cpu")[0]):
        frames, _, k_mat = planar_sequence(key, num_frames, shape, loop=True)
    frames = jax.device_put(frames, jax.devices()[0])
    k_mat = jax.device_put(k_mat, jax.devices()[0])
    jax.block_until_ready(frames)

    config = RansacConfig(
        num_hypotheses=hypotheses, threshold=2.0, refine_iters=2,
    )
    n_closures = len(closure_candidates(num_frames, strides))
    total_pairs = (num_frames - 1) + n_closures

    @jax.jit
    def chained(key, frames, k):
        def body(_, carry):
            # Sub-roundoff frame nudge: see measure_pipeline_fps.
            k_step = jax.random.fold_in(key, (carry * 0.0).astype(jnp.int32))
            out = planar_slam(k_step, frames + carry * 1e-38, k_mat, config,
                              num_corners=num_corners, strides=strides,
                              esm_iters=esm_iters)
            return jnp.sum(out["poses"][:, :3, 3]) + carry * 1e-30

        return jax.lax.fori_loop(0, k, body, jnp.asarray(0.0, jnp.float32))

    def run(k):
        float(chained(key, frames, k))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            float(chained(key, frames, k))
            best = min(best, time.perf_counter() - t0)
        return best

    t1 = run(k1)
    t2 = run(k2)
    sec_per_invoke = max((t2 - t1) / (k2 - k1), 1e-9)
    return {
        "metric": "capstone_pairs_per_sec_per_chip",
        "frames": num_frames,
        "esm_iters": esm_iters,
        "closure_edges": n_closures,
        "total_pairs_per_invoke": total_pairs,
        "shape": list(shape),
        "num_corners": num_corners,
        "hypotheses_per_pair": hypotheses,
        "strides": list(strides),
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "sec_per_capstone_invoke": sec_per_invoke,
        "pairs_per_sec": total_pairs / sec_per_invoke,
        "frames_per_chunked_invoke_per_sec": num_frames / sec_per_invoke,
    }


def measure_all(num_frames: int = 16, shape=(240, 320),
                num_corners: int = 384, hypotheses: int = 1024) -> dict:
    """The full PIPELINE_FPS artifact: base + capstone + ESM + VGA rows."""
    res = measure_pipeline_fps(num_frames, shape, num_corners, hypotheses)
    res["capstone"] = measure_capstone_fps(num_frames, shape, num_corners,
                                           hypotheses)
    cap_esm = measure_capstone_fps(num_frames, shape, num_corners,
                                   hypotheses, esm_iters=8)
    res["capstone_esm_default"] = {
        "esm_iters": 8,
        "pairs_per_sec": cap_esm["pairs_per_sec"],
        "note": "planar_slam's round-5 DEFAULT config: guarded symmetric "
                "full-frame ESM polish on every pair (bf16 sampling)",
    }
    esm = measure_pipeline_fps(num_frames, shape, num_corners, hypotheses,
                               esm_iters=8)
    res["with_esm_polish"] = {
        "esm_iters": 8,
        "pairs_per_sec": esm["pairs_per_sec_steady_state_frames_per_sec"],
        "note": "frames_to_poses(esm_iters=8): per-pair guarded symmetric "
                "full-frame dense ESM polish (bf16 matmul sampling) on top "
                "of the feature fit",
    }
    vga = measure_pipeline_fps(num_frames, (480, 640), num_corners,
                               hypotheses)
    res["vga"] = {
        "shape": [480, 640],
        "pairs_per_sec": vga["pairs_per_sec_steady_state_frames_per_sec"],
        "sec_per_pipeline_invoke": vga["sec_per_pipeline_invoke"],
        "note": "same config at VGA resolution",
    }
    res["note"] = (
        "hoist-proof chained methodology (sub-roundoff frame nudge per "
        "iteration); per-frame cached detect/describe (each frame touched "
        "once, round 5); one-hot matmul descriptor sampling (no gathers); "
        "separable shifted-sum Harris; f32 matmul precision; median of 3"
    )
    res["orientation"] = "gradient (smoothed-gradient reference orientation)"
    return res


def main(argv=None):
    """Console entry point (``sks-pipeline-fps``)."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--shape", type=int, nargs=2, default=(240, 320))
    ap.add_argument("--corners", type=int, default=384)
    ap.add_argument("--hypotheses", type=int, default=1024)
    ap.add_argument("--capstone", action="store_true",
                    help="time the full planar_slam (closures + pose graph)")
    ap.add_argument("--all", action="store_true",
                    help="full artifact: base + capstone + ESM + VGA")
    ap.add_argument("--esm-iters", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        res = measure_all(args.frames, tuple(args.shape), args.corners,
                          args.hypotheses)
    elif args.capstone:
        res = measure_capstone_fps(args.frames, tuple(args.shape),
                                   args.corners, args.hypotheses)
    else:
        res = measure_pipeline_fps(args.frames, tuple(args.shape),
                                   args.corners, args.hypotheses,
                                   esm_iters=args.esm_iters)
    print(json.dumps(res, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
