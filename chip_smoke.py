#!/usr/bin/env python
"""Run the library's main path once on a GPU and check every result.

    python chip_smoke.py               # one card: device, solve, fit, vo, ba
    python chip_smoke.py --four-cards  # the sharded paths on a 4-card mesh only

Each phase drives the public entry points at the sizes users run and compares
what comes out with an independent reference: the native fp64 C++ oracle
(``native/``), the synthesised ground truth, or the plain XLA path.  Every
line that carries a number also carries the card's name and power limit.  A
phase that fails raises; nothing is caught.  The last line of standard output
is one JSON object, printed only when every phase passed:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

The script needs a GPU: on any other backend it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

CARD = ""  # "name, power limit" from nvidia-smi, set by phase_device


class CheckFailed(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def report(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg} | card: {CARD}", flush=True)


def timed(fn, *args, reps: int = 5):
    """(result, median seconds) over ``reps`` calls after one warm-up call."""
    import jax

    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times))


# --------------------------------------------------------------------------
# device


def phase_device(expected_count: int):
    global CARD
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU backend, found {backend!r}")
    devs = jax.devices()
    check(len(devs) >= expected_count,
          f"{len(devs)} GPUs visible, {expected_count} needed")
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    report("device", f"jax {jax.__version__}, {len(devs)} x "
           f"{devs[0].device_kind}, jax_default_matmul_precision="
           f"{jax.config.jax_default_matmul_precision}")
    return devs


# --------------------------------------------------------------------------
# solve: six solvers at the reference's Table-8 batch, f32 and f64


#: sks_tpu.SOLVERS name -> native oracle name.
_ORACLE = {"aca": "aca", "sks": "sks", "rho_ge": "ge", "gpt_lu": "gpt",
           "ho": "ho", "ndlt": "ndlt"}


def _fro(h: np.ndarray) -> np.ndarray:
    h = h / np.linalg.norm(h, axis=(-2, -1), keepdims=True)
    s = np.sign(h[..., 2:3, 2:3])
    return h * np.where(s == 0, 1.0, s)


#: Quads whose 4-point problem has a larger condition number than this are
#: left out of the solve phase's bounds (their maxima are printed).  A
#: well-spread quad sits near 6; 100 leaves out ~0.4% of random quads.
KAPPA_MAX = 100.0


def dlt_condition(src: np.ndarray, tar: np.ndarray) -> np.ndarray:
    """Condition number of each quad's 4-point homography problem.

    sigma_1 / sigma_8 of the 8x9 DLT system built from Hartley-normalised
    points (centroid at 0, mean distance sqrt 2), in float64.  (B, 4, 2)
    pairs -> (B,).  A quad with three nearly collinear corners (on both
    sides, as an exact homography keeps them) has a large value, and the
    float32 error of the closed-form solvers grows with it.
    """

    def hartley(p):
        c = p - p.mean(axis=-2, keepdims=True)
        d = np.linalg.norm(c, axis=-1).mean(axis=-1)[..., None, None]
        return c * (np.sqrt(2.0) / d)

    a, b = hartley(np.asarray(src, np.float64)), hartley(
        np.asarray(tar, np.float64))
    x, y, u, v = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    one, zero = np.ones_like(x), np.zeros_like(x)
    rows_u = np.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], -1)
    rows_v = np.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], -1)
    sv = np.linalg.svd(np.concatenate([rows_u, rows_v], axis=-2),
                       compute_uv=False)
    return sv[..., 0] / sv[..., 7]


def phase_solve(batch: int = 1 << 20, sub: int = 1 << 16):
    import jax
    import jax.numpy as jnp

    import sks_tpu
    from sks_tpu import native
    from sks_tpu.utils.synth import random_correspondences

    for dtype in ("float32", "float64"):
        with jax.enable_x64(dtype == "float64"):
            src, tar, _ = jax.jit(
                lambda k: random_correspondences(k, (batch,), 4, 0.0,
                                                 jnp.dtype(dtype))
            )(jax.random.PRNGKey(1))
            s_np = np.asarray(src[:sub], np.float64)
            t_np = np.asarray(tar[:sub], np.float64)
            held = dlt_condition(s_np, t_np) <= KAPPA_MAX
            scope = (f"max over the {int(held.sum())} of {sub} quads with "
                     f"condition <= {KAPPA_MAX:g}")
            for name, fn in sks_tpu.SOLVERS.items():
                h, sec = timed(jax.jit(fn), src, tar)
                check(h.shape == (batch, 3, 3) and h.dtype == jnp.dtype(dtype),
                      f"{name} {dtype}: shape {h.shape} dtype {h.dtype}")
                hs = np.asarray(h[:sub], np.float64)
                finite = float(np.mean(np.isfinite(hs).all(axis=(1, 2))))
                check(finite == 1.0,
                      f"{name} {dtype}: {1 - finite:.2e} non-finite")
                # Max corner reprojection per quad: exact 4-point input, so
                # H must map each source corner onto its target.
                hom = np.concatenate([s_np, np.ones_like(s_np[..., :1])], -1)
                proj = np.einsum("bij,bkj->bki", hs, hom)
                rep = np.linalg.norm(proj[..., :2] / proj[..., 2:] - t_np,
                                     axis=-1).max(axis=-1)
                if dtype == "float64":
                    ref = native.solve_batch(_ORACLE[name], s_np, t_np)
                    err = np.abs(_fro(hs) - _fro(ref)).max(axis=(1, 2))
                    tol = 1e-9
                    what = "|H - H_oracle| (Frobenius-normalised)"
                    check(rep.max() <= 1e-8,
                          f"{name} f64: max reprojection {rep.max():.3e} px")
                    extra = (f"; all quads: reprojection max {rep.max():.3e}"
                             " px <= 1e-8")
                else:
                    err, tol = rep, 5e-3
                    what = "corner reprojection px"
                    extra = ""
                worst = float(err[held].max())
                check(worst <= tol, f"{name} {dtype}: {what} {worst:.3e} > "
                      f"{tol:g} ({scope})")
                report("solve", f"{name:6s} {dtype} B={batch} "
                       f"{sec * 1e3:.3f} ms/batch ({batch / sec:.4e} H/s); "
                       f"{what} {worst:.3e} <= {tol:g}, {scope}; the other "
                       f"{int((~held).sum())}: max "
                       f"{err[~held].max(initial=0.0):.3e}{extra}")


# --------------------------------------------------------------------------
# fit: OpenCV's findHomography defaults on 64 batched pairs


def _contaminated_pairs(key, pairs: int, n: int, outlier_frac: float,
                        noise: float):
    import jax
    import jax.numpy as jnp

    from sks_tpu.utils.synth import random_correspondences

    k1, k2 = jax.random.split(key)
    src, tar, h = random_correspondences(k1, (pairs,), n, noise, jnp.float32)
    n_out = int(n * outlier_frac)
    junk = jax.random.uniform(k2, (pairs, n_out, 2), jnp.float32, 0.0, 640.0)
    tar = tar.at[:, :n_out].set(junk)
    return src, tar, h, jnp.arange(n) >= n_out


def _corner_error(h_est, h_true):
    """Mean distance (px) between the 640x480 frame's corners under two Hs."""
    c = np.array([[0, 0, 1], [640, 0, 1], [0, 480, 1], [640, 480, 1]], float)

    def proj(h):
        p = np.einsum("bij,kj->bki", np.asarray(h, np.float64), c)
        return p[..., :2] / p[..., 2:]

    return np.linalg.norm(proj(h_est) - proj(h_true), axis=-1).mean(axis=-1)


def phase_fit(pairs: int = 64, n: int = 2000):
    import jax

    import sks_tpu
    from sks_tpu.robust.ransac import score_hypotheses

    thr = 3.0
    src, tar, h_true, clean = jax.jit(
        lambda k: _contaminated_pairs(k, pairs, n, 0.5, 1.0)
    )(jax.random.PRNGKey(2))
    # Reference mask: what an oracle holding H_true reports at the user's
    # threshold, on the uncontaminated points.
    ref_mask = jax.vmap(
        lambda h, s, t: score_hypotheses(h[None], s, t, thr)[1][0]
    )(h_true, src, tar) & clean
    for conf in (0.995, None):
        fit = jax.jit(lambda s, t, c=conf: sks_tpu.find_homography(
            s, t, method="ransac", ransac_reproj_threshold=thr,
            max_iters=2048, confidence=c))
        (h, mask), sec = timed(fit, src, tar, reps=3)
        err = _corner_error(h, h_true)
        agree = np.mean(np.asarray(mask) == np.asarray(ref_mask), axis=-1)
        label = f"confidence={conf}" if conf else "fixed batch"
        check(float(err.max()) < 1.0,
              f"fit {label}: worst mean corner error {err.max():.3f} px >= 1")
        check(float(agree.min()) > 0.95,
              f"fit {label}: worst mask agreement {agree.min():.4f} <= 0.95")
        report("fit", f"find_homography {label}, {pairs} pairs x N={n}, "
               f"50% outliers, f32: {sec * 1e3:.2f} ms/call "
               f"({pairs / sec:.1f} fits/s); corner error mean "
               f"{err.mean():.4f} max {err.max():.4f} px < 1; mask agreement "
               f"min {agree.min():.4f} > 0.95")


# --------------------------------------------------------------------------
# vo: rendered 640x480 planar sequence -> poses


def phase_vo(frames_n: int = 16, shape=(480, 640), focal: float = 600.0):
    import jax
    import jax.numpy as jnp

    from sks_tpu.data.images import planar_sequence
    from sks_tpu.robust.ransac import RansacConfig
    from sks_tpu.slam.pipeline import frames_to_poses, planar_slam
    from sks_tpu.slam.posegraph import ate_rmse

    key = jax.random.PRNGKey(3)
    frames, poses_gt, k_mat = planar_sequence(key, frames_n, shape,
                                              focal=focal)
    path = float(jnp.sum(jnp.linalg.norm(
        jnp.diff(poses_gt[:, :3, 3], axis=0), axis=-1)))
    bound = 0.12 * path + 0.02
    config = RansacConfig(num_hypotheses=1024, threshold=2.0, refine_iters=2)
    runs = (
        ("planar_slam esm_iters=8",
         jax.jit(lambda k, f, km: planar_slam(k, f, km, config,
                                              plane_depth=3.0))),
        ("frames_to_poses",
         jax.jit(lambda k, f, km: frames_to_poses(k, f, km, config,
                                                  plane_depth=3.0))),
    )
    for label, fn in runs:
        out, sec = timed(fn, key, frames, k_mat, reps=3)
        check(bool(jnp.all(jnp.isfinite(out["poses"]))), f"{label}: non-finite")
        ate = float(ate_rmse(out["poses"], poses_gt))
        check(ate < bound, f"{label}: ATE {ate:.4f} >= {bound:.4f}")
        report("vo", f"{label}, {frames_n} frames {shape[1]}x{shape[0]}, f32: "
               f"{sec * 1e3:.1f} ms/sequence ({(frames_n - 1) / sec:.1f} "
               f"pairs/s); ATE {ate:.5f} < 0.12 * path({path:.3f}) + 0.02")


# --------------------------------------------------------------------------
# ba: dense Schur bundle adjustment to convergence


def phase_ba(cams: int = 20, points: int = 10_240, max_iters: int = 20):
    import jax

    from sks_tpu.slam.ba import gauss_newton_step, rms_reprojection, synth_ba_problem

    noise_px = 0.5
    gt, prob = synth_ba_problem(jax.random.PRNGKey(4), cams, points,
                                noise_px=noise_px)
    step = jax.jit(gauss_newton_step)
    jax.block_until_ready(step(prob, 1e-4))
    rms = [float(rms_reprojection(prob))]
    t0 = time.perf_counter()
    for _ in range(max_iters):
        prob = step(prob, 1e-4)
        rms.append(float(rms_reprojection(prob)))
        if abs(rms[-2] - rms[-1]) <= 1e-5 * rms[-1]:
            break
    sec = (time.perf_counter() - t0) / (len(rms) - 1)
    # Noise floor of the least-squares fit: sigma * sqrt(1 - p/m), with p
    # free parameters (camera 0 is the gauge) and m scalar residuals.
    m = 2.0 * float(np.asarray(prob.mask).sum())
    p = 6 * (cams - 1) + 3 * points
    floor = noise_px * np.sqrt(1.0 - p / m)
    check(abs(rms[-1] / floor - 1.0) <= 0.05,
          f"ba: RMS {rms[-1]:.5f} px vs floor {floor:.5f} px, beyond 5%")
    report("ba", f"{cams} cams x {points} landmarks, f32, {len(rms) - 1} "
           f"GN steps at {sec * 1e3:.2f} ms/step; RMS {rms[0]:.3f} -> "
           f"{rms[-1]:.5f} px vs noise floor {floor:.5f} px (within 5%)")


# --------------------------------------------------------------------------
# four cards: the sharded paths on a 4-GPU mesh


def phase_four_cards(devs, hyp: int = 1 << 16, cams: int = 20,
                     points: int = 10_240):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from sks_tpu.parallel import make_mesh, sharded_ransac_homography
    from sks_tpu.parallel.sharded_ba import shard_problem, sharded_gauss_newton_step
    from sks_tpu.robust.ransac import RansacConfig
    from sks_tpu.slam.ba import gauss_newton_step, rms_reprojection, synth_ba_problem

    gpu_mesh = make_mesh({"hyp": 4}, devices=devs[:4])
    cpu_mesh = Mesh(np.array(jax.devices("cpu")[:4]), ("hyp",))
    src, tar, _, _ = jax.jit(
        lambda k: _contaminated_pairs(k, 1, 2000, 0.5, 1.0))(
            jax.random.PRNGKey(8))
    src, tar = src[0], tar[0]
    key = jax.random.PRNGKey(9)
    config = RansacConfig(num_hypotheses=hyp, threshold=3.0)
    out = {}
    for label, mesh in (("gpu", gpu_mesh), ("cpu", cpu_mesh)):
        args = jax.device_put((key, src, tar), NamedSharding(mesh, P()))
        fit = jax.jit(lambda k, s, t, m=mesh: sharded_ransac_homography(
            m, k, s, t, config))
        res, sec = timed(fit, *args, reps=3)
        out[label] = res
        report("four-cards", f"sharded_ransac_homography on 4 {label} "
               f"devices, B={config.num_hypotheses} N=2000 f32: "
               f"{sec * 1e3:.2f} ms; {int(res.num_inliers)} inliers")
    hg = np.asarray(out["gpu"].h, np.float64)
    hc = np.asarray(out["cpu"].h, np.float64)
    dh = float(np.max(np.abs(_fro(hg) - _fro(hc))))
    dn = abs(int(out["gpu"].num_inliers) - int(out["cpu"].num_inliers))
    # Same key, same hypothesis streams; the polish's float sums run in
    # another order on each backend.
    check(dh < 1e-3 and dn <= 2,
          f"sharded RANSAC gpu vs cpu: |dH| {dh:.2e}, inliers differ by {dn}")
    report("four-cards", f"sharded RANSAC 4 GPUs vs 4 CPUs, same key: max "
           f"|dH| {dh:.2e} < 1e-3 (Frobenius-normalised), inliers differ by "
           f"{dn} <= 2")

    # One GN step from the synthetic start solves a Schur system whose gauge
    # row carries 1e12: in float32 the psum's summation order alone moves the
    # step.  The card has native float64, so the two are compared there.
    lm_mesh = make_mesh({"lm": 4}, devices=devs[:4])
    with jax.enable_x64(True):
        _, prob = synth_ba_problem(jax.random.PRNGKey(4), cams, points,
                                   dtype=jnp.float64)
        single, sec1 = timed(jax.jit(gauss_newton_step), prob, 1e-4, reps=3)
        sharded, sec4 = timed(
            lambda p: sharded_gauss_newton_step(lm_mesh, p, 1e-4),
            shard_problem(prob, lm_mesh), reps=3)
        r1 = float(rms_reprojection(single))
        r4 = float(rms_reprojection(sharded))
        dp = float(np.max(np.abs(np.asarray(sharded.poses)
                                 - np.asarray(single.poses))))
    check(dp < 1e-8 and abs(r1 - r4) <= 1e-9 * r1,
          f"sharded BA step: |dpose| {dp:.2e}, RMS {r4:.9f} vs {r1:.9f}")
    report("four-cards", f"BA GN step {cams} cams x {points} landmarks f64: "
           f"1 GPU {sec1 * 1e3:.2f} ms, 4 GPUs {sec4 * 1e3:.2f} ms; max "
           f"|dpose| {dp:.2e} < 1e-8, RMS {r4:.9f} vs {r1:.9f} px "
           "(relative 1e-9)")

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on a 4-GPU mesh")
    args = ap.parse_args(argv)
    if args.four_cards:
        # Four host CPU devices run the same sharded program as the
        # reference.  XLA reads this flag when the CPU backend starts.
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_force_host_platform_device_count=4")

    import jax

    from sks_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    count = 4 if args.four_cards else 1
    devs = phase_device(count)
    if args.four_cards:
        phase_four_cards(devs)
    else:
        for phase in (phase_solve, phase_fit, phase_vo, phase_ba):
            t0 = time.perf_counter()
            phase()
            report(phase.__name__[6:], f"phase done in "
                   f"{time.perf_counter() - t0:.1f} s, compilation included")
    dev = jax.devices()[0]
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
