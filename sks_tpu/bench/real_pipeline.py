"""Image-grounded end-to-end benchmark: inlier parity vs cv2 + VO ATE.

Closes the BASELINE configs the synthetic harnesses cannot (real-style
pixels in, homography/trajectory out).  Two stages, one CLI:

1. **Pair parity** — P rendered planar pairs (``data/images.planar_pair``:
   textured plane, exact GT homography, photometric nuisances).  The feature
   pipeline (pyramid Harris + oriented patches + mutual-NN/ratio matching)
   produces *image-derived* matches; ``find_homography`` and
   ``cv2.findHomography`` run on the SAME matches at the same threshold and
   are scored per pair on (a) inlier-set agreement and (b) max corner error
   vs the exact GT H.  This plays the role the reference's real wall scene
   plays for its harnesses (``main.cpp:21-30`` sampling
   ``orig_pts_wall.txt``), with the GT the wall scene lacks.

2. **Sequence ATE** — a T-frame rendered plane sweep
   (``data/images.planar_sequence``); matches between consecutive frames feed
   ``slam.odometry.vo_trajectory`` (homography chain -> pose), and absolute
   trajectory error is computed against the exact GT poses.

Run:  python -m sks_tpu.bench.real_pipeline [--pairs 8] [--frames 12]
      [--out bench_results/REAL_PIPELINE.json]
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np

from sks_tpu.data.images import planar_pair, planar_sequence
from sks_tpu.features.matching import match_frames_oriented
from sks_tpu.geom.homography import apply_homography
from sks_tpu.robust import find_homography

__all__ = ["pair_parity", "sequence_ate", "run", "run_photo_suite"]


def _corner_err(h, h_true, shape) -> float:
    hh, ww = shape
    corners = jnp.asarray(
        [[0.0, 0.0], [ww, 0.0], [0.0, hh], [ww, hh]], jnp.float32
    )
    d = apply_homography(h, corners) - apply_homography(h_true, corners)
    return float(jnp.max(jnp.linalg.norm(d, axis=-1)))


#: Hard-protocol nuisances: defocus blur on the second
#: view, ~2x the default viewpoint rotation, shifts large enough for ~1.2x
#: scale change.  Easy protocol = planar_pair defaults.
_HARD_KW = dict(max_angle=0.28, max_shift=0.4, blur_sigma=1.0)


def pair_parity(seed: int, num_pairs: int = 8, shape=(480, 640),
                threshold: float = 3.0, method: str = "ransac",
                texture: str = "procedural", protocol: str = "easy",
                esm: bool = False):
    """Per-pair inlier parity of find_homography vs cv2.findHomography.

    ``texture`` names a bundled photograph (``data/images._PHOTO_CANDIDATES``:
    'hopper', 'flower', 'china') to render every pair from real photographic
    pixels instead of the procedural plane — the HPatches ``v_*`` viewpoint
    protocol (one real planar scene, many camera poses), so real pixels flow
    through detection, description, matching, and the robust fit.
    ``protocol='hard'`` adds defocus blur + stronger viewpoint/scale change.
    ``esm=True`` additionally dense-polishes our fitted model photometrically
    (``slam.tracking.esm_polish_pair``) and records its corner error — what direct alignment buys
    on top of the feature pipeline.
    """
    import cv2

    tex = None
    if texture not in ("procedural",):
        from sks_tpu.data.images import photo_texture

        name = "hopper" if texture == "photo" else texture
        tex = photo_texture(shape, name=name)
        if tex is None:
            raise RuntimeError(f"bundled photograph {name!r} unavailable "
                               "(PIL or sample data missing)")
    kw = _HARD_KW if protocol == "hard" else {}
    rows = []
    for i in range(num_pairs):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), i)
        offplane = None
        if protocol == "parallax":
            # Off-plane structure: textured boxes in
            # closer parallel planes — matches on them are coherent
            # alternative-homography outliers, not i.i.d. junk.
            from sks_tpu.data.images import planar_pair_boxes

            img1, img2, h_true, mbox1, mbox2 = planar_pair_boxes(
                key, shape, texture=tex)
        else:
            img1, img2, h_true = planar_pair(key, shape, texture=tex, **kw)
        p1, p2, valid, _ = match_frames_oriented(img1, img2, 512, 3)
        v = np.asarray(valid)
        a = np.asarray(p1)[v]
        b = np.asarray(p2)[v]
        if protocol == "parallax":
            def _on(mask, pts):
                yy = np.clip(pts[:, 1].astype(int), 0, shape[0] - 1)
                xx = np.clip(pts[:, 0].astype(int), 0, shape[1] - 1)
                return np.asarray(mask)[yy, xx]

            offplane = _on(mbox1, a) | _on(mbox2, b)
        if a.shape[0] < 8:
            rows.append({"pair": i, "matches": int(a.shape[0]),
                         "skipped": "too few matches"})
            continue

        # Fixed-shape fit: padded match arrays + point_mask, so ONE compiled
        # RANSAC program serves every pair (a per-pair variable N would
        # recompile the whole graph each time — slow, and the LLVM JIT mmaps
        # eventually exhaust vm.max_map_count in long suites).
        center = jnp.asarray([shape[1] / 2.0, shape[0] / 2.0], jnp.float32)
        p1f = jnp.where(valid[..., None], p1, center)
        p2f = jnp.where(valid[..., None], p2, center)
        h_ours, mask_padded = find_homography(
            p1f, p2f, method=method,
            ransac_reproj_threshold=threshold, max_iters=2048,
            key=jax.random.fold_in(key, 99), point_mask=valid,
        )
        mask_ours = np.asarray(mask_padded)[v]

        h_cv, mask_cv = cv2.findHomography(
            a, b, cv2.RANSAC, threshold, maxIters=2048, confidence=0.999
        )
        mask_cv = mask_cv.reshape(-1).astype(bool)

        # Same-rule parity: our native mask is *symmetric*-transfer (stricter
        # than cv2's forward-only reprojection rule), so raw mask agreement
        # systematically undercounts.  Score both fitted models under cv2's
        # own forward rule for the apples-to-apples number.
        def fwd_mask(h):
            h = np.asarray(h, np.float64)
            p = np.concatenate([a, np.ones_like(a[:, :1])], axis=1) @ h.T
            p = p[:, :2] / p[:, 2:3]
            return np.sum((p - b) ** 2, axis=1) < threshold * threshold

        m_ours_fwd = fwd_mask(h_ours)
        m_cv_fwd = fwd_mask(h_cv)
        agree = float(np.mean(m_ours_fwd == m_cv_fwd))
        inter = np.sum(m_ours_fwd & m_cv_fwd)
        union = max(int(np.sum(m_ours_fwd | m_cv_fwd)), 1)
        row = {
            "pair": i,
            "matches": int(a.shape[0]),
            "inliers_ours": int(m_ours_fwd.sum()),
            "inliers_cv2": int(m_cv_fwd.sum()),
            "inliers_ours_native_symmetric": int(mask_ours.sum()),
            "inliers_cv2_native": int(mask_cv.sum()),
            "inlier_agreement": agree,
            "inlier_jaccard": float(inter / union),
            "corner_err_ours_px": _corner_err(h_ours, h_true, shape),
            "corner_err_cv2_px": _corner_err(
                jnp.asarray(h_cv, jnp.float32), h_true, shape),
        }
        if offplane is not None:
            row["offplane_match_frac"] = float(offplane.mean())
            # A correct planar fit must reject off-plane matches: report the
            # off-plane leak rate into each side's inlier set.
            row["offplane_inlier_leak_ours"] = int(
                (m_ours_fwd & offplane).sum())
            row["offplane_inlier_leak_cv2"] = int((m_cv_fwd & offplane).sum())
        if esm:
            from sks_tpu.slam.tracking import (
                esm_guard,
                esm_polish_pair_symmetric,
            )

            # The production polish (round 5): symmetric full-frame — what
            # fit_pair applies and what the VO rows measure.
            h_esm, rms = esm_polish_pair_symmetric(img1, img2, h_ours,
                                                   iters=8)
            ok = esm_guard(h_ours, h_esm, p1f, p2f, mask_padded)
            h_sel = jnp.where(ok, h_esm, h_ours)
            row["corner_err_esm_raw_px"] = _corner_err(h_esm, h_true, shape)
            row["corner_err_esm_px"] = _corner_err(h_sel, h_true, shape)
            row["esm_accepted"] = bool(ok)
            row["esm_rms"] = float(rms)
        rows.append(row)
    return rows


def sequence_ate(seed: int, num_frames: int = 12, shape=(240, 320),
                 threshold: float = 2.0, texture: str = "procedural",
                 esm_iters: int = 0):
    """ATE of the VO chain on a rendered plane sweep vs exact GT poses.

    ``texture`` names a bundled photograph (like :func:`pair_parity`) so the
    full VO stack — detection, matching, RANSAC, pose chain — runs on real
    photographic pixels.
    """
    from sks_tpu.robust.ransac import RansacConfig
    from sks_tpu.slam.odometry import vo_trajectory

    tex = None
    if texture not in ("procedural",):
        from sks_tpu.data.images import photo_texture

        name = "hopper" if texture == "photo" else texture
        tex = photo_texture(shape, name=name)
        if tex is None:
            raise RuntimeError(f"bundled photograph {name!r} unavailable")
    key = jax.random.PRNGKey(seed)
    frames, poses_gt, k_mat = planar_sequence(key, num_frames, shape,
                                              texture=tex)

    p1s, p2s, masks = [], [], []
    for i in range(num_frames - 1):
        p1, p2, valid, _ = match_frames_oriented(
            frames[i], frames[i + 1], 384, 2
        )
        p1s.append(p1)
        p2s.append(p2)
        masks.append(valid)
    p1s = jnp.stack(p1s)
    p2s = jnp.stack(p2s)
    masks = jnp.stack(masks)
    # Neutral padding (image center, zero motion): masked out of RANSAC
    # scoring by point_mask; harmless to the cheirality vote.
    center = jnp.asarray([shape[1] / 2.0, shape[0] / 2.0], jnp.float32)
    p1s = jnp.where(masks[..., None], p1s, center)
    p2s = jnp.where(masks[..., None], p2s, center)

    config = RansacConfig(num_hypotheses=2048, threshold=threshold,
                          refine_iters=3)
    out = vo_trajectory(
        jax.random.fold_in(key, 7), p1s, p2s, k_mat, config,
        plane_depth=3.0, point_mask=masks,
        frames=(frames if esm_iters else None), esm_iters=esm_iters,
    )
    pos = np.asarray(out["poses"][:, :3, 3])
    pos_gt = np.asarray(poses_gt[:, :3, 3])
    ate_rmse = float(np.sqrt(np.mean(np.sum((pos - pos_gt) ** 2, axis=-1))))
    path_len = float(np.sum(np.linalg.norm(np.diff(pos_gt, axis=0), axis=-1)))
    return {
        "frames": num_frames,
        "ate_rmse": ate_rmse,
        "path_length": path_len,
        "ate_pct_of_path": 100.0 * ate_rmse / max(path_len, 1e-9),
        "mean_inliers": float(np.mean(np.asarray(out["num_inliers"]))),
    }


def loop_closure_ate(seed: int, num_frames: int = 16, shape=(240, 320),
                     threshold: float = 2.0, strides=(4, 8),
                     texture: str = "procedural"):
    """ATE with vs without loop closures on a closed-circuit rendered sweep.

    Renders a loopy trajectory (``planar_sequence(loop=True)``), matches
    consecutive pairs AND frame-i<->frame-i+k candidate pairs
    (``slam.odometry.closure_candidates``), and reports ATE for (a) the raw
    odometry chain, (b) pose-graph smoothing over odometry edges only, and
    (c) smoothing with genuine loop-closure edges — the drift-correction
    mechanism the pose graph exists for.
    """
    from sks_tpu.robust.ransac import RansacConfig
    from sks_tpu.slam.odometry import closure_candidates, vo_trajectory

    tex = None
    if texture not in ("procedural",):
        from sks_tpu.data.images import photo_texture

        name = "hopper" if texture == "photo" else texture
        tex = photo_texture(shape, name=name)
    key = jax.random.PRNGKey(seed)
    frames, poses_gt, k_mat = planar_sequence(key, num_frames, shape,
                                              texture=tex, loop=True)

    def match_pairs(pairs, feats, levels):
        p1s, p2s, masks = [], [], []
        for i, j in pairs:
            p1, p2, valid, _ = match_frames_oriented(
                frames[i], frames[j], feats, levels
            )
            p1s.append(p1)
            p2s.append(p2)
            masks.append(valid)
        center = jnp.asarray([shape[1] / 2.0, shape[0] / 2.0], jnp.float32)
        p1s = jnp.stack(p1s)
        p2s = jnp.stack(p2s)
        masks = jnp.stack(masks)
        p1s = jnp.where(masks[..., None], p1s, center)
        p2s = jnp.where(masks[..., None], p2s, center)
        return p1s, p2s, masks

    consec = [(i, i + 1) for i in range(num_frames - 1)]
    p1s, p2s, masks = match_pairs(consec, 384, 2)
    closures = closure_candidates(num_frames, strides)
    c1s, c2s, cmasks = match_pairs(closures, 384, 2)
    cp = jnp.asarray(closures, jnp.int32)

    config = RansacConfig(num_hypotheses=2048, threshold=threshold,
                          refine_iters=3)
    kf = jax.random.fold_in(key, 7)

    def ate(out):
        pos = np.asarray(out["poses"][:, :3, 3])
        pos_gt = np.asarray(poses_gt[:, :3, 3])
        return float(np.sqrt(np.mean(np.sum((pos - pos_gt) ** 2, axis=-1))))

    kw = dict(plane_depth=3.0, point_mask=masks)
    out_odo = vo_trajectory(kf, p1s, p2s, k_mat, config, **kw)
    out_smooth = vo_trajectory(kf, p1s, p2s, k_mat, config, smooth=True, **kw)
    out_loop = vo_trajectory(
        kf, p1s, p2s, k_mat, config, smooth=True, closure_pairs=cp,
        closure_pts1=c1s, closure_pts2=c2s, closure_mask=cmasks, **kw
    )
    pos_gt = np.asarray(poses_gt[:, :3, 3])
    path_len = float(np.sum(np.linalg.norm(np.diff(pos_gt, axis=0), axis=-1)))
    return {
        "frames": num_frames,
        "texture": texture,
        "closure_edges": len(closures),
        "closure_mean_inliers": float(
            np.mean(np.asarray(out_loop["closure_inliers"]))),
        "path_length": path_len,
        "ate_odometry": ate(out_odo),
        "ate_smooth_no_closures": ate(out_smooth),
        "ate_smooth_with_closures": ate(out_loop),
    }


def _summarize(pairs):
    scored = [r for r in pairs if "skipped" not in r]
    ratios = [
        r["corner_err_ours_px"] / max(r["corner_err_cv2_px"], 1e-9)
        for r in scored
    ]
    out = {
        "n": len(scored),
        "mean_inlier_agreement": float(
            np.mean([r["inlier_agreement"] for r in scored])),
        "mean_inlier_jaccard": float(
            np.mean([r["inlier_jaccard"] for r in scored])),
        "mean_corner_err_ours_px": float(
            np.mean([r["corner_err_ours_px"] for r in scored])),
        "mean_corner_err_cv2_px": float(
            np.mean([r["corner_err_cv2_px"] for r in scored])),
        "max_corner_err_ratio_vs_cv2": float(np.max(ratios)) if ratios else None,
    }
    if scored and "corner_err_esm_px" in scored[0]:
        out["mean_corner_err_esm_px"] = float(
            np.mean([r["corner_err_esm_px"] for r in scored]))
    return out


def run(seed: int = 0, num_pairs: int = 8, num_frames: int = 12,
        texture: str = "procedural", protocol: str = "easy",
        esm: bool = False):
    pairs = pair_parity(seed, num_pairs, texture=texture, protocol=protocol,
                        esm=esm)
    ate = sequence_ate(seed, num_frames, texture=texture)
    ate["texture"] = texture
    summary = {
        "texture": texture,
        "protocol": protocol,
        "pairs": pairs,
        "pair_summary": _summarize(pairs),
        "sequence": ate,
    }
    return summary


def run_photo_suite(seed: int = 0, num_pairs: int = 8, num_frames: int = 12,
                    esm: bool = False):
    """The full real-photo protocol: every bundled photograph, easy + hard
    nuisances, and a photo-textured VO sequence per photograph.  With
    ``esm``, every pair also gets the dense ESM polish column and each VO
    sequence runs twice (with/without per-pair ESM)."""
    from sks_tpu.data.images import available_photos

    out = {"textures": {}, "protocols": ("easy", "hard"), "esm": esm}
    all_rows = {"easy": [], "hard": []}
    for name in available_photos():
        entry = {}
        for protocol in ("easy", "hard"):
            rows = pair_parity(seed, num_pairs, texture=name,
                               protocol=protocol, esm=esm)
            entry[protocol] = {"pairs": rows, "summary": _summarize(rows)}
            all_rows[protocol].extend(rows)
        entry["sequence"] = sequence_ate(seed, num_frames, texture=name)
        if esm:
            entry["sequence_esm"] = sequence_ate(seed, num_frames,
                                                 texture=name, esm_iters=8)
        out["textures"][name] = entry
    out["overall"] = {p: _summarize(all_rows[p]) for p in all_rows}
    return out


def main(argv=None):
    """Console entry point (``sks-real-pipeline``)."""
    import argparse

    # The pipeline is feature-bound and parity/ATE are hardware-independent;
    # run hermetically on the CPU backend (the committed artifacts are CPU,
    # and the per-match host readbacks gain nothing from an accelerator).
    jax.config.update("jax_platforms", "cpu")

    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--texture",
                    choices=("procedural", "photo", "hopper", "flower",
                             "china"),
                    default="procedural",
                    help="a bundled photograph name renders pairs AND the VO "
                         "sequence from real pixels ('photo' = 'hopper')")
    ap.add_argument("--protocol", choices=("easy", "hard", "parallax"),
                    default="easy")
    ap.add_argument("--photo-suite", action="store_true",
                    help="run every bundled photograph x {easy, hard} + "
                         "photo VO sequences (the REAL_PHOTO.md protocol)")
    ap.add_argument("--esm", action="store_true",
                    help="add the dense ESM polish column + ESM VO rows")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.photo_suite:
        summary = run_photo_suite(args.seed, args.pairs, args.frames,
                                  esm=args.esm)
        print(json.dumps(summary["overall"], indent=1))
        for name, entry in summary["textures"].items():
            print(name, "sequence:", json.dumps(entry["sequence"]))
    else:
        summary = run(args.seed, args.pairs, args.frames,
                      texture=args.texture, protocol=args.protocol,
                      esm=args.esm)
        print(json.dumps(summary["pair_summary"], indent=1))
        print(json.dumps(summary["sequence"], indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
