"""Synthetic line, vanishing-point and multi-motion scenes — numpy copies
of progressivex_tpu/eval/extras.py's `make_lines_scene`, `make_vp_scene`
and `make_multi_motion_scene`, so that the port and the JAX package fit
the same scenes for the same seed — the keywords the JAX package runs
each path at, and its bench functions (`bench_lines`, `bench_vps`,
`bench_essential`) on the port's front ends, with the same keys.

- lines: the reference notebook `examples/example_multi_lines.ipynb`'s
  cardinality, 3180 edge points on 7 lines and clutter, with ground-truth
  labels;
- vanishing points: the inlier structure of
  `example_multi_vanishing_point.ipynb`, 80 / 57 / 39 segments of three
  VPs and 40 clutter segments;
- essential matrices: K rigid motions seen by two calibrated views
  (tests/test_gauntlet.py's two- and three-motion gauntlet scenes).
"""

from __future__ import annotations

import numpy as np

# findLines at bench_lines' keywords (progressivex_tpu/eval/extras.py:154-155),
# findVanishingPoints at bench_vps' (:205-209), find6DPoses on the bundled
# T-LESS scene at tests/test_pose6d.py's.
LINES_KW = dict(threshold=2.0, conf=0.9, minimum_point_number=30, sampler_id=0,
                maximum_model_number=12)
VP_KW = dict(threshold=1.5, conf=0.5, spatial_coherence_weight=0.0,
             neighborhood_ball_radius=200.0, maximum_tanimoto_similarity=0.4,
             max_iters=1000, minimum_point_number=15, maximum_model_number=5,
             sampler_id=0, scoring_exponent=2)
TLESS_KW = dict(threshold=4.0, conf=0.9, spatial_coherence_weight=0.1,
                neighborhood_ball_radius=20.0, maximum_tanimoto_similarity=0.9,
                max_iters=400, minimum_point_number=6)
# findEssentialMatrices at the gauntlet's keywords
# (tests/test_gauntlet.py:181-185, bench_essential's), with the
# intrinsics of make_multi_motion_scene's camera (f = 800).
ESSENTIAL_KW = dict(threshold=1.5, conf=0.5, spatial_coherence_weight=0.2,
                    neighborhood_ball_radius=60.0, maximum_tanimoto_similarity=0.4,
                    max_iters=1000, minimum_point_number=25, maximum_model_number=6,
                    sampler_id=0, scoring_exponent=2, n_restarts=3)


def gauntlet_camera(f=800.0):
    """The intrinsics K [3, 3] of make_multi_motion_scene's camera."""
    return np.array([[f, 0, 320.0], [0, f, 240.0], [0, 0, 1.0]])


def make_lines_scene(n_lines=7, per_line=400, n_outliers=380, seed=0):
    """n_lines noisy segments' worth of edge points (0.7 px noise) and
    uniform clutter; N = 3180 by default. Returns (points [N, 2],
    gt_labels [N]) with outliers labeled 0."""
    r = np.random.default_rng(int(seed))
    pts, gt = [], []
    for li in range(int(n_lines)):
        p0 = r.uniform(0, 500, 2)
        ang = r.uniform(0, np.pi)
        d = np.array([np.cos(ang), np.sin(ang)])
        t = r.uniform(0, 400, int(per_line))
        pts.append(p0 + t[:, None] * d + r.normal(scale=0.7, size=(int(per_line), 2)))
        gt += [li + 1] * int(per_line)
    pts.append(r.uniform(0, 600, (int(n_outliers), 2)))
    gt += [0] * int(n_outliers)
    data = np.concatenate(pts)
    perm = r.permutation(len(data))
    return data[perm], np.array(gt)[perm]


def make_vp_scene(seed=0, counts=(80, 57, 39), n_outliers=40, img=640.0):
    """Segments of three vanishing points (0.4 px endpoint noise) and
    random clutter segments. Returns (segments [N, 4], gt_labels [N],
    vps [3, 2])."""
    r = np.random.default_rng(seed)
    vps = np.array([
        [5000.0, 240.0],   # near-horizontal pencil (VP far right)
        [320.0, -4000.0],  # near-vertical pencil (VP far above)
        [-1500.0, 2500.0],
    ])
    segs, gt = [], []
    for vi, (vp, cnt) in enumerate(zip(vps, counts)):
        mids = r.uniform(40, img - 40, (cnt, 2))
        d = vp[None, :] - mids
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        half = r.uniform(15, 45, (cnt, 1))
        a = mids - d * half + r.normal(0, 0.4, (cnt, 2))
        b = mids + d * half + r.normal(0, 0.4, (cnt, 2))
        segs.append(np.concatenate([a, b], axis=1))
        gt += [vi + 1] * cnt
    mids = r.uniform(0, img, (n_outliers, 2))
    ang = r.uniform(0, np.pi, n_outliers)
    d = np.stack([np.cos(ang), np.sin(ang)], 1)
    half = r.uniform(15, 45, (n_outliers, 1))
    segs.append(np.concatenate([mids - d * half, mids + d * half], axis=1))
    gt += [0] * n_outliers
    return np.concatenate(segs), np.array(gt), vps


def make_multi_motion_scene(n_motions=3, pts_per=100, outlier_frac=0.55,
                            seed=0, f=800.0):
    """K rigid motions seen by two views: each object's 3D points move by
    a distinct (R, t), giving K epipolar structures and outliers. Returns
    (corrs [N, 4] in pixels, gt_labels [N]) with outliers labeled 0."""
    r = np.random.default_rng(seed)

    def rot(axis, ang):
        axis = axis / np.linalg.norm(axis)
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K

    Kc = gauntlet_camera(f)
    corrs, labels = [], []
    for k in range(n_motions):
        X = r.uniform(-1, 1, (pts_per, 3)) * [1.5, 1.0, 0.4]
        X[:, 2] += 6.0 + 2.0 * k
        X[:, 0] += 2.0 * (k - n_motions / 2)
        R = rot(r.normal(size=3), r.uniform(0.1, 0.35))
        t = r.uniform(-0.5, 0.5, 3) * [1, 1, 0.3]
        X2 = X @ R.T + t
        x1 = X @ Kc.T
        x1 = x1[:, :2] / x1[:, 2:3]
        x2 = X2 @ Kc.T
        x2 = x2[:, :2] / x2[:, 2:3]
        noise = r.normal(scale=0.5, size=(pts_per, 4))
        corrs.append(np.concatenate([x1, x2], 1) + noise)
        labels.append(np.full(pts_per, k + 1))
    n_in = n_motions * pts_per
    n_out = int(outlier_frac / (1.0 - outlier_frac) * n_in)
    out = np.concatenate([r.uniform(0, 640, (n_out, 2)),
                          r.uniform(0, 480, (n_out, 2))], 1)
    corrs.append(out)
    labels.append(np.zeros(n_out))
    perm = r.permutation(n_in + n_out)
    return (np.concatenate(corrs)[perm].astype(np.float64),
            np.concatenate(labels)[perm].astype(np.int32))


# The gauntlet's scenes by name: (n_motions, outlier_frac) of
# tests/test_gauntlet.py's two-motion (seeds 0-2) and three-motion (seed 1)
# scenes, 100 points a motion.
GAUNTLET_SCENES = {"two": (2, 0.5), "three": (3, 0.4)}


def gauntlet_scene(kind, seed):
    """make_multi_motion_scene at the gauntlet's settings: kind "two" (400
    correspondences) or "three" (500)."""
    n_motions, frac = GAUNTLET_SCENES[kind]
    return make_multi_motion_scene(n_motions=n_motions, pts_per=100,
                                   outlier_frac=frac, seed=seed)


# ---------------------------------------------------------------------------
# Bench phases: the JAX package's bench_lines, bench_vps and bench_essential
# (progressivex_tpu/eval/extras.py:134-293) on the port's front ends, with
# the same keys. On the card their times are the card's; `device` is the
# front ends' (the card unless "cpu").

def _best_of(n_runs, call):
    """(seconds, result) of the fastest of n_runs calls of call(i)."""
    import time

    best = (float("inf"), None)
    for i in range(n_runs):
        t0 = time.perf_counter()
        out = call(i)
        dt = time.perf_counter() - t0
        if dt < best[0]:
            best = (dt, out)
    return best


def bench_lines(n_runs: int = 3, seed: int = 0, n_batch: int = 32, device=None) -> dict:
    """The 7-line / 3180-point scene: latency of one findLines call (best
    of n_runs seeds), its model count and ME, the device time of one fit
    (with_statistics="phases"), and the scenes per second of n_batch
    scenes in one findLinesBatched call."""
    import time

    from progressivex_tpu_torch import findLines, findLinesBatched
    from progressivex_tpu_torch.io.metrics import misclassification

    pts, gt = make_lines_scene(seed=seed)
    kw = dict(LINES_KW, device=device)
    findLines(pts, **kw, random_seed=seed)  # warm-up
    best, (lines, labeling) = _best_of(
        n_runs, lambda i: findLines(pts, **kw, random_seed=seed + i))
    out = {"lines_time_s": round(best, 4), "lines_ref_time_s": 0.709,
           "lines_n_models": int(lines.shape[0]), "lines_ref_n_models": 7,
           "lines_me": round(float(misclassification(labeling, gt)), 4),
           "lines_n_points": int(pts.shape[0])}
    _, _, st = findLines(pts, **kw, with_statistics="phases", random_seed=seed)
    out["lines_device_ms"] = st.phase_times["total_device_ms"]
    scenes = [make_lines_scene(seed=seed + i) for i in range(n_batch)]
    findLinesBatched([s[0] for s in scenes], **kw, random_seed=seed)  # warm-up
    t0 = time.perf_counter()
    res = findLinesBatched([s[0] for s in scenes], **kw, random_seed=seed + 1)
    dt = time.perf_counter() - t0
    mes = [misclassification(lab, scenes[i][1]) for i, (_, lab) in enumerate(res)]
    out.update({"lines_scenes_per_sec": round(n_batch / dt, 2),
                "lines_batched_me": round(float(np.mean(mes)), 4),
                "lines_n_batch": n_batch})
    return out


def bench_vps(n_runs: int = 3, seed: int = 0, n_batch: int = 256, device=None) -> dict:
    """The 3-VP / 216-segment scene: latency of one findVanishingPoints
    call (best of n_runs seeds), its model count and ME, the device time
    of one fit, and the scenes per second of n_batch scenes in one
    findVanishingPointsBatched call."""
    import time

    from progressivex_tpu_torch import findVanishingPoints, findVanishingPointsBatched
    from progressivex_tpu_torch.io.metrics import misclassification

    segs, gt, _ = make_vp_scene(seed=seed)
    kw = dict(VP_KW, device=device)
    findVanishingPoints(segs, **kw, random_seed=seed)  # warm-up
    best, (vps, labeling) = _best_of(
        n_runs, lambda i: findVanishingPoints(segs, **kw, random_seed=seed + i))
    out = {"vp_time_s": round(best, 4), "vp_ref_time_s": 0.0048,
           "vp_n_models": int(vps.shape[0]), "vp_ref_n_models": 3,
           "vp_me": round(float(misclassification(labeling, gt)), 4),
           "vp_n_segments": int(segs.shape[0])}
    _, _, st = findVanishingPoints(segs, **kw, with_statistics="phases", random_seed=seed)
    out["vp_device_ms"] = st.phase_times["total_device_ms"]
    scenes = [make_vp_scene(seed=seed + i) for i in range(n_batch)]
    findVanishingPointsBatched([s[0] for s in scenes], **kw, random_seed=seed)  # warm-up
    t0 = time.perf_counter()
    res = findVanishingPointsBatched([s[0] for s in scenes], **kw, random_seed=seed + 1)
    dt = time.perf_counter() - t0
    mes = [misclassification(lab, scenes[i][1]) for i, (_, lab) in enumerate(res)]
    out.update({"vp_scenes_per_sec": round(n_batch / dt, 2),
                "vp_batched_me": round(float(np.mean(mes)), 4), "vp_n_batch": n_batch})
    return out


def bench_essential(seeds=(0, 1, 2), n_time_runs: int = 2, device=None) -> dict:
    """The two-motion essential gauntlet (tests/test_gauntlet.py's scenes)
    at ESSENTIAL_KW: each seed's ME and model count, and the best of
    n_time_runs calls on the first seed (after its scored fit, which
    warms it up)."""
    from progressivex_tpu_torch import findEssentialMatrices
    from progressivex_tpu_torch.io.metrics import misclassification

    K = gauntlet_camera()
    mes, ks, best = [], [], float("inf")
    for i, seed in enumerate(seeds):
        corrs, gt = gauntlet_scene("two", seed)
        E, lab = findEssentialMatrices(corrs, K, K, **ESSENTIAL_KW, random_seed=seed,
                                       device=device)
        mes.append(float(misclassification(lab, gt)))
        ks.append(int(E.shape[0]) // 3)
        if i == 0:
            best = _best_of(n_time_runs, lambda _: findEssentialMatrices(
                corrs, K, K, **ESSENTIAL_KW, random_seed=seed, device=device))[0]
    return {"essential_gauntlet_me": round(float(np.mean(mes)), 4),
            "essential_gauntlet_me_per_seed": [round(m, 4) for m in mes],
            "essential_gauntlet_n_models": ks, "essential_time_s": round(best, 4)}
