"""Synthetic line and vanishing-point scenes — numpy copies of
progressivex_tpu/eval/extras.py's `make_lines_scene` and `make_vp_scene`,
so that the port and the JAX package fit the same scenes for the same
seed, and the keywords the JAX package runs each new path at. The bench
functions of that module are not ported yet.

- lines: the reference notebook `examples/example_multi_lines.ipynb`'s
  cardinality, 3180 edge points on 7 lines and clutter, with ground-truth
  labels;
- vanishing points: the inlier structure of
  `example_multi_vanishing_point.ipynb`, 80 / 57 / 39 segments of three
  VPs and 40 clutter segments.
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
