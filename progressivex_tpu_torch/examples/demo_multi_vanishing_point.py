"""Multi vanishing-point demo on synthetic line segments, on the card — the
port's counterpart of examples/demo_multi_vanishing_point.py (the
reference's `examples/example_multi_vanishing_point.ipynb`: three
vanishing points of a Manhattan-like frame, each supported by a few dozen
segments, plus clutter).

  python -m progressivex_tpu_torch.examples.demo_multi_vanishing_point [device]
"""

import sys
import time

import numpy as np

from progressivex_tpu_torch import findVanishingPoints


def make_scene(seed=0, counts=(80, 57, 39), n_outliers=40, img=640.0):
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


def main(device=None):
    lines, gt, vps_gt = make_scene()
    t0 = time.perf_counter()
    vps, labeling = findVanishingPoints(
        lines,
        threshold=1.5, conf=0.5, spatial_coherence_weight=0.0,
        neighborhood_ball_radius=200.0, maximum_tanimoto_similarity=0.4,
        max_iters=1000, minimum_point_number=15, maximum_model_number=5,
        sampler_id=0, scoring_exponent=2, device=device,
    )
    dt = time.perf_counter() - t0
    k = vps.shape[0]
    print(f"{len(lines)} segments -> {k} vanishing points in {dt:.3f}s")
    for i in range(k):
        v = vps[i]
        inl = int((labeling == i).sum())
        pos = (v[:2] / v[2]) if abs(v[2]) > 1e-9 else v[:2] * np.inf
        print(f"  VP {i}: ({pos[0]:8.1f}, {pos[1]:8.1f})  {inl} segments")
    return vps, labeling, gt


if __name__ == "__main__":
    main(*sys.argv[1:])
