"""Multi 6D-pose demo on the bundled T-LESS scene, on the card — the port's
counterpart of examples/demo_multi_pose6d.py (the reference's
`examples/example_multi_pose_6d.ipynb`: 1886 2D-3D correspondences, two
ground-truth poses).

  python -m progressivex_tpu_torch.examples.demo_multi_pose6d [device]
"""

import sys
import time

import numpy as np

from progressivex_tpu_torch import find6DPoses
from progressivex_tpu_torch.io.data import load_tless_scene
from progressivex_tpu_torch.io.metrics import pose_errors


def main(device=None):
    xy, xyz, K, gt_poses = load_tless_scene()
    print(f"{len(xy)} correspondences, {len(gt_poses)} GT poses")
    t0 = time.perf_counter()
    poses, labeling = find6DPoses(
        xy, xyz, K,
        threshold=4.0, conf=0.9, spatial_coherence_weight=0.1,
        neighborhood_ball_radius=20.0, maximum_tanimoto_similarity=0.9,
        max_iters=400, minimum_point_number=2 * 3, do_logging=True,
        device=device,
    )
    dt = time.perf_counter() - t0
    k = poses.shape[0] // 3
    est = [poses[3 * i:3 * i + 3] for i in range(k)]
    print(f"{k} poses in {dt:.3f}s")
    for gi, (rot, tr) in enumerate(pose_errors(est, gt_poses)):
        print(f"GT pose {gi}: best rotation error {rot:.2f} deg, "
              f"translation error {tr:.2f} mm "
              f"(reference anchors: 8.25/0.95 deg, 24.0/12.2 mm)")


if __name__ == "__main__":
    main(*sys.argv[1:])
