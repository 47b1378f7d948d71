"""Evaluation metrics — numpy-only copies of progressivex_tpu/io/metrics.py's
misclassification and pose errors.

Misclassification: the fraction of points whose predicted label
disagrees with the ground truth under the best one-to-one relabeling of
the ground-truth classes (reference notebook metric), found by the
Hungarian algorithm. Pose errors (reference `cpp_example.cpp:441-455`):
rotation error in degrees by the trace formula, translation error as the
Euclidean distance.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def misclassification(pred_labels, gt_labels) -> float:
    pred = np.asarray(pred_labels).astype(np.int64)
    gt = np.asarray(gt_labels).astype(np.int64)
    n = int(gt.max()) + 1
    # M[i, j] = points of GT class i predicted as label j (labels >= n
    # can never match).
    M = np.zeros((n, n), dtype=np.int64)
    in_range = pred < n
    np.add.at(M, (gt[in_range], pred[in_range]), 1)
    ri, ci = linear_sum_assignment(-M)
    return 1.0 - int(M[ri, ci].sum()) / len(pred)


def rotation_error_deg(R_est, R_gt) -> float:
    """Angular distance between two rotations, in degrees."""
    cos = (np.trace(R_est @ R_gt.T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def translation_error(t_est, t_gt) -> float:
    return float(np.linalg.norm(np.asarray(t_est) - np.asarray(t_gt)))


def pose_errors(poses_est, poses_gt):
    """For each ground-truth pose [3, 4], the (rotation, translation)
    errors of the estimated pose with the smallest rotation error
    (reference `cpp_example.cpp:406-438`); (inf, inf) without estimates."""
    out = []
    for Pg in poses_gt:
        best = (np.inf, np.inf)
        for Pe in poses_est:
            r = rotation_error_deg(Pe[:, :3], Pg[:, :3])
            t = translation_error(Pe[:, 3], Pg[:, 3])
            if r < best[0]:
                best = (r, t)
        out.append(best)
    return out
