"""The plain reference that decides `correct`: it judges the program's
answers (the models and the labeling of each scene) against the scene's
own data, in float64, with no code of the program.

A multi-model fit is random: no second implementation draws the same
samples. What a sound answer must satisfy is checked instead, on every
scene of a sample drawn from the run's seed:

- `me`: its misclassification error against the labels the generator
  drew (AdelaideRMF's measure, `misclassification`).
- `gap`: the share of points whose label differs from the labeling that
  the answer's own models imply under the protocol's energy without its
  spatial term: each point goes to the model of least squared residual
  when that residual is under the truncation tau_t^2 = (1.5 threshold)^2
  (Progressive-X, progressive_x.h:523; a model then costs less than the
  outlier class), else to the outlier class. The spatial term of the
  program's labeling moves a few points off that labeling; a residual
  computed wrongly, a label or a model altered, moves many.
- `gross`: the share of points labeled to a model under which their
  residual lies beyond the truncation: such a label costs more than the
  outlier class, and only the spatial term can put a point there (at the
  H protocol's weight, 0.05, it put none in the samples measured).
- `model_gaps`: for each model, how far it lies from the reference's own
  least-squares model (the family's `refit`, float64) of the points that
  both its label and its residual give it (`model_distance`, pixels).
  Most of a sound fit's models lie a few hundredths of a pixel from it,
  so the median over a sample's models is steady; models computed in a
  lower precision lie farther.

`numbers` reduces a run's judged answers to the numbers a cell may compare
(checks/<cell>.json names those it compares, with their limits). The
control (`control`) puts the reference in the program's place, computed
in bfloat16, the precision below the float32 that the configurations
state: on each answer's own partition of the points it refits the models
in bfloat16 and labels the points by the residual in bfloat16, and that
answer is judged as the program's are.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
from scipy.optimize import linear_sum_assignment

TRUNCATION = 1.5  # tau_t = 1.5 * threshold (Progressive-X, progressive_x.h:523)
# A label is gross when the point's squared residual under its model is
# 1% or more beyond tau_t^2: far from where float32 and float64 can part.
GROSS = 1.01


def misclassification(pred_labels, gt_labels) -> float:
    """The share of points misclassified under the best one-to-one
    relabeling of the ground-truth classes (label 0 = outlier), found by
    the Hungarian algorithm: the AdelaideRMF notebooks' metric, copied
    from progressivex_tpu_torch/io/metrics.py. A predicted label at or
    above the number of ground-truth classes never matches."""
    pred = np.asarray(pred_labels).astype(np.int64)
    gt = np.asarray(gt_labels).astype(np.int64)
    n = int(gt.max()) + 1
    m = np.zeros((n, n), dtype=np.int64)
    in_range = pred < n
    np.add.at(m, (gt[in_range], pred[in_range]), 1)
    rows, cols = linear_sum_assignment(-m)
    return 1.0 - int(m[rows, cols].sum()) / len(pred)


def implied_labels(family, models, data, n_points, threshold, dtype):
    """The labeling that `models` [K, rows, cols] imply for the n_points
    points of a scene's `data` without the spatial term, computed in
    `dtype`: the model of least residual where it is under tau_t^2, else
    K (outlier)."""
    import torch

    k = len(models)
    if k == 0:
        return np.full(n_points, 0, np.int64)
    models_t = torch.as_tensor(np.asarray(models, np.float64)).to(dtype)
    r2 = family.squared_residual(models_t, family.points(data, dtype))
    trunc = torch.tensor((TRUNCATION * float(threshold)) ** 2, dtype=dtype)
    ratio = (r2 / trunc).to(torch.float64).numpy()
    ratio = np.where(np.isnan(ratio), np.inf, ratio)
    best = ratio.argmin(0)
    return np.where(ratio[best, np.arange(ratio.shape[1])] < 1.0, best, k)


class Judged(NamedTuple):
    """The reference's reading of one answer."""

    me: float
    gap: float
    gross: float
    model_gaps: tuple
    n_models: int


def _as_answer(family, models_flat, labels, n_points):
    """(models [K, rows, cols] float64, labels [n] int64), the family's
    MODEL_SHAPE (rows, cols), or None when the answer is malformed: wrong
    shapes, labels out of range, non-finite models."""
    rows, cols = family.MODEL_SHAPE
    labels = np.asarray(labels)
    models_flat = np.asarray(models_flat, np.float64)
    if (labels.shape != (n_points,) or models_flat.ndim != 2
            or models_flat.shape[1] != cols or models_flat.shape[0] % rows
            or not np.isfinite(models_flat).all()):
        return None
    models = models_flat.reshape(-1, rows, cols)
    if n_points and (labels.min() < 0 or labels.max() > len(models)):
        return None
    return models, labels.astype(np.int64)


def _partition(family, models, data, labels, threshold):
    """For each model, the points that both its label and its float64
    residual give it; the labeling the models imply; and the gross share:
    points labeled to a model under which their residual lies beyond the
    truncation (by GROSS), where the label costs more than the outlier
    class and only the spatial term could have put it."""
    import torch

    implied = implied_labels(family, models, data, len(labels), threshold, torch.float64)
    gross = 0.0
    if len(models):
        r2 = family.squared_residual(torch.as_tensor(models),
                                     family.points(data, torch.float64)).numpy()
        held = labels < len(models)
        ratio = r2[np.minimum(labels, len(models) - 1), np.arange(len(labels))]
        ratio = ratio / (TRUNCATION * float(threshold)) ** 2
        gross = float(np.mean(held & ~(ratio < GROSS)))
    return [(labels == k) & (implied == k) for k in range(len(models))], implied, gross


def judge(family, data, gt, models_flat, labels, threshold):
    """The Judged reading of one answer to the scene `data` (models_flat
    [rows K, cols], labels [n] with K for outliers, as the entry point
    returns them), or None when it is malformed."""
    import torch

    answer = _as_answer(family, models_flat, labels, len(gt))
    if answer is None:
        return None
    models, labels = answer
    parts, implied, gross = _partition(family, models, data, labels, threshold)
    gaps = []
    for model, part in zip(models, parts):
        if part.sum() >= family.REFIT_MIN:
            points = family.points(data, torch.float64, part)
            ref = family.refit(points, torch.float64)
            gaps.append(family.model_distance(torch.as_tensor(model), ref, points))
    return Judged(misclassification(labels, gt), float(np.mean(implied != labels)), gross,
                  tuple(gaps), len(models))


def control(family, data, gt, models_flat, labels, threshold):
    """The Judged reading of the control in the program's place on one
    answer: the models refitted in bfloat16 on the answer's own partition
    of the points, the points labeled by their residual in bfloat16."""
    import torch

    models, labels = _as_answer(family, models_flat, labels, len(gt))
    parts = _partition(family, models, data, labels, threshold)[0]
    low = [family.refit(family.points(data, torch.float64, part), torch.bfloat16).numpy()
           for part in parts if part.sum() >= family.REFIT_MIN]
    low = np.stack(low) if low else np.zeros((0, *family.MODEL_SHAPE))
    low_labels = implied_labels(family, low, data, len(gt), threshold, torch.bfloat16)
    return judge(family, data, gt, low.reshape(-1, family.MODEL_SHAPE[1]), low_labels,
                 threshold)


def numbers(judged) -> dict:
    """The numbers a run may compare, from its judged answers, in percent:
    the mean ME, the share of answers that hold no model, the mean label
    gap, the largest gross share of an answer; in pixels, the median model
    gap over every model (inf when no answer holds a model to judge). An
    answer left as the fit started (no model, every point an outlier)
    adds no model gap and no gross label: the ME and the empty share are
    the numbers that see it."""
    gaps = [g for j in judged for g in j.model_gaps]
    return {
        "me_mean_pct": 100.0 * float(np.mean([j.me for j in judged])),
        "empty_pct": 100.0 * float(np.mean([j.n_models == 0 for j in judged])),
        "gap_mean_pct": 100.0 * float(np.mean([j.gap for j in judged])),
        "gross_max_pct": 100.0 * max(j.gross for j in judged),
        "model_gap_median_px": float(np.median(gaps)) if gaps else math.inf,
    }
