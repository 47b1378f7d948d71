"""AdelaideRMF-H and -F protocols on the bundled scenes — counterpart of
progressivex_tpu/eval/adelaide.py (`H_PROTOCOL`, `F_PROTOCOL`,
`evaluate_scenes`).

Runs on the bundled scenes under `data/` only; it never downloads.
"""

from __future__ import annotations

import time

from progressivex_tpu_torch.api import _pad_to, findHomographies, findTwoViewMotions
from progressivex_tpu_torch.io.data import (ADELAIDE_F_SCENES, ADELAIDE_H_SCENES,
                                            DEFAULT_ROOT, load_corr_scene)
from progressivex_tpu_torch.io.metrics import misclassification

# The notebook protocols (adelaideH.ipynb / adelaideF.ipynb cell 3) with the
# JAX package's measured extensions; the reasons for each are at
# progressivex_tpu/eval/adelaide.py:46-144.
H_PROTOCOL = dict(
    threshold=4.0, conf=0.5, spatial_coherence_weight=0.05,
    neighborhood_ball_radius=200.0, maximum_tanimoto_similarity=0.4,
    max_iters=1000, minimum_point_number=10, maximum_model_number=6,
    sampler_id=3, scoring_exponent=2,
    magsac_levels=4,
    final_relabel=2,
    pearl_iters=2,
    split_pass=1,
    split_pass_min_npad=512,  # harness key: split only scenes padded >= 512
)
F_PROTOCOL = dict(
    threshold=0.75, conf=0.5, spatial_coherence_weight=0.5,
    neighborhood_ball_radius=50.0, maximum_tanimoto_similarity=0.4,
    max_iters=10000, minimum_point_number=7, maximum_model_number=4,
    sampler_id=2, scoring_exponent=1.0,
    max_rounds=6,
    pearl_iters=2,
    n_restarts=4,
    magsac_levels=4,
    restart_rule="energy+5k",
    final_relabel=2,
)
_PROBLEMS = {"H": (H_PROTOCOL, findHomographies, ADELAIDE_H_SCENES),
             "F": (F_PROTOCOL, findTwoViewMotions, ADELAIDE_F_SCENES)}


def scene_kwargs(n_points: int, problem: str = "H") -> dict:
    """The protocol of `problem` for one scene, with split_pass gated on
    the padded size as the JAX harness gates it (adelaide.py:219-222). The
    harness pads to the pad levels from 256 up; below 512 that and
    `_pad_to` agree on which side of the gate a scene falls."""
    kw = dict(_PROBLEMS[problem.upper()][0])
    min_npad = int(kw.pop("split_pass_min_npad", 0))
    if min_npad and _pad_to(n_points) < min_npad:
        kw.pop("split_pass")
    return kw


def evaluate_scenes(problem: str = "H", root: str = DEFAULT_ROOT, seed: int = 0,
                    device=None, scenes=None):
    """Run the protocol of `problem` ("H" or "F") once per bundled scene.
    Returns {"mean_me", "per_scene": {name: {"me", "time_s", "n",
    "n_models", "labels"}}}."""
    _, fn, bundled = _PROBLEMS[problem.upper()]
    per_scene = {}
    for name in bundled if scenes is None else scenes:
        corrs, gt = load_corr_scene(name, root=root)
        t0 = time.perf_counter()
        models, labels = fn(corrs, **scene_kwargs(len(gt), problem),
                            random_seed=seed, device=device)
        per_scene[name] = {"me": float(misclassification(labels, gt)),
                           "time_s": time.perf_counter() - t0, "n": len(gt),
                           "n_models": models.shape[0] // 3, "labels": labels}
    mes = [v["me"] for v in per_scene.values()]
    return {"mean_me": sum(mes) / len(mes), "per_scene": per_scene}
