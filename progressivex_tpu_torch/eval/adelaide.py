"""AdelaideRMF-H and -F protocols on the bundled scenes — counterpart of
progressivex_tpu/eval/adelaide.py (`H_PROTOCOL`, `F_PROTOCOL`,
`evaluate_scenes`, `ThroughputResult`, `throughput_batch`).

Runs on the bundled scenes under `data/` only; it never downloads.
"""

from __future__ import annotations

import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from progressivex_tpu_torch import api_batch
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


class ThroughputResult(NamedTuple):
    """What one scene-batched throughput measurement yields (the JAX
    package's fields). `pass_seconds` is the sum over pad levels of the
    best batch time: one pass over the distinct scenes through the same
    batches."""

    scenes_per_sec: float
    mean_me: float
    n_scenes: int  # batched lanes (replication included)
    full_dataset: bool
    compile_seconds: float
    pass_seconds: float
    n_distinct: int  # distinct scenes covered by the batches
    buckets: tuple  # per-bucket dicts: n_pad, lanes, n_restarts, best_s


def throughput_batch(problem: str, root: str = DEFAULT_ROOT,
                     n_timing_runs: int = 3, seed: int = 0,
                     lane_target: int = 32, device=None) -> ThroughputResult:
    """Scene-batched throughput of `problem` ("H" or "F") on the bundled
    scenes, the port's counterpart of the JAX package's: scenes grouped by
    pad level, each level's scenes replicated cyclically up to
    `lane_target` lanes (the next power of two of its scene count if that
    is more), and each level one `api_batch._run_batched` call on the card
    (F's restarts are rows of it). Throughput = lanes / the best of
    `n_timing_runs` host-clock times per level, summed over levels, each
    time ending in `torch.cuda.synchronize()`. The timing runs draw from
    seeds seed + 1, seed + 2, ...; ME is taken from every timing run and
    averaged per distinct scene first, so replication does not weight it.
    `compile_seconds` is the first, untimed call of each level (seed
    `seed`), which builds the CUDA kernels."""
    problem = problem.upper()
    _, _, names = _PROBLEMS[problem]
    family = "homography" if problem == "H" else "fundamental"
    dev = torch.device("cuda" if device is None else device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    scenes = {name: load_corr_scene(name, root=root) for name in names}
    buckets: dict[int, list[str]] = {}
    for name, (corrs, _) in scenes.items():
        buckets.setdefault(_pad_to(len(corrs)), []).append(name)

    def run(lane_names, n_pad, run_seed):
        kw = scene_kwargs(n_pad, problem)
        thr = kw.pop("threshold")
        return api_batch._run_batched(
            family, [np.ascontiguousarray(scenes[n][0], np.float32) for n in lane_names],
            None, thresholds=thr, random_seed=run_seed, device=dev, **kw)

    compile_s, total_time, total_lanes = 0.0, 0.0, 0
    mes: dict[str, list] = {}
    info = []
    for n_pad in sorted(buckets):
        idxs = buckets[n_pad]
        lanes = max(lane_target, api_batch._next_pow2(len(idxs)))
        lane_names = [idxs[j % len(idxs)] for j in range(lanes)]
        t0 = time.perf_counter()
        run(lane_names, n_pad, seed)
        sync()
        compile_s += time.perf_counter() - t0
        times = []
        for i in range(n_timing_runs):
            t0 = time.perf_counter()
            out = run(lane_names, n_pad, seed + i + 1)
            sync()
            times.append(time.perf_counter() - t0)
            for name, (_, labels) in zip(lane_names, out):
                mes.setdefault(name, []).append(
                    misclassification(labels, scenes[name][1]))
        best = min(times)
        total_time += best
        total_lanes += lanes
        n_restarts = int(scene_kwargs(n_pad, problem).get("n_restarts", 1))
        info.append({"n_pad": n_pad, "lanes": lanes, "n_restarts": n_restarts,
                     "best_s": best})
        print(f"[progressivex_tpu_torch.eval] {problem} bucket n_pad={n_pad}: "
              f"{lanes} scenes (x{n_restarts} restarts) in {best * 1e3:.1f} ms "
              f"({lanes / best:.1f} scenes/s)", file=sys.stderr)
    mean_me = float(np.mean([np.mean(v) for v in mes.values()]))
    return ThroughputResult(total_lanes / total_time, mean_me, total_lanes, False,
                            compile_s, total_time, len(mes), tuple(info))
