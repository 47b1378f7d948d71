"""pyprogressivex-compatible entry points — counterpart of progressivex_tpu/api.py.

  findHomographies(corrs, w1, h1, w2, h2, ...)   -> ([3K, 3], labeling)
  findTwoViewMotions(corrs, w1, h1, w2, h2, ...) -> ([3K, 3], labeling)
  findEssentialMatrices(corrs, K1, K2, ...)      -> ([3K, 3], labeling)
  findLines(points, weights, w, h, ...)          -> ([K, 3], labeling)
  findVanishingPoints(lines, weights, w, h, ...) -> ([K, 3], labeling)
  find6DPoses(x1y1, x2y2z2, K, ...)              -> ([3K, 4], labeling)

labeling[i] in {0..K-1} names the instance, K means outlier. Keywords and
defaults are the JAX package's, plus `device`: the fit runs on the CUDA
device unless `device="cpu"` is passed, and raises without a CUDA device.
`random_seed` seeds the CPU torch.Generator the samples are drawn from,
so the card and the CPU fit the same samples; torch's numbers differ
from jax.random's, so a seed does not reproduce the JAX package's run.
`progress_callback` receives one dict per round and restart, as the JAX
package's (core/engine.LIVE_CALLBACK); `with_statistics="phases"` runs the
fit once more under torch.profiler and fills `Statistics.phase_times`
(io/profiling.py).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from progressivex_tpu_torch._device import resolve_device
from progressivex_tpu_torch.core import engine
from progressivex_tpu_torch.core.config import EngineConfig, make_params
from progressivex_tpu_torch.models import get_family

_PAD = 128
_MAX_HYP = 2048
_MAX_HYP_FLAT = 4096
_UNLIMITED = 10**9
# Point counts pad up to these levels, as in the JAX package.
PAD_LEVELS = (128, 256, 384, 512, 768, 1024, 1536, 2304, 3456, 5120, 7680)
# Per-family proposal sub-batch caps (the JAX package's measured values,
# progressivex_tpu/api.py:106-126).
_MAX_HYP_BY_FAMILY = {"homography": 256, "line2d": 512,
                      "vanishing_point": 512, "fundamental": 512}
# The essential family has no entry: its sub-batch is 4096 // 10 = 409
# samples of up to 10 solutions at max_iters >= 409.
# Sub-batches per round: PROGX_MAX_SUBBATCHES, default 1, the JAX package's
# measured default (progressivex_tpu/api.py:29-32, :160-161).
_MAX_SUBBATCHES = int(os.environ.get("PROGX_MAX_SUBBATCHES", "1"))


@dataclasses.dataclass
class Statistics:
    """Run statistics (progressive_x.h:75-104); `iterations` holds one
    record per round run of the winning restart. `restart` is the winning
    restart's index and `restart_energies` every restart's final energy.
    `phase_times`, with `with_statistics="phases"` (any string holding
    "phase"), is the device time of one more, profiled, fit by engine
    phase, in the JAX package's keys (io/profiling.py); None otherwise."""

    processing_time: float
    rounds_run: int
    ransac_iterations: int
    model_number: int
    labeling: "np.ndarray"
    inliers_of_each_model: list
    iterations: list = dataclasses.field(default_factory=list)
    phase_times: dict | None = None
    restart: int = 0
    restart_energies: tuple = ()


def _pad_to(n: int) -> int:
    for level in PAD_LEVELS:
        if n <= level:
            return level
    return -(-n // _PAD) * _PAD


def _hyp_budget(max_iters: int, max_solutions: int = 1,
                family_name: str | None = None) -> int:
    cap = _MAX_HYP_BY_FAMILY.get(family_name, _MAX_HYP)
    return int(min(max(int(max_iters), 64), cap,
                   _MAX_HYP_FLAT // max(max_solutions, 1)))


def _n_subbatches(max_iters: int, n_hyp: int, cap: int | None = None) -> int:
    cap = _MAX_SUBBATCHES if cap is None else int(cap)
    return int(min(max(-(-int(max_iters) // max(n_hyp, 1)), 1), max(cap, 1)))


def _run(family_name, data, weights, *, threshold, conf,
         spatial_coherence_weight, neighborhood_ball_radius,
         maximum_tanimoto_similarity, max_iters, minimum_point_number,
         maximum_model_number, sampler_id, scoring_exponent, do_logging=False,
         random_seed=0, graph_data=None, with_statistics=False,
         lo_spatial_lambda=0.5, n_restarts=1, final_polish=0, final_relabel=0,
         magsac_levels=0, split_pass=0, polish_trim=0.0, polish_research=0,
         restart_rule="energy", max_rounds=10, pearl_iters=3,
         max_subbatches=None, progress_callback=None, device=None):
    dev = resolve_device(device)
    t0 = time.perf_counter()
    data = np.ascontiguousarray(data, np.float32)
    n = data.shape[0]
    n_pad = _pad_to(n)
    data_p = np.pad(data, ((0, n_pad - n), (0, 0)))
    mask = np.zeros(n_pad, bool)
    mask[:n] = True
    w = np.ones(n_pad, np.float32)
    if weights is not None and np.size(weights) > 0:
        w[:n] = np.asarray(weights, np.float32).reshape(-1)[:n]
    w[n:] = 0.0
    graph_p = None
    if graph_data is not None:
        graph_p = np.pad(np.ascontiguousarray(graph_data, np.float32),
                         ((0, n_pad - n), (0, 0)))

    family = get_family(family_name)
    n_hyp = _hyp_budget(max_iters, family.max_solutions, family_name)
    cfg = EngineConfig(
        family=family_name,
        n_hypotheses=n_hyp,
        n_subbatches=_n_subbatches(max_iters, n_hyp, max_subbatches),
        sampler_id=int(sampler_id),
        lo_spatial_lambda=lo_spatial_lambda,
        n_restarts=int(n_restarts),
        final_polish=int(final_polish),
        final_relabel=int(final_relabel),
        magsac_levels=int(magsac_levels),
        split_pass=int(split_pass),
        polish_trim=float(polish_trim),
        polish_research=int(polish_research),
        restart_rule=str(restart_rule),
        max_rounds=int(max_rounds),
        pearl_iters=int(pearl_iters),
        live_progress=progress_callback is not None,
    )
    params = make_params(
        threshold=threshold,
        confidence=conf,
        spatial_weight=spatial_coherence_weight,
        neighborhood_radius=neighborhood_ball_radius,
        max_tanimoto=maximum_tanimoto_similarity,
        min_inliers=minimum_point_number,
        max_models=maximum_model_number if maximum_model_number > 0 else _UNLIMITED,
        scoring_exponent=scoring_exponent,
        n_valid=n,
    )
    inputs = (torch.from_numpy(data_p).to(dev), torch.from_numpy(mask).to(dev),
              torch.from_numpy(w).to(dev))
    graph_t = None if graph_p is None else torch.from_numpy(graph_p).to(dev)

    def fit_once():
        return engine.fit(family, cfg, params, *inputs,
                          generator=torch.Generator().manual_seed(int(random_seed)),
                          graph_data=graph_t)

    engine.LIVE_CALLBACK = progress_callback
    try:
        result = fit_once()
    finally:
        engine.LIVE_CALLBACK = None
    descs, labels = engine.compact_result(result, n)
    processing_time = time.perf_counter() - t0
    if do_logging:
        print(f"[progressivex_tpu_torch] {family_name}: {descs.shape[0]} "
              f"instances, {result.rounds_run} rounds, {result.total_iters} "
              f"samples, {processing_time:.3f}s on {dev}")
    stats = None
    if with_statistics:
        k = descs.shape[0]
        rl = result.round_log
        phase_times = None
        if isinstance(with_statistics, str) and "phase" in with_statistics:
            from progressivex_tpu_torch.io.profiling import measure_phase_times

            phase_times = measure_phase_times(fit_once, dev)
        stats = Statistics(
            processing_time=processing_time,
            rounds_run=result.rounds_run,
            ransac_iterations=result.total_iters,
            model_number=k,
            labeling=labels,
            inliers_of_each_model=[np.flatnonzero(labels == i) for i in range(k)],
            iterations=[
                {"accepted": rl.accepted[r], "proposal_inliers": rl.inliers[r],
                 "tanimoto": rl.tanimoto[r], "proposal_score": rl.score[r],
                 "pearl_energy": rl.energy[r], "active_models": rl.n_active[r]}
                for r in range(result.rounds_run)
            ],
            phase_times=phase_times,
            restart=result.restart,
            restart_energies=result.restart_energies,
        )
    return descs, labels, stats


def findHomographies(
    corrs,
    w1=0,
    h1=0,
    w2=0,
    h2=0,
    threshold=4.0,
    conf=0.5,
    spatial_coherence_weight=0.0,
    neighborhood_ball_radius=200.0,
    maximum_tanimoto_similarity=0.4,
    max_iters=1000,
    minimum_point_number=10,
    maximum_model_number=-1,
    sampler_id=3,
    scoring_exponent=2,
    do_logging=False,
    random_seed=0,
    with_statistics=False,
    n_restarts=1,
    magsac_levels=4,
    final_relabel=2,
    max_rounds=10,
    pearl_iters=3,
    split_pass=0,
    max_subbatches=None,
    progress_callback=None,
    device=None,
):
    """Multi-homography fitting. corrs: [N, 4] = [x1, y1, x2, y2].
    Returns ([3K, 3] stacked row-major 3x3s, labeling), plus Statistics
    with `with_statistics=True`. The extension keywords are the JAX
    package's (see progressivex_tpu/api.findHomographies)."""
    corrs = np.asarray(corrs, np.float64)
    if corrs.ndim != 2 or corrs.shape[1] != 4 or corrs.shape[0] < 4:
        raise ValueError("corrs should be an array with dims [n,4], n>=4")
    descs, labels, stats = _run(
        "homography", corrs, None,
        threshold=threshold, conf=conf,
        spatial_coherence_weight=spatial_coherence_weight,
        neighborhood_ball_radius=neighborhood_ball_radius,
        maximum_tanimoto_similarity=maximum_tanimoto_similarity,
        max_iters=max_iters, minimum_point_number=minimum_point_number,
        maximum_model_number=maximum_model_number, sampler_id=sampler_id,
        scoring_exponent=scoring_exponent, do_logging=do_logging,
        random_seed=random_seed, with_statistics=with_statistics,
        n_restarts=n_restarts, magsac_levels=magsac_levels,
        final_relabel=final_relabel, max_rounds=max_rounds,
        pearl_iters=pearl_iters, split_pass=split_pass,
        max_subbatches=max_subbatches,
        progress_callback=progress_callback, device=device,
    )
    out = descs.reshape(-1, 3).astype(np.float64)
    return (out, labels, stats) if with_statistics else (out, labels)


def findTwoViewMotions(
    corrs,
    w1=0,
    h1=0,
    w2=0,
    h2=0,
    threshold=4.0,
    conf=0.5,
    spatial_coherence_weight=0.0,
    neighborhood_ball_radius=200.0,
    maximum_tanimoto_similarity=0.4,
    max_iters=1000,
    minimum_point_number=10,
    maximum_model_number=-1,
    sampler_id=3,
    scoring_exponent=3,
    do_logging=False,
    random_seed=0,
    with_statistics=False,
    n_restarts=4,
    magsac_levels=4,
    final_relabel=2,
    restart_rule="energy+5k",
    max_rounds=10,
    pearl_iters=3,
    split_pass=0,
    max_subbatches=None,
    progress_callback=None,
    device=None,
):
    """Multi two-view-motion (fundamental matrix) fitting. corrs: [N, 4] =
    [x1, y1, x2, y2], N >= 7. Returns ([3K, 3] stacked row-major 3x3 F
    matrices, labeling), plus Statistics with `with_statistics=True`. The
    extension keywords and their measured defaults (four energy-selected
    restarts, MAGSAC ranking, two final ICM sweeps, the "energy+5k" rule)
    are the JAX package's (see progressivex_tpu/api.findTwoViewMotions)."""
    corrs = np.asarray(corrs, np.float64)
    if corrs.ndim != 2 or corrs.shape[1] != 4 or corrs.shape[0] < 7:
        raise ValueError("corrs should be an array with dims [n,4], n>=7")
    descs, labels, stats = _run(
        "fundamental", corrs, None,
        threshold=threshold, conf=conf,
        spatial_coherence_weight=spatial_coherence_weight,
        neighborhood_ball_radius=neighborhood_ball_radius,
        maximum_tanimoto_similarity=maximum_tanimoto_similarity,
        max_iters=max_iters, minimum_point_number=minimum_point_number,
        maximum_model_number=maximum_model_number, sampler_id=sampler_id,
        scoring_exponent=scoring_exponent, do_logging=do_logging,
        random_seed=random_seed, with_statistics=with_statistics,
        n_restarts=n_restarts, magsac_levels=magsac_levels,
        final_relabel=final_relabel, restart_rule=restart_rule,
        max_rounds=max_rounds, pearl_iters=pearl_iters, split_pass=split_pass,
        max_subbatches=max_subbatches,
        progress_callback=progress_callback, device=device,
    )
    out = descs.reshape(-1, 3).astype(np.float64)
    return (out, labels, stats) if with_statistics else (out, labels)


def check_essential_inputs(corrs, K1, K2, every=""):
    """corrs, K1 and K2 as float64 arrays, validated as the JAX front ends
    validate them."""
    corrs = np.asarray(corrs, np.float64)
    if corrs.ndim != 2 or corrs.shape[1] != 4 or corrs.shape[0] < 5:
        raise ValueError(f"{every}corrs should be an array with dims [n,4], n>=5")
    K1, K2 = np.asarray(K1, np.float64), np.asarray(K2, np.float64)
    if K1.shape != (3, 3) or K2.shape != (3, 3):
        raise ValueError(f"{every}K1/K2 should be arrays with dims [3,3]")
    return corrs, K1, K2


def essential_inputs(corrs, K1, K2, threshold):
    """The essential front ends' preprocessing (progressivex_tpu/api.py:651-657),
    in float64 on the host: each view's pixels normalized by its K^-1, the
    threshold divided by the mean of the four focal lengths. Returns (data
    [N, 4] calibrated, normalized threshold); the graph is built on the
    pixel correspondences themselves."""
    ones = np.ones((corrs.shape[0], 1))
    n1 = (np.concatenate([corrs[:, :2], ones], 1) @ np.linalg.inv(K1).T)[:, :2]
    n2 = (np.concatenate([corrs[:, 2:4], ones], 1) @ np.linalg.inv(K2).T)[:, :2]
    f = 0.25 * (K1[0, 0] + K1[1, 1] + K2[0, 0] + K2[1, 1])
    return np.concatenate([n1, n2], axis=1), threshold / f


def findEssentialMatrices(
    corrs,
    K1,
    K2,
    threshold=0.75,
    conf=0.5,
    spatial_coherence_weight=0.1,
    neighborhood_ball_radius=200.0,
    maximum_tanimoto_similarity=0.4,
    max_iters=1000,
    minimum_point_number=10,
    maximum_model_number=-1,
    sampler_id=0,
    scoring_exponent=2,
    do_logging=False,
    random_seed=0,
    with_statistics=False,
    n_restarts=1,
    split_pass=2,
    magsac_levels=4,
    progress_callback=None,
    device=None,
):
    """Multi essential-matrix fitting (the JAX package's extension: the
    reference ships the five-point solver but no front end). corrs: [N, 4]
    pixel correspondences [x1, y1, x2, y2], N >= 5; K1, K2: [3, 3]
    intrinsics of the two views. Points are normalized by K^-1 and the
    threshold divided by the mean focal length; the neighborhood graph is
    built on the pixels. Returns ([3K, 3] stacked row-major essential
    matrices in normalized coordinates, labeling). The defaults (two final
    split rounds, MAGSAC ranking) are the JAX package's, measured on its
    gauntlet (see progressivex_tpu/api.findEssentialMatrices)."""
    corrs, K1, K2 = check_essential_inputs(corrs, K1, K2)
    data, thr = essential_inputs(corrs, K1, K2, threshold)
    descs, labels, stats = _run(
        "essential", data, None,
        threshold=thr, conf=conf,
        spatial_coherence_weight=spatial_coherence_weight,
        neighborhood_ball_radius=neighborhood_ball_radius,
        maximum_tanimoto_similarity=maximum_tanimoto_similarity,
        max_iters=max_iters, minimum_point_number=minimum_point_number,
        maximum_model_number=maximum_model_number, sampler_id=sampler_id,
        scoring_exponent=scoring_exponent, do_logging=do_logging,
        random_seed=random_seed, graph_data=corrs,
        with_statistics=with_statistics, n_restarts=n_restarts,
        split_pass=split_pass, magsac_levels=magsac_levels,
        progress_callback=progress_callback, device=device,
    )
    out = descs.reshape(-1, 3).astype(np.float64)
    return (out, labels, stats) if with_statistics else (out, labels)


def findLines(
    points,
    weights=None,
    w=0,
    h=0,
    threshold=2.0,
    conf=0.5,
    spatial_coherence_weight=0.0,
    neighborhood_ball_radius=200.0,
    maximum_tanimoto_similarity=0.4,
    max_iters=1000,
    minimum_point_number=10,
    maximum_model_number=-1,
    sampler_id=3,
    scoring_exponent=2,
    do_logging=False,
    random_seed=0,
    with_statistics=False,
    n_restarts=1,
    progress_callback=None,
    device=None,
):
    """Multi 2D-line fitting. points: [N, 2], weights: [N] per point or
    None. Returns ([K, 3] lines (a, b, c) with a^2 + b^2 = 1, labeling).
    Samplers 2 and 3 both run NAPSAC, anything else uniform, as in the
    JAX package."""
    points = np.asarray(points, np.float64)
    if points.ndim != 2 or points.shape[1] != 2 or points.shape[0] < 2:
        raise ValueError("points should be an array with dims [n,2], n>=2")
    descs, labels, stats = _run(
        "line2d", points, weights,
        threshold=threshold, conf=conf,
        spatial_coherence_weight=spatial_coherence_weight,
        neighborhood_ball_radius=neighborhood_ball_radius,
        maximum_tanimoto_similarity=maximum_tanimoto_similarity,
        max_iters=max_iters, minimum_point_number=minimum_point_number,
        maximum_model_number=maximum_model_number,
        sampler_id=line_sampler(sampler_id),
        scoring_exponent=scoring_exponent, do_logging=do_logging,
        random_seed=random_seed, with_statistics=with_statistics,
        n_restarts=n_restarts, progress_callback=progress_callback, device=device,
    )
    out = descs.astype(np.float64)
    return (out, labels, stats) if with_statistics else (out, labels)


def findVanishingPoints(
    lines,
    weights=None,
    w=0,
    h=0,
    threshold=4.0,
    conf=0.5,
    spatial_coherence_weight=0.0,
    neighborhood_ball_radius=200.0,
    maximum_tanimoto_similarity=0.4,
    max_iters=1000,
    minimum_point_number=10,
    maximum_model_number=-1,
    sampler_id=3,
    scoring_exponent=2,
    do_logging=False,
    random_seed=0,
    with_statistics=False,
    n_restarts=1,
    progress_callback=None,
    device=None,
):
    """Multi vanishing-point fitting. lines: [N, 4] segments [xs, ys, xe,
    ye], weights: [N] per segment or None. Returns ([K, 3] unit homogeneous
    VPs, labeling). Samplers 0 and 1 run as asked, anything else uniform,
    as in the JAX package."""
    lines = np.asarray(lines, np.float64)
    if lines.ndim != 2 or lines.shape[1] != 4 or lines.shape[0] < 2:
        raise ValueError("lines should be an array with dims [n,4], n>=2")
    descs, labels, stats = _run(
        "vanishing_point", lines, weights,
        threshold=threshold, conf=conf,
        spatial_coherence_weight=spatial_coherence_weight,
        neighborhood_ball_radius=neighborhood_ball_radius,
        maximum_tanimoto_similarity=maximum_tanimoto_similarity,
        max_iters=max_iters, minimum_point_number=minimum_point_number,
        maximum_model_number=maximum_model_number,
        sampler_id=vp_sampler(sampler_id),
        scoring_exponent=scoring_exponent, do_logging=do_logging,
        random_seed=random_seed, with_statistics=with_statistics,
        n_restarts=n_restarts, progress_callback=progress_callback, device=device,
    )
    out = descs.astype(np.float64)
    return (out, labels, stats) if with_statistics else (out, labels)


def line_sampler(sampler_id) -> int:
    """The line front ends' sampler remap (progressivex_tpu/api.py:353)."""
    return {0: 0, 1: 1, 2: 3, 3: 3}.get(int(sampler_id), 0)


def vp_sampler(sampler_id) -> int:
    """The VP front ends' sampler remap (progressivex_tpu/api.py:396)."""
    return int(sampler_id) if int(sampler_id) in (0, 1) else 0


def pose_inputs(x1y1, x2y2z2, K, threshold):
    """The 6D-pose front ends' preprocessing
    (progressivex_python.cpp:64-105): image points normalized by K^-1,
    the threshold divided by the mean focal length, and the neighborhood
    graph on the unnormalized rows [x, y, X, Y, Z]. Returns (data [N, 5],
    graph rows [N, 5], normalized points [N, 2], normalized threshold)."""
    ones = np.ones((x1y1.shape[0], 1))
    norm_xy = (np.concatenate([x1y1, ones], axis=1) @ np.linalg.inv(K).T)[:, :2]
    data = np.concatenate([norm_xy, x2y2z2], axis=1)
    graph = np.concatenate([x1y1, x2y2z2], axis=1)
    return data, graph, norm_xy, threshold / (0.5 * (K[0, 0] + K[1, 1]))


def check_pose_inputs(x1y1, x2y2z2, K, every=""):
    """x1y1, x2y2z2 and K as float64 arrays, validated as the JAX front
    ends validate them."""
    x1y1 = np.asarray(x1y1, np.float64)
    x2y2z2 = np.asarray(x2y2z2, np.float64)
    K = np.asarray(K, np.float64)
    if x1y1.ndim != 2 or x1y1.shape[1] != 2 or x1y1.shape[0] < 3:
        raise ValueError(f"{every}x1y1 should be an array with dims [n,2], n>=3")
    if x2y2z2.shape != (x1y1.shape[0], 3):
        raise ValueError(f"{every}x2y2z2 should be an array with dims [n,3], n>=3")
    if K.shape != (3, 3):
        raise ValueError(f"{every}K should be an array with dims [3,3]")
    return x1y1, x2y2z2, K


def find6DPoses(
    x1y1,
    x2y2z2,
    K,
    threshold=4.0,
    conf=0.90,
    spatial_coherence_weight=0.1,
    neighborhood_ball_radius=20.0,
    maximum_tanimoto_similarity=0.9,
    max_iters=400,
    minimum_point_number=6,
    maximum_model_number=-1,
    do_logging=False,
    random_seed=0,
    with_statistics=False,
    n_restarts=3,
    polish_trim=0.0,
    final_polish=3,
    polish_research=0,
    fuse_duplicates=True,
    progress_callback=None,
    device=None,
):
    """Multi 6D-pose fitting from 2D-3D correspondences. x1y1: [N, 2]
    pixel coordinates, x2y2z2: [N, 3] world points, K: [3, 3]. Returns
    ([3K_models, 4] stacked row-major [R | t], labeling). The extension
    keywords and their defaults (three energy-selected restarts as rows,
    three final polish passes, duplicate fusion) are the JAX package's
    (see progressivex_tpu/api.find6DPoses for the measurements behind
    them); the samples are uniform and the local optimization is not
    spatially weighted, as there."""
    x1y1, x2y2z2, K = check_pose_inputs(x1y1, x2y2z2, K)
    data, graph, norm_xy, thr = pose_inputs(x1y1, x2y2z2, K, threshold)
    descs, labels, stats = _run(
        "pnp", data, None,
        threshold=thr, conf=conf,
        spatial_coherence_weight=spatial_coherence_weight,
        neighborhood_ball_radius=neighborhood_ball_radius,
        maximum_tanimoto_similarity=maximum_tanimoto_similarity,
        max_iters=max_iters, minimum_point_number=minimum_point_number,
        maximum_model_number=maximum_model_number, sampler_id=0,
        scoring_exponent=2, do_logging=do_logging, random_seed=random_seed,
        graph_data=graph, with_statistics=with_statistics,
        n_restarts=n_restarts, lo_spatial_lambda=0.0,
        final_polish=final_polish, polish_trim=polish_trim,
        polish_research=polish_research, progress_callback=progress_callback,
        device=device,
    )
    if fuse_duplicates:
        descs, labels = _fuse_pose_duplicates(descs, labels, norm_xy, x2y2z2, thr)
    out = descs.reshape(-1, 4).astype(np.float64)
    return (out, labels, stats) if with_statistics else (out, labels)


def _fuse_pose_duplicates(descs, labels, norm_xy, xyz, thr_norm,
                          rel_radius=0.025, max_rot_deg=30.0):
    """Fuse duplicate pose instances: a copy of the JAX package's host
    numpy function (progressivex_tpu/api.py:762-847, where the
    measurements behind it are). Instances whose poses agree within
    rel_radius of the median camera distance in translation and within
    max_rot_deg in rotation, gated against each group's running
    support-weighted mean and taken largest support first, fuse into one:
    the support-weighted chordal mean rotation and the translation of the
    member with the highest density of points within half the threshold.
    descs [K, 12], labels [N] with outlier = K. Returns (descs [K', 12],
    labels renumbered, outlier = K')."""
    K = descs.shape[0]
    if K <= 1:
        return descs, labels
    labels = np.asarray(labels)
    P = np.asarray(descs, np.float64).reshape(K, 3, 4)
    Rs, ts = P[:, :, :3], P[:, :, 3]
    radius = rel_radius * np.median(np.linalg.norm(ts, axis=1))
    cos_gate = np.cos(np.deg2rad(max_rot_deg))
    tight = 0.5 * thr_norm

    def tight_density(i):
        part = labels == i
        if not part.any():
            return 0.0
        Xc = xyz[part] @ Rs[i].T + ts[i]
        z = np.maximum(Xc[:, 2], 1e-9)
        r = np.linalg.norm(Xc[:, :2] / z[:, None] - norm_xy[part], axis=1)
        return float(np.mean(r < tight))

    sizes = np.array([(labels == i).sum() for i in range(K)], np.float64)

    def _chordal_mean(members):
        w = sizes[members]
        w = w / max(w.sum(), 1.0)
        M = np.einsum("m,mij->ij", w, Rs[members])
        U, _, Vt = np.linalg.svd(M)
        return U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt

    order = sorted(range(K), key=lambda i: -sizes[i])
    group_members: list[list[int]] = []
    for i in order:
        joined = False
        for members in group_members:
            Rm = _chordal_mean(members)
            w = sizes[members]
            tm = (w[:, None] * ts[members]).sum(0) / max(w.sum(), 1.0)
            if np.linalg.norm(ts[i] - tm) >= radius:
                continue
            cos_ang = 0.5 * (np.trace(Rm.T @ Rs[i]) - 1.0)
            if cos_ang < cos_gate:
                continue
            members.append(i)
            joined = True
            break
        if not joined:
            group_members.append([i])

    # The output keeps the instances' order: a group is keyed by its
    # smallest original index.
    groups = {min(m): sorted(m) for m in group_members}
    reps = sorted(groups)
    new_descs = []
    remap = np.full(K + 1, len(reps), np.int32)  # outlier K -> new K'
    for new_i, rep in enumerate(reps):
        members = groups[rep]
        if len(members) == 1:
            Pf = P[rep]
        else:
            Rf = _chordal_mean(members)
            tf = ts[max(members, key=tight_density)]
            Pf = np.concatenate([Rf, tf[:, None]], axis=1)
        new_descs.append(Pf.reshape(12))
        for m in members:
            remap[m] = new_i
    return np.stack(new_descs), remap[np.asarray(labels, np.int64)]
