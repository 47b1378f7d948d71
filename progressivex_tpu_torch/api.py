"""pyprogressivex-compatible entry points — counterpart of progressivex_tpu/api.py
(its homography and fundamental-matrix entries; the other families come
with their slices).

  findHomographies(corrs, w1, h1, w2, h2, ...)   -> ([3K, 3], labeling)
  findTwoViewMotions(corrs, w1, h1, w2, h2, ...) -> ([3K, 3], labeling)

labeling[i] in {0..K-1} names the instance, K means outlier. Keywords and
defaults are the JAX package's, plus `device`: the fit runs on the CUDA
device unless `device="cpu"` is passed, and raises without a CUDA device.
`random_seed` seeds the CPU torch.Generator the samples are drawn from,
so the card and the CPU fit the same samples; torch's numbers differ
from jax.random's, so a seed does not reproduce the JAX package's run.
"""

from __future__ import annotations

import dataclasses
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
_MAX_HYP_BY_FAMILY = {"homography": 256, "fundamental": 512}
# Sub-batches per round; 1 is the JAX package's measured default.
_MAX_SUBBATCHES = 1


@dataclasses.dataclass
class Statistics:
    """Run statistics (progressive_x.h:75-104); `iterations` holds one
    record per round run of the winning restart. `restart` is the winning
    restart's index and `restart_energies` every restart's final energy.
    `phase_times` stays None in this slice."""

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
         random_seed=0, with_statistics=False, lo_spatial_lambda=0.5,
         n_restarts=1, final_relabel=0, magsac_levels=0, split_pass=0,
         restart_rule="energy", max_rounds=10, pearl_iters=3,
         max_subbatches=None, device=None):
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

    family = get_family(family_name)
    n_hyp = _hyp_budget(max_iters, family.max_solutions, family_name)
    cfg = EngineConfig(
        family=family_name,
        n_hypotheses=n_hyp,
        n_subbatches=_n_subbatches(max_iters, n_hyp, max_subbatches),
        sampler_id=int(sampler_id),
        lo_spatial_lambda=lo_spatial_lambda,
        n_restarts=int(n_restarts),
        final_relabel=int(final_relabel),
        magsac_levels=int(magsac_levels),
        split_pass=int(split_pass),
        restart_rule=str(restart_rule),
        max_rounds=int(max_rounds),
        pearl_iters=int(pearl_iters),
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
    gen = torch.Generator().manual_seed(int(random_seed))
    result = engine.fit(family, cfg, params, torch.from_numpy(data_p).to(dev),
                        torch.from_numpy(mask).to(dev), torch.from_numpy(w).to(dev),
                        generator=gen)
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
    magsac_levels=4,
    final_relabel=2,
    max_rounds=10,
    pearl_iters=3,
    split_pass=0,
    max_subbatches=None,
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
        magsac_levels=magsac_levels, final_relabel=final_relabel,
        max_rounds=max_rounds, pearl_iters=pearl_iters, split_pass=split_pass,
        max_subbatches=max_subbatches, device=device,
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
        max_subbatches=max_subbatches, device=device,
    )
    out = descs.reshape(-1, 3).astype(np.float64)
    return (out, labels, stats) if with_statistics else (out, labels)
