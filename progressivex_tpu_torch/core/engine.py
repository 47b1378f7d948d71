"""The Progressive-X outer loop — counterpart of progressivex_tpu/core/engine.py.

Per round: propose one model from a batch of minimal samples scored in one
pass (the fused kernel on the card), polish the top candidates with
spatially weighted IRLS, validate against the compound instance (min
inliers + Tanimoto, progressive_x.h:565-591), run PEARL, update the
compound preference, and stop on the reference's termination rules
(progressive_x.h:495-513). The JAX package runs the rounds as a
`lax.while_loop` with a per-scene `done` freeze; here a Python loop runs
them eagerly and stops at the same point, and scalar decisions (accepted,
done) are read on the host.

Samples are drawn for all rounds before the loop, on a CPU generator, so
that the card and the CPU see the same samples for the same seed; the
`presampled` argument of `fit` replaces the draws (a test replays the JAX
package's exact samples through it). With `n_restarts > 1` the restarts
run one after another on the shared neighborhood tensors, each drawing
all of its samples before the next starts, and `select_restart` picks the
winner on the host; the JAX package vmaps them.
"""

from __future__ import annotations

import dataclasses
import re
from typing import NamedTuple

import numpy as np
import torch

from progressivex_tpu_torch.core.config import EngineConfig, RuntimeParams, truncated_sq_threshold
from progressivex_tpu_torch.core.pearl import (_top_k, merge_instances, pearl_run,
                                               split_instances)
from progressivex_tpu_torch.models.base import ModelFamily
from progressivex_tpu_torch.ops.knn import knn_graph
from progressivex_tpu_torch.ops.labeling import (
    adjacency_banded,
    adjacency_from_knn,
    data_costs,
    icm_sweeps,
    labeling_energy,
    neighbor_mean,
)
from progressivex_tpu_torch.ops.sampling import sample_minimal
from progressivex_tpu_torch.ops.scoring import (
    sigma_marginalized_preference,
    tanimoto_similarity,
    truncated_preference,
)

_NEG = -1e30
_F32 = np.float32


class FitState(NamedTuple):
    descs: torch.Tensor  # [K, D]
    active: torch.Tensor  # [K] bool
    labels: torch.Tensor  # [N] int64 slot labels, K = outlier
    compound_pref: torch.Tensor  # [N]
    n_slots_used: int
    total_iters: int  # minimal samples drawn so far (k*-capped)
    rejections: int  # consecutive rejected proposals
    energy: float  # PEARL energy of the last accepted state (NaN before)
    done: bool


class RoundLog(NamedTuple):
    """Per-round statistics (progressive_x.h:75-82), one entry per round
    run."""

    accepted: list
    inliers: list
    tanimoto: list
    score: list
    energy: list
    n_active: list


class FitResult(NamedTuple):
    descs: torch.Tensor  # [K, D]
    active: torch.Tensor  # [K] bool
    labels: torch.Tensor  # [N] int64 slot labels, K = outlier
    n_models: int
    total_iters: int
    rounds_run: int
    energy: torch.Tensor  # final total energy (data + Potts + label costs)
    round_log: RoundLog
    compound_pref: torch.Tensor  # [N] of the final descriptors
    restart: int = 0  # index of the winning restart
    restart_energies: tuple = ()  # final energy of every restart


def _k_star(inliers, n_valid, confidence, sample_size):
    """RANSAC k* = log(1 - conf) / log(1 - w^m) in float32."""
    one_minus_conf = np.clip(_F32(1.0) - confidence, _F32(1e-9), _F32(1.0 - 1e-9))
    w_best = _F32(inliers) / max(_F32(n_valid), _F32(1.0))
    miss = np.clip(_F32(1.0) - w_best ** sample_size, _F32(1e-9), _F32(1.0 - 1e-9))
    with np.errstate(divide="ignore"):  # miss rounds to 1 in f32: k* = inf
        return np.ceil(np.log(one_minus_conf) / np.log(miss))


def _proposal(family, cfg, params, data, pmask, pweights, idx, samp_ok,
              idx_ext, ok_ext, adj, compound_pref, has_compound):
    """One batched proposal + spatially coherent IRLS local optimization.
    Returns (desc [D], score, valid, sq_residuals [N], samples_drawn)."""
    trunc_sq = truncated_sq_threshold(params.threshold)
    n_sub = 1 + idx_ext.shape[0]
    b_samples = idx.shape[0]
    bs = b_samples * family.max_solutions
    t = cfg.lo_candidates
    min_needed = max(family.sample_size, int(params.min_inliers))
    cn = (compound_pref * compound_pref).sum()

    def score(descs):
        return family.scorer(data, descs, compound_pref, pmask, trunc_sq,
                            params.scoring_exponent, has_compound,
                            cfg.magsac_levels)

    # Sub-batches until the sample count exceeds k* of the best hypothesis
    # (the batched form of GC-RANSAC's adaptive termination).
    cand_descs = torch.zeros(t, family.desc_dim, dtype=data.dtype, device=data.device)
    cand_scores = torch.full((t,), _NEG, dtype=torch.float32, device=data.device)
    raw_desc, raw_score, raw_inl = cand_descs[0], _NEG, 0
    s = 0
    while s < n_sub and (s == 0 or s * b_samples < _k_star(
            raw_inl, params.n_valid, params.confidence, family.sample_size)):
        idx_s, ok_s = (idx, samp_ok) if s == 0 else (idx_ext[s - 1], ok_ext[s - 1])
        descs_h, valid_h = family.minimal_solver_batched(data[idx_s])
        descs_f = descs_h.reshape(bs, family.desc_dim)
        valid_f = (valid_h & ok_s[:, None]).reshape(bs)
        scores, inliers, dots, norms = score(descs_f)
        scores = torch.where(valid_f & torch.isfinite(scores), scores, _NEG)
        # Prefer hypotheses that pass validation (min inliers + Tanimoto).
        den = norms + cn - dots
        tan = torch.where(den > 1e-12, dots / den, 0.0)
        admissible = (inliers >= min_needed) & (tan <= params.max_tanimoto)
        scores_adm = torch.where(admissible, scores, _NEG)
        sb_ids = _top_k(scores_adm, t)
        merged_scores = torch.cat([cand_scores, scores_adm[sb_ids]])
        merged_descs = torch.cat([cand_descs, descs_f[sb_ids]])
        keep = _top_k(merged_scores, t)
        cand_descs, cand_scores = merged_descs[keep], merged_scores[keep]
        rb = int(scores.argmax())
        if float(scores[rb]) > raw_score:
            raw_desc, raw_score, raw_inl = descs_f[rb], float(scores[rb]), int(inliers[rb])
        s += 1
    samples_drawn = s * b_samples

    # Local optimization of the top-T candidates (all at once); selection
    # happens after LO. With no admissible candidate, polish the raw best.
    if not float(cand_scores.max()) > _NEG / 2:
        cand_descs = raw_desc.expand(t, -1).clone()
        cand_scores = torch.full_like(cand_scores, raw_score)
    cand_valid = cand_scores > _NEG / 2

    lam = cfg.lo_spatial_lambda

    def lo_weight(r2d):
        if cfg.magsac_levels > 0:
            pref = sigma_marginalized_preference(r2d, trunc_sq, cfg.magsac_levels)
        else:
            pref = truncated_preference(r2d, trunc_sq)
        if lam != 0.0:
            pref = torch.clamp((1.0 - lam) * pref + lam * neighbor_mean(adj, pref),
                               0.0, 1.0)
        return pref * pweights * pmask

    d, sc = cand_descs, cand_scores
    improving = torch.ones(t, dtype=torch.bool, device=data.device)
    for _ in range(cfg.lo_steps):
        nd, ok = family.refit(data, lo_weight(family.squared_residual(data, d)), d)
        s_new = score(nd)[0]
        pref_n = truncated_preference(family.squared_residual(data, nd), trunc_sq) * pmask
        tan_n = tanimoto_similarity(pref_n, compound_pref)
        better = (improving & ok & torch.isfinite(s_new) & (s_new > sc)
                  & (tan_n <= params.max_tanimoto))
        d = torch.where(better[:, None], nd, d)
        sc = torch.where(better, s_new, sc)
        improving = better
        if not bool(improving.any()):
            break
    scores_lo = torch.where(cand_valid, sc, _NEG)
    best_t = scores_lo.argmax()
    desc, score_best = d[best_t], scores_lo[best_t]
    valid = bool(score_best > _NEG / 2)
    return desc, score_best, valid, family.squared_residual(data, desc), samples_drawn


def _round(family, cfg, params, data, pmask, pweights, idx, samp_ok,
           idx_ext, ok_ext, adj, state: FitState):
    """One propose -> validate -> optimize -> update -> terminate round."""
    k_slots = cfg.max_models
    trunc_sq = truncated_sq_threshold(params.threshold)
    has_compound = bool(state.active.any())

    desc, score, prop_valid, r2_best, samples_drawn = _proposal(
        family, cfg, params, data, pmask, pweights, idx, samp_ok, idx_ext,
        ok_ext, adj, state.compound_pref, has_compound)

    # validation (progressive_x.h:565-591), inliers at the raw threshold
    pref_p = truncated_preference(r2_best, trunc_sq) * pmask
    inlier_cnt = int(((r2_best < params.threshold * params.threshold) & pmask).sum())
    k_star = _k_star(inlier_cnt, params.n_valid, params.confidence, family.sample_size)
    eff_iters = int(np.clip(k_star, _F32(1.0), _F32(max(samples_drawn, 1))))
    total_iters = state.total_iters + eff_iters
    min_needed = max(family.sample_size, int(params.min_inliers))
    tan = float(tanimoto_similarity(pref_p, state.compound_pref))
    accepted = (prop_valid and inlier_cnt >= min_needed
                and tan <= params.max_tanimoto and bool(torch.isfinite(desc).all()))
    rejections = 0 if accepted else state.rejections + 1

    descs, active, labels, energy = state.descs, state.active, state.labels, state.energy
    slot = state.n_slots_used
    if accepted:
        descs = descs.clone()
        descs[slot] = desc
        active = active.clone()
        active[slot] = True
        if int(active.sum()) > 1:
            pres = pearl_run(family, cfg, params, data, pmask, pweights, descs,
                             active, state.labels, adj)
            descs, active, labels = pres.descs, pres.active, pres.labels
            energy = float(pres.energy)
        else:
            labels = torch.where((r2_best < trunc_sq) & pmask, slot, k_slots)

    # compound preference, recomputed from the current descriptors
    pref_all = (truncated_preference(family.squared_residual(data, descs), trunc_sq)
                * active[:, None] * pmask[None, :])
    compound_pref = torch.clamp(pref_all.amax(0), min=0.0)

    # termination (progressive_x.h:495-513, :468-473, :342-344)
    covered = int(((labels != k_slots) & pmask).sum())
    unseen_pts = _F32(max(int(params.n_valid) - covered, 0))
    one_minus_conf = np.clip(_F32(1.0) - params.confidence, _F32(1e-9), _F32(1.0 - 1e-9))
    iters_f = max(_F32(total_iters), _F32(1.0))
    inlier_ratio = (_F32(1.0) - one_minus_conf ** (_F32(1.0) / iters_f)) ** (
        _F32(1.0) / _F32(family.sample_size))
    unseen = np.round(unseen_pts * inlier_ratio)
    n_active_now = int(active.sum())
    done = (state.done or rejections >= int(params.max_rejections)
            or (accepted and unseen < _F32(params.min_inliers))
            or (accepted and n_active_now >= int(params.max_models)))

    new_state = FitState(descs, active, labels, compound_pref,
                         slot + int(accepted), total_iters, rejections, energy, done)
    return new_state, (accepted, inlier_cnt, tan, float(score), energy, n_active_now)


def _check_slice(cfg: EngineConfig):
    later = {
        "final_polish": cfg.final_polish != 0,
        "polish_research": cfg.polish_research != 0,
        "polish_trim": cfg.polish_trim != 0.0,
        "live_progress": cfg.live_progress,
        "neighborhood": cfg.neighborhood != "knn",
        "hyp_axis": cfg.hyp_axis is not None,
    }
    unsupported = [k for k, v in later.items() if v]
    if unsupported:
        raise NotImplementedError(
            f"EngineConfig options {unsupported} belong to later slices of the port")


def spatial_order(data, point_mask):
    """Principal-axis sort of a banded fit, so that kNN neighbors fall in
    a +-potts_band index window (ops/labeling.BandedAdj); padding sorts
    last. Returns (perm, rank): sorted position -> caller's point, and
    caller's point -> sorted position."""
    m = point_mask.to(data.dtype)
    mu = (data * m[:, None]).sum(0) / torch.clamp(m.sum(), min=1.0)
    xc = (data - mu) * m[:, None]
    cov = xc.T @ xc
    v = torch.ones(data.shape[1], dtype=data.dtype, device=data.device)
    for _ in range(8):
        v = cov @ v
        v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-20)
    proj = (data - mu) @ v
    perm = torch.argsort(torch.where(point_mask, proj, float("inf")), stable=True)
    return perm, torch.argsort(perm, stable=True)


def fit(family: ModelFamily, cfg: EngineConfig, params: RuntimeParams, data,
        point_mask, point_weights, generator: torch.Generator | None = None,
        presampled=None) -> FitResult:
    """The full multi-model fit of one padded scene, on the device of
    `data`. Samples come from `generator` (a CPU torch.Generator): restart
    0 draws all of its rounds first, then restart 1, and so on, so that a
    fit on the card and one on the CPU with the same seed see the same
    samples. `presampled = (idx_all [R, B, m], ok_all [R, B],
    idx_ext [S-1, B, m], ok_ext [S-1, B])` replaces the draws of one run
    (a sequence of `n_restarts` such tuples when `n_restarts > 1`), as the
    sampler returns them: PROSAC's in the caller's point order, every other
    sampler's in the sorted order of the fit."""
    _check_slice(cfg)
    n = data.shape[0]
    use_band = cfg.potts_band > 0 and n > 128 + 2 * cfg.potts_band
    rank = None
    if use_band:
        perm, rank = spatial_order(data, point_mask)
        data, point_mask, point_weights = data[perm], point_mask[perm], point_weights[perm]

    samp_idx, samp_mask = knn_graph(data, point_mask, params.neighborhood_radius,
                                    max(cfg.knn_k, cfg.sampler_k))
    knn_idx, knn_mask = samp_idx[:, :cfg.knn_k], samp_mask[:, :cfg.knn_k]
    if use_band:
        adj = adjacency_banded(knn_idx, knn_mask, cfg.potts_band)
    else:
        adj = adjacency_from_knn(knn_idx, knn_mask)

    args = (family, dataclasses.replace(cfg, n_restarts=1), params, data,
            point_mask, point_weights, generator, samp_idx, samp_mask, adj, rank)
    if cfg.n_restarts == 1:
        pre = [presampled]
    else:
        pre = [None] * cfg.n_restarts if presampled is None else list(presampled)
    if len(pre) != cfg.n_restarts:
        raise ValueError(f"presampled holds {len(pre)} runs for "
                         f"{cfg.n_restarts} restarts")
    results = [_fit_prepared(*args, p) for p in pre]
    energies = [float(r.energy) for r in results]  # one read per restart
    best = select_restart(energies, cfg.restart_rule, [r.n_models for r in results])
    result = results[best]._replace(restart=best, restart_energies=tuple(energies))
    if rank is not None:
        result = result._replace(labels=result.labels[rank])
    return result


# restart_rule "energy+<L>k": a selection-time label cost L per instance on
# top of the final energy (see select_restart).
_ENERGY_K_RULE = re.compile(r"energy\+([0-9.]+)k")


def select_restart(energy, rule: str, n_models=None) -> int:
    """The winning restart's index, from the final energies [R] and, for
    "energy+<L>k", the model counts [R] (counterpart of the JAX package's
    engine.select_restart, which also documents why the label cost).

    "energy": argmin of the energy. "energy+<L>k": argmin of
    energy + L * n_models. Runs in numpy on the host."""
    energy = np.asarray(energy, np.float32)
    if rule == "energy" or energy.shape[0] == 1:
        return int(np.argmin(energy))
    m = _ENERGY_K_RULE.fullmatch(rule)
    if m:
        if n_models is None:
            raise ValueError(f"rule {rule!r} needs n_models")
        lam = float(m.group(1))
        return int(np.argmin(energy + lam * np.asarray(n_models).astype(np.float32)))
    raise ValueError(f"unknown restart_rule {rule!r} "
                     "(expected 'energy' or 'energy+<L>k'; 'agreement' "
                     "was retired — see docs/DESIGN_NOTES.md)")


def _draw(gen, cfg, family, params, samp_idx, samp_mask, count):
    samp_idx, samp_mask = samp_idx.to(gen.device), samp_mask.to(gen.device)
    draws = [sample_minimal(gen, cfg.sampler_id, cfg.n_hypotheses,
                            family.sample_size, int(params.n_valid), samp_idx,
                            samp_mask) for _ in range(count)]
    if not draws:
        return (torch.zeros(0, cfg.n_hypotheses, family.sample_size, dtype=torch.long),
                torch.zeros(0, cfg.n_hypotheses, dtype=torch.bool))
    return torch.stack([d[0] for d in draws]), torch.stack([d[1] for d in draws])


def _total_energy(family, params, data, pmask, adj, descs, active, labels):
    """Labeling energy + label cost x live instances (ranks restarts)."""
    trunc_sq = truncated_sq_threshold(params.threshold)
    dcost = data_costs(family.squared_residual(data, descs), active, pmask,
                       params.spatial_weight, trunc_sq)
    e = labeling_energy(dcost, labels, adj, params.spatial_weight)
    return e + float(params.min_inliers) * active.sum()


def _fit_prepared(family, cfg, params, data, point_mask, point_weights,
                  generator, samp_idx, samp_mask, adj, rank=None, presampled=None):
    """One engine run with the neighborhood tensors built. `rank` maps the
    caller's point order to the sorted order of a banded fit."""
    dev = data.device
    n = data.shape[0]
    k_slots = cfg.max_models
    n_sub = max(int(cfg.n_subbatches), 1)
    if presampled is None:
        if generator is None:
            raise ValueError("fit needs a torch.Generator or presampled samples")
        idx_all, ok_all = _draw(generator, cfg, family, params, samp_idx,
                                samp_mask, cfg.max_rounds)
        idx_ext, ok_ext = _draw(generator, cfg, family, params, samp_idx,
                                samp_mask, n_sub - 1)
    else:
        idx_all, ok_all, idx_ext, ok_ext = presampled
    idx_all, ok_all, idx_ext, ok_ext = (
        t.to(dev) for t in (idx_all, ok_all, idx_ext, ok_ext))
    idx_all, idx_ext = idx_all.long(), idx_ext.long()
    if cfg.sampler_id == 1 and rank is not None:
        # PROSAC draws in quality order, the caller's row order: map its
        # indices through the spatial sort (every other sampler draws in
        # sorted order already).
        idx_all, idx_ext = rank[idx_all], rank[idx_ext]

    state = FitState(
        descs=torch.zeros(k_slots, family.desc_dim, dtype=data.dtype, device=dev),
        active=torch.zeros(k_slots, dtype=torch.bool, device=dev),
        labels=torch.full((n,), k_slots, dtype=torch.long, device=dev),
        compound_pref=torch.zeros(n, dtype=data.dtype, device=dev),
        n_slots_used=0, total_iters=0, rejections=0, energy=float("nan"),
        done=False)
    log = RoundLog([], [], [], [], [], [])
    rounds = 0
    while not state.done and rounds < cfg.max_rounds:
        state, stats = _round(family, cfg, params, data, point_mask,
                              point_weights, idx_all[rounds], ok_all[rounds],
                              idx_ext, ok_ext, adj, state)
        for col, v in zip(log, stats):
            col.append(v)
        rounds += 1

    descs, active, labels = state.descs, state.active, state.labels
    if cfg.split_pass:
        descs, active, labels = split_instances(
            family, cfg, params, data, point_mask, point_weights, descs,
            active, labels, adj, n_rounds=cfg.split_pass)
    if cfg.merge_pass:
        descs, active, labels = merge_instances(
            family, cfg, params, data, point_mask, point_weights, descs,
            active, labels, adj)
    trunc_sq = truncated_sq_threshold(params.threshold)
    r2_f = family.squared_residual(data, descs)
    if cfg.final_relabel > 0:
        dcost_f = data_costs(r2_f, active, point_mask, params.spatial_weight, trunc_sq)
        labels, _ = icm_sweeps(dcost_f, labels, adj, params.spatial_weight,
                               cfg.final_relabel)
    pref_f = truncated_preference(r2_f, trunc_sq) * active[:, None] * point_mask[None, :]
    return FitResult(
        descs=descs,
        active=active,
        labels=labels,
        n_models=int(active.sum()),
        total_iters=state.total_iters,
        rounds_run=rounds,
        energy=_total_energy(family, params, data, point_mask, adj, descs,
                             active, labels),
        round_log=log,
        compound_pref=torch.clamp(pref_f.amax(0), min=0.0),
    )


def compact_result(result: FitResult, n_valid: int):
    """Renumber active slots to 0..K-1 in insertion order; outliers get K
    (the reference labeling convention). Returns numpy (descs, labels)."""
    active = result.active.cpu().numpy()
    descs = result.descs.cpu().numpy()[active]
    remap = np.full(active.shape[0] + 1, descs.shape[0], np.int64)
    remap[:active.shape[0]][active] = np.arange(descs.shape[0])
    labels = remap[result.labels.cpu().numpy()][:n_valid]
    return descs, labels.astype(np.int32)
