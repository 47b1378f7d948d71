"""The Progressive-X outer loop — counterpart of progressivex_tpu/core/engine.py.

Per round: propose one model from a batch of minimal samples scored in one
pass (the fused kernel on the card), polish the top candidates with
spatially weighted IRLS, validate against the compound instance (min
inliers + Tanimoto, progressive_x.h:565-591), run PEARL, update the
compound preference, and stop on the reference's termination rules
(progressive_x.h:495-513).

`fit_rows` runs R independent fits at once on a leading row axis: scenes
of one pad level, restarts, or both (the JAX package's
`jax.vmap(engine.fit)` over rows, api_batch.py:45-84). Every per-row
decision (accepted, the slot written, PEARL or not, the sub-batch count,
done) is a tensor of shape [R]; a row that is done is frozen the way the
JAX round body freezes it (progressivex_tpu/core/engine.py:942-954), its
round log included, so a row's result does not depend on the other rows.
The Python loops read one boolean at a time: "are all rows done" once a
round, and "does any row go on" in the sub-batch, LO, PEARL and ICM loops.
`fit` is one scene: a call of `fit_rows` with its `n_restarts` restarts as
rows, and `select_restart` picks the winner on the host, as the JAX
package vmaps restarts.

After the rounds come the final moves, in the JAX package's order
(progressivex_tpu/core/engine.py:967-1010): split, merge,
`_final_polish`, `_polish_research` (all on the row axis), then the final
relabel. A fit may build its principal-axis sort and kNN graph on other
coordinates than the model's (`graph_data`: the 6D-pose front ends' pixel
and world rows).

Samples are drawn for all rounds before the loop, on CPU generators, one
a row, so that the card and the CPU see the same samples for the same
seeds; a row's generator draws all of that row's rounds, then its
extension sub-batches. `fit` hands every restart the same generator, so
restart 0 draws first, then restart 1, and so on. The `presampled`
argument replaces the draws (a test replays the JAX package's exact
samples through it).

Hypothesis parallelism (`cfg.hyp_axis`, the JAX package's hyp mesh axis,
progressivex_tpu/core/engine.py:374-381, :850-854): every row runs H
replicas of its proposal, each on samples of its own (a generator a
replica, in place of JAX's fold_in of the axis index), each with its own
sub-batch search, top-T and LO; the round's winner is the argmax of the
H replicas' scores (ties to the lowest replica, as jnp.argmax) and the
samples drawn are their sum. Replicas on the fit's device run as extra
rows of one proposal; replicas on another device (`hyp_devices`) get
copies of the round's inputs there and send their winners back. The rest
of the round runs once a row: in the JAX package every replica runs it on
the same inputs.

Live progress (`cfg.live_progress`): after each pass of the round loop,
`LIVE_CALLBACK` receives one dict a row, in row order, with the JAX
package's keys (progressivex_tpu/core/engine.py:71-94): a row's "round" is
its rounds run before the pass, frozen once the row is done, as the vmapped
JAX loop emits it. Without it the loop reads nothing more to the host.
Phases are tagged with `torch.profiler.record_function` under the JAX
package's scope names (progx_graph, progx_sampling, progx_proposal,
progx_pearl, and in core/pearl.py progx_labeling and progx_refit), which
`io/profiling.measure_phase_times` reads; a tag costs no launch.
"""

from __future__ import annotations

import dataclasses
import re
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from progressivex_tpu_torch._device import run_per_device
from progressivex_tpu_torch.core.config import (EngineConfig, RuntimeParams, per_row,
                                                rows_params, truncated_sq_threshold)
from progressivex_tpu_torch.core.pearl import (_top_k, merge_instances, pearl_run,
                                               split_instances)
from progressivex_tpu_torch.models.base import ModelFamily
from progressivex_tpu_torch.ops.knn import grid_graph, knn_graph
from progressivex_tpu_torch.ops.linalg import gram, row_sum
from progressivex_tpu_torch.ops.labeling import (
    BandedAdj,
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

# The live-progress consumer (cfg.live_progress): a callable taking one
# dict a row and round, {"round", "accepted", "inliers", "tanimoto",
# "score", "energy", "n_active", "labels"}. The API layer sets it for the
# length of a call (api.find* progress_callback), as the JAX package does;
# not thread-safe.
LIVE_CALLBACK = None


def _emit_progress(rounds, stats, labels):
    """One event a row: rounds [R] before this pass, the round's
    statistics ([R] each) and labels [R, N], read to the host at once."""
    cb = LIVE_CALLBACK
    if cb is None:
        return
    rounds, accepted, inliers, tan, score, energy, n_active = (
        t.cpu().numpy() for t in (rounds, *stats))
    labels = labels.cpu().numpy()
    for r in range(rounds.shape[0]):
        cb({"round": int(rounds[r]), "accepted": bool(accepted[r]),
            "inliers": int(inliers[r]), "tanimoto": float(tan[r]),
            "score": float(score[r]), "energy": float(energy[r]),
            "n_active": int(n_active[r]), "labels": labels[r]})


class FitState(NamedTuple):
    """The round loop's carry, one entry per row."""

    descs: torch.Tensor  # [R, K, D]
    active: torch.Tensor  # [R, K] bool
    labels: torch.Tensor  # [R, N] int64 slot labels, K = outlier
    compound_pref: torch.Tensor  # [R, N]
    n_slots_used: torch.Tensor  # [R] int64
    total_iters: torch.Tensor  # [R] int64: minimal samples drawn (k*-capped)
    rejections: torch.Tensor  # [R] int64: consecutive rejected proposals
    energy: torch.Tensor  # [R] PEARL energy of the last accepted state (NaN before)
    done: torch.Tensor  # [R] bool


class RoundLog(NamedTuple):
    """Per-round statistics (progressive_x.h:75-82): [R, max_rounds]
    tensors in `fit_rows`' result, a list with one entry per round run in
    one row's (`row_result`)."""

    accepted: list
    inliers: list
    tanimoto: list
    score: list
    energy: list
    n_active: list


class FitResult(NamedTuple):
    """One fit. `fit_rows` returns the same fields with a leading row axis
    (n_models, total_iters, rounds_run and energy [R] tensors);
    `row_result` takes one row out."""

    descs: torch.Tensor  # [K, D]
    active: torch.Tensor  # [K] bool
    labels: torch.Tensor  # [N] int64 slot labels, K = outlier
    n_models: int
    total_iters: int
    rounds_run: int
    energy: torch.Tensor  # final total energy (data + Potts + label costs)
    round_log: RoundLog
    compound_pref: torch.Tensor  # [N] of the final descriptors
    samples_drawn: torch.Tensor  # minimal samples drawn in the proposals, every
    # replica's, before total_iters' k* cap
    restart: int = 0  # index of the winning restart
    restart_energies: tuple = ()  # final energy of every restart


def _k_star(inliers, n_valid, confidence, sample_size):
    """RANSAC k* = log(1 - conf) / log(1 - w^m) in float32, per row."""
    one_minus_conf = np.clip(_F32(1.0) - confidence, _F32(1e-9), _F32(1.0 - 1e-9))
    w_best = inliers.to(torch.float32) / torch.clamp(n_valid.to(torch.float32), min=1.0)
    miss = torch.clamp(1.0 - w_best ** sample_size, float(_F32(1e-9)),
                       float(_F32(1.0 - 1e-9)))
    # miss rounds to 1 in f32: log(miss) = 0 and k* is infinite
    return torch.ceil(float(np.log(one_minus_conf)) / torch.log(miss))


def _take(x, idx):
    """x [R, M, ...] at idx [R, T] along the second axis -> [R, T, ...]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _search(family, cfg, params, data, pmask, pweights, idx, samp_ok,
            idx_ext, ok_ext, adj, compound_pref, has_compound):
    """One batched proposal + spatially coherent IRLS local optimization
    on every row. data [R, N, d], idx [R, B, m], samp_ok [R, B], idx_ext
    [R, S-1, B, m], compound_pref [R, N], has_compound [R]. Returns
    (desc [R, D], score [R], samples_drawn [R])."""
    rows = data.shape[0]
    ar = torch.arange(rows, device=data.device)
    trunc_sq = truncated_sq_threshold(params.threshold)  # [R]
    n_sub = 1 + idx_ext.shape[1]
    b_samples = idx.shape[1]
    bs = b_samples * family.max_solutions
    t = cfg.lo_candidates
    dim = family.desc_dim
    min_needed = max(family.sample_size, int(params.min_inliers))
    cn = row_sum(compound_pref * compound_pref)  # [R]

    def score(descs):
        return family.scorer(data, descs, compound_pref, pmask, trunc_sq,
                             params.scoring_exponent, has_compound,
                             cfg.magsac_levels)

    # Sub-batches until the sample count exceeds k* of the best hypothesis
    # (the batched form of GC-RANSAC's adaptive termination), per row: a
    # row that has enough is held while the others draw on.
    cand_descs = torch.zeros(rows, t, dim, dtype=data.dtype, device=data.device)
    cand_scores = torch.full((rows, t), _NEG, dtype=torch.float32, device=data.device)
    raw_desc = torch.zeros(rows, dim, dtype=data.dtype, device=data.device)
    raw_score = torch.full((rows,), _NEG, dtype=torch.float32, device=data.device)
    raw_inl = torch.zeros(rows, dtype=torch.int32, device=data.device)
    drawn = torch.zeros(rows, dtype=torch.int64, device=data.device)
    want = torch.ones(rows, dtype=torch.bool, device=data.device)
    for s in range(n_sub):
        if s > 0:
            want = want & (s * b_samples < _k_star(raw_inl, params.n_valid,
                                                   params.confidence,
                                                   family.sample_size))
            if not bool(want.any()):
                break
        idx_s, ok_s = (idx, samp_ok) if s == 0 else (idx_ext[:, s - 1], ok_ext[:, s - 1])
        samples = data[ar[:, None, None], idx_s]  # [R, B, m, d]
        descs_h, valid_h = family.minimal_solver_batched(
            samples.reshape(rows * b_samples, *samples.shape[2:]))
        descs_f = descs_h.reshape(rows, bs, dim)
        valid_f = (valid_h.reshape(rows, b_samples, -1) & ok_s[..., None]).reshape(rows, bs)
        scores, inliers, dots, norms = score(descs_f)
        scores = torch.where(valid_f & torch.isfinite(scores), scores, _NEG)
        # Prefer hypotheses that pass validation (min inliers + Tanimoto).
        den = norms + cn[:, None] - dots
        tan = torch.where(den > 1e-12, dots / den, 0.0)
        admissible = (inliers >= min_needed) & (tan <= params.max_tanimoto)
        scores_adm = torch.where(admissible, scores, _NEG)
        sb_ids = _top_k(scores_adm, t)
        merged_scores = torch.cat([cand_scores, _take(scores_adm, sb_ids)], -1)
        merged_descs = torch.cat([cand_descs, _take(descs_f, sb_ids)], 1)
        keep = _top_k(merged_scores, t)
        cand_descs = torch.where(want[:, None, None], _take(merged_descs, keep), cand_descs)
        cand_scores = torch.where(want[:, None], _take(merged_scores, keep), cand_scores)
        rb = scores.argmax(-1)
        better = want & (scores[ar, rb] > raw_score)
        raw_desc = torch.where(better[:, None], descs_f[ar, rb], raw_desc)
        raw_score = torch.where(better, scores[ar, rb], raw_score)
        raw_inl = torch.where(better, inliers[ar, rb], raw_inl)
        drawn = drawn + want
    samples_drawn = drawn * b_samples

    # Local optimization of the top-T candidates (all at once); selection
    # happens after LO. With no admissible candidate, polish the raw best.
    no_adm = ~(cand_scores.amax(-1) > _NEG / 2)
    cand_descs = torch.where(no_adm[:, None, None], raw_desc[:, None, :], cand_descs)
    cand_scores = torch.where(no_adm[:, None], raw_score[:, None], cand_scores)
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
        return pref * pweights[:, None, :] * pmask[:, None, :]

    d, sc = cand_descs, cand_scores
    improving = torch.ones(rows, t, dtype=torch.bool, device=data.device)
    for _ in range(cfg.lo_steps):
        nd, ok = family.refit(data, lo_weight(family.squared_residual(data, d)), d)
        s_new = score(nd)[0]
        pref_n = (truncated_preference(family.squared_residual(data, nd), trunc_sq)
                  * pmask[:, None, :])
        tan_n = tanimoto_similarity(pref_n, compound_pref[:, None, :])
        better = (improving & ok & torch.isfinite(s_new) & (s_new > sc)
                  & (tan_n <= params.max_tanimoto))
        d = torch.where(better[..., None], nd, d)
        sc = torch.where(better, s_new, sc)
        improving = better
        if not bool(improving.any()):
            break
    scores_lo = torch.where(cand_valid, sc, _NEG)
    best_t = scores_lo.argmax(-1)
    return d[ar, best_t], scores_lo[ar, best_t], samples_drawn


def _repeat_rows(x, k: int):
    """Every row of x [R, ...] k times in a row -> [R * k, ...] (a
    BandedAdj's tensors alike, a scalar as it is)."""
    if isinstance(x, BandedAdj):
        return BandedAdj(*(_repeat_rows(t, k) for t in x))
    if k == 1 or not isinstance(x, torch.Tensor) or x.ndim == 0:
        return x
    return x.repeat_interleave(k, dim=0)


def _to(x, dev):
    if isinstance(x, BandedAdj):
        return BandedAdj(*(t.to(dev) for t in x))
    return x.to(dev) if isinstance(x, torch.Tensor) else x


class _Replicas:
    """The hyp axis of a fit: H replicas of every row's proposal, grouped
    by device. A group's inputs are the fit's tensors on its device, each
    row repeated once a replica of the group (row r, replica j of the
    group at r * k + j), made once a fit; its samples [R, H, ...] are the
    group's replicas' (idx_all [R, H, rounds, B, m], ok_all [R, H,
    rounds, B], idx_ext [R, H, S-1, B, m], ok_ext [R, H, S-1, B])."""

    def __init__(self, devices, params, data, pmask, pweights, adj, idx_all, ok_all,
                 idx_ext, ok_ext):
        self.home = data.device
        self.n_rows, self.n_hyp = idx_all.shape[:2]
        if len(devices) != self.n_hyp:
            raise ValueError(f"{len(devices)} replica devices for {self.n_hyp} replicas")
        by_dev: dict = {}
        for h, dev in enumerate(devices):
            by_dev.setdefault(torch.device(dev), []).append(h)
        self.groups = []
        for dev, hs in by_dev.items():
            k = len(hs)

            def rows(x):
                return _repeat_rows(_to(x, dev), k)

            def samples(t):
                # all replicas on one device take the samples as they are
                # (a list index would copy itself to the card and wait)
                t = t if k == self.n_hyp else t[:, hs]
                return t.to(dev).reshape(self.n_rows * k, *t.shape[2:])

            self.groups.append({
                "device": dev, "replicas": hs,
                "params": params._replace(threshold=rows(params.threshold),
                                          n_valid=rows(params.n_valid)),
                "inputs": tuple(rows(x) for x in (data, pmask, pweights)),
                "adj": rows(adj),
                "samples": tuple(samples(t) for t in (idx_all, ok_all, idx_ext, ok_ext)),
            })
        # The groups' winners come back in group order; this device index
        # puts them in replica order (None when they already are).
        order = [h for g in self.groups for h in g["replicas"]]
        self.perm = (None if order == list(range(self.n_hyp))
                     else torch.as_tensor(np.argsort(order), device=self.home))

    def propose(self, family, cfg, rnd, compound_pref, has_compound):
        """Round `rnd`'s proposal of every replica, reduced to one winner a
        row on the fit's device: (desc [R, D], score [R], samples_drawn
        [R])."""
        def group_search(g):
            k = len(g["replicas"])
            idx_all, ok_all, idx_ext, ok_ext = g["samples"]
            return _search(family, cfg, g["params"], *g["inputs"], idx_all[:, rnd],
                           ok_all[:, rnd], idx_ext, ok_ext, g["adj"],
                           _repeat_rows(compound_pref.to(g["device"]), k),
                           _repeat_rows(has_compound.to(g["device"]), k))

        outs = run_per_device(group_search, [(g["device"], (g,)) for g in self.groups])
        r = self.n_rows

        def gather(i):
            # [R, H, ...]: every group's [R * k, ...] as [R, k, ...], in replica order
            parts = [out[i].to(self.home).reshape(r, len(g["replicas"]), *out[i].shape[1:])
                     for g, out in zip(self.groups, outs)]
            t = parts[0] if len(parts) == 1 else torch.cat(parts, 1)
            return t if self.perm is None else t.index_select(1, self.perm)

        desc, score, drawn = gather(0), gather(1), gather(2)
        best = score.argmax(1)  # the first maximum, as jnp.argmax
        ar = torch.arange(r, device=self.home)
        return desc[ar, best], score[ar, best], drawn.sum(1)


def _make_propose(family, cfg, params, data, pmask, pweights, adj, samples,
                  hyp_devices=None):
    """The proposal of a fit's rounds, `propose(rnd, compound_pref,
    has_compound)` -> (desc [R, D], score [R], samples_drawn [R]) of round
    rnd on every row: `_search` on the round's samples, or with
    `cfg.hyp_axis` set the H replicas of `_Replicas` reduced to one winner
    a row. `samples` is `fit_rows`' `presampled` on the device of `data`
    (with its replica axis under cfg.hyp_axis), `hyp_devices` the device
    of each replica (the device of `data` for all if None)."""
    idx_all, ok_all, idx_ext, ok_ext = samples
    if cfg.hyp_axis is None:
        def propose(rnd, compound_pref, has_compound):
            return _search(family, cfg, params, data, pmask, pweights, idx_all[:, rnd],
                           ok_all[:, rnd], idx_ext, ok_ext, adj, compound_pref,
                           has_compound)
        return propose
    replicas = _Replicas([data.device] * idx_all.shape[1] if hyp_devices is None
                         else hyp_devices, params, data, pmask, pweights, adj, idx_all,
                         ok_all, idx_ext, ok_ext)

    def propose(rnd, compound_pref, has_compound):
        return replicas.propose(family, cfg, rnd, compound_pref, has_compound)
    return propose


def _round(family, cfg, params, data, pmask, pweights, adj, propose, state: FitState):
    """One propose -> validate -> optimize -> update -> terminate round on
    every row; `propose(compound_pref, has_compound)` is the round's
    proposal, (desc [R, D], score [R], samples_drawn [R]). Returns (new
    state, per-row statistics, samples drawn [R]); the caller keeps the
    old state of rows that were done."""
    k_slots = cfg.max_models
    trunc_sq = truncated_sq_threshold(params.threshold)  # [R]
    has_compound = state.active.any(-1)

    with record_function("progx_proposal"):
        desc, score, samples_drawn = propose(state.compound_pref, has_compound)
        prop_valid = score > _NEG / 2
        r2_best = family.squared_residual(data, desc)

    # validation (progressive_x.h:565-591), inliers at the raw threshold
    pref_p = truncated_preference(r2_best, trunc_sq) * pmask
    thr = params.threshold
    inlier_cnt = ((r2_best < (thr * thr)[:, None]) & pmask).sum(-1)
    k_star = _k_star(inlier_cnt, params.n_valid, params.confidence, family.sample_size)
    eff_iters = torch.clamp(
        k_star, min=torch.ones_like(k_star),
        max=torch.clamp(samples_drawn, min=1).to(k_star.dtype)).to(torch.int64)
    total_iters = state.total_iters + eff_iters
    min_needed = max(family.sample_size, int(params.min_inliers))
    tan = tanimoto_similarity(pref_p, state.compound_pref)
    accepted = (prop_valid & (inlier_cnt >= min_needed)
                & (tan <= params.max_tanimoto) & torch.isfinite(desc).all(-1))
    rejections = torch.where(accepted, 0, state.rejections + 1)

    # The slot write, a per-row scatter; PEARL where a row accepted and
    # holds more than one model, selected per row as the vmapped lax.cond
    # selects.
    slot = state.n_slots_used
    write = (torch.arange(k_slots, device=data.device) == slot[:, None]) & accepted[:, None]
    descs = torch.where(write[..., None], desc[:, None, :], state.descs)
    active = state.active | write
    run_pearl = accepted & (active.sum(-1) > 1)
    first = accepted & ~run_pearl
    first_labels = torch.where((r2_best < trunc_sq[:, None]) & pmask, slot[:, None], k_slots)
    labels = torch.where(first[:, None], first_labels, state.labels)
    energy = state.energy
    if bool(run_pearl.any()):
        with record_function("progx_pearl"):
            pres = pearl_run(family, cfg, params, data, pmask, pweights, descs,
                             active, state.labels, adj)
        descs = torch.where(run_pearl[:, None, None], pres.descs, descs)
        active = torch.where(run_pearl[:, None], pres.active, active)
        labels = torch.where(run_pearl[:, None], pres.labels, labels)
        energy = torch.where(run_pearl, pres.energy, energy)

    # compound preference, recomputed from the current descriptors
    pref_all = (truncated_preference(family.squared_residual(data, descs), trunc_sq)
                * active[..., None] * pmask[:, None, :])
    compound_pref = torch.clamp(pref_all.amax(-2), min=0.0)

    # termination (progressive_x.h:495-513, :468-473, :342-344)
    covered = ((labels != k_slots) & pmask).sum(-1)
    unseen_pts = torch.clamp(params.n_valid - covered, min=0).to(torch.float32)
    one_minus_conf = np.clip(_F32(1.0) - params.confidence, _F32(1e-9), _F32(1.0 - 1e-9))
    iters_f = torch.clamp(total_iters.to(torch.float32), min=1.0)
    inlier_ratio = (1.0 - float(one_minus_conf) ** (1.0 / iters_f)) ** float(
        _F32(1.0) / _F32(family.sample_size))
    unseen = torch.round(unseen_pts * inlier_ratio)
    n_active_now = active.sum(-1)
    done = (state.done | (rejections >= int(params.max_rejections))
            | (accepted & (unseen < float(params.min_inliers)))
            | (accepted & (n_active_now >= int(params.max_models))))

    new_state = FitState(descs, active, labels, compound_pref, slot + accepted,
                         total_iters, rejections, energy, done)
    return (new_state, (accepted, inlier_cnt, tan, score, energy, n_active_now),
            samples_drawn)


def _check_slice(cfg: EngineConfig):
    if cfg.neighborhood not in ("knn", "grid"):
        raise ValueError(f"unknown neighborhood {cfg.neighborhood!r}")


def spatial_order(data, point_mask):
    """Principal-axis sort of a banded fit, so that kNN neighbors fall in
    a +-potts_band index window (ops/labeling.BandedAdj); padding sorts
    last. data [(R,) N, d] are the graph coordinates (the fit's data
    unless the caller gives others), point_mask [(R,) N]. Returns (perm,
    rank), [(R,) N] each: sorted position -> caller's point, and caller's
    point -> sorted position."""
    m = point_mask.to(data.dtype)
    mu = row_sum(data * m[..., None], -2) / torch.clamp(m.sum(-1), min=1.0)[..., None]
    xc = (data - mu[..., None, :]) * m[..., None]
    cov = gram(xc, xc)
    v = torch.ones(*data.shape[:-2], data.shape[-1], dtype=data.dtype, device=data.device)
    # Small products as elementwise products and sums over d, so that a
    # row's sort does not depend on how many rows there are.
    for _ in range(8):
        v = (cov * v[..., None, :]).sum(-1)
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-20)
    proj = ((data - mu[..., None, :]) * v[..., None, :]).sum(-1)
    perm = torch.argsort(torch.where(point_mask, proj, float("inf")), dim=-1, stable=True)
    return perm, torch.argsort(perm, dim=-1, stable=True)


def fit_rows(family: ModelFamily, cfg: EngineConfig, params: RuntimeParams, data,
             point_mask, point_weights, generators=None, presampled=None,
             graph_data=None, hyp_devices=None) -> FitResult:
    """R independent fits on the device of `data`: data [R, N, d], point
    mask and weights [R, N], `params.threshold` and `params.n_valid`
    shared or one a row ([R]). `graph_data` [R, N, d'], if given, are the
    coordinates of the principal-axis sort and the kNN graph in place of
    `data` (the 6D-pose front ends build the graph on pixels and world
    points, progressivex_tpu/core/engine.py:516-551). `cfg.n_restarts` is
    not read: restarts are rows. Samples come from `generators`, R CPU torch.Generators (one
    object may serve several rows: each row draws all of its rounds, then
    its extension sub-batches, in row order), or from `presampled =
    (idx_all [R, rounds, B, m], ok_all [R, rounds, B], idx_ext
    [R, S-1, B, m], ok_ext [R, S-1, B])` as the sampler returns them:
    PROSAC's in the caller's point order, every other sampler's in the
    sorted order of the fit. Returns a FitResult with a leading row axis,
    labels in the caller's point order.

    With `cfg.hyp_axis` set, each row runs H replicas of its proposal:
    `generators` holds H generators a row (replica h draws its rounds,
    then its extension sub-batches, from the h-th, replica after replica),
    `presampled` a replica axis after the row axis (idx_all [R, H, rounds,
    B, m], ok_all [R, H, rounds, B], idx_ext [R, H, S-1, B, m], ok_ext
    [R, H, S-1, B]), and `hyp_devices` the device of each replica (the
    device of `data` for all if None)."""
    _check_slice(cfg)
    n_rows, n = data.shape[:2]
    dev = data.device
    n_valid_host = np.broadcast_to(np.asarray(
        params.n_valid.cpu() if isinstance(params.n_valid, torch.Tensor)
        else params.n_valid), (n_rows,))
    params = rows_params(params, n_rows, dev)
    use_band = cfg.potts_band > 0 and n > 128 + 2 * cfg.potts_band
    gd = data if graph_data is None else graph_data
    rank = None
    if use_band:
        perm, rank = spatial_order(gd, point_mask)

        def sort(t):
            return t.gather(1, perm[..., None].expand(-1, -1, t.shape[2]))

        data, gd = sort(data), sort(gd)
        point_mask, point_weights = point_mask.gather(1, perm), point_weights.gather(1, perm)

    with record_function("progx_graph"):
        # One call serves both neighborhoods: the first knn_k columns are
        # the Potts graph, all of them the sampler's; under "grid" the
        # radius is the cell width.
        graph = grid_graph if cfg.neighborhood == "grid" else knn_graph
        samp_idx, samp_mask = graph(gd, point_mask, params.neighborhood_radius,
                                    max(cfg.knn_k, cfg.sampler_k))
        knn_idx, knn_mask = samp_idx[..., :cfg.knn_k], samp_mask[..., :cfg.knn_k]
        if use_band:
            adj = adjacency_banded(knn_idx, knn_mask, cfg.potts_band)
        else:
            adj = adjacency_from_knn(knn_idx, knn_mask)

    n_sub = max(int(cfg.n_subbatches), 1)
    if presampled is None:
        if generators is None:
            raise ValueError("fit needs a torch.Generator or presampled samples")
        if len(generators) != n_rows:
            raise ValueError(f"{len(generators)} generators for {n_rows} rows")
        if cfg.hyp_axis is not None:
            n_hyp = {len(g) for g in generators}
            if len(n_hyp) != 1:
                raise ValueError(f"hyp_axis needs the same number of generators a "
                                 f"row, have {sorted(n_hyp)}")
        with record_function("progx_sampling"):
            presampled = _draw(generators, cfg, family, n_valid_host, samp_idx,
                               samp_mask, n_sub)
    idx_all, ok_all, idx_ext, ok_ext = (t.to(dev) for t in presampled)
    idx_all, idx_ext = idx_all.long(), idx_ext.long()
    if idx_all.ndim != (5 if cfg.hyp_axis is not None else 4):
        raise ValueError(f"samples of shape {tuple(idx_all.shape)} for hyp_axis "
                         f"{cfg.hyp_axis!r}")
    if cfg.sampler_id == 1 and rank is not None:
        # PROSAC draws in quality order, the caller's row order: map its
        # indices through the spatial sort (every other sampler draws in
        # sorted order already).
        idx_all, idx_ext = (rank.gather(1, i.reshape(n_rows, -1)).reshape(i.shape)
                            for i in (idx_all, idx_ext))
    propose = _make_propose(family, cfg, params, data, point_mask, point_weights, adj,
                            (idx_all, ok_all, idx_ext, ok_ext), hyp_devices)
    return _fit_prepared(family, cfg, params, data, point_mask, point_weights,
                         adj, propose, rank)


def _fit_prepared(family, cfg, params, data, point_mask, point_weights, adj,
                  propose, rank):
    """The round loop and the final moves of `fit_rows`, with the
    neighborhood tensors built and the samples drawn: `propose(rnd,
    compound_pref, has_compound)` is round rnd's proposal. `rank` maps the
    caller's point order to the sorted order of a banded fit."""
    dev = data.device
    n_rows, n = data.shape[:2]
    k_slots = cfg.max_models

    def zeros(dtype):
        return torch.zeros(n_rows, dtype=dtype, device=dev)

    state = FitState(
        descs=torch.zeros(n_rows, k_slots, family.desc_dim, dtype=data.dtype, device=dev),
        active=torch.zeros(n_rows, k_slots, dtype=torch.bool, device=dev),
        labels=torch.full((n_rows, n), k_slots, dtype=torch.long, device=dev),
        compound_pref=torch.zeros(n_rows, n, dtype=data.dtype, device=dev),
        n_slots_used=zeros(torch.int64), total_iters=zeros(torch.int64),
        rejections=zeros(torch.int64),
        energy=torch.full((n_rows,), float("nan"), device=dev),
        done=zeros(torch.bool))
    log = RoundLog(*(torch.zeros(n_rows, cfg.max_rounds, dtype=dt, device=dev)
                     for dt in (torch.bool, torch.int64, torch.float32,
                                torch.float32, torch.float32, torch.int64)))
    rounds_run = zeros(torch.int64)
    samples_drawn = zeros(torch.int64)
    for rnd in range(cfg.max_rounds):
        if rnd > 0 and bool(state.done.all()):
            break
        new_state, stats, drawn = _round(
            family, cfg, params, data, point_mask, point_weights, adj,
            lambda *a, rnd=rnd: propose(rnd, *a), state)
        if cfg.live_progress:
            _emit_progress(rounds_run, stats, new_state.labels)
        live = ~state.done  # rows that were done keep their state and log
        for col, v in zip(log, stats):
            col[:, rnd] = torch.where(live, v.to(col.dtype), col[:, rnd])
        state = FitState(*(torch.where(per_row(live, new.ndim), new, old)
                           for new, old in zip(new_state, state)))
        rounds_run = rounds_run + live
        samples_drawn = samples_drawn + torch.where(live, drawn, 0)

    descs, active, labels = state.descs, state.active, state.labels
    moves = (family, cfg, params, data, point_mask, point_weights)
    if cfg.split_pass:
        descs, active, labels = split_instances(*moves, descs, active, labels, adj,
                                                n_rounds=cfg.split_pass)
    if cfg.merge_pass:
        descs, active, labels = merge_instances(*moves, descs, active, labels, adj)
    if cfg.final_polish > 0:
        descs = _final_polish(family, cfg, params, data, point_mask, point_weights,
                              descs, active, labels)
    if cfg.polish_research > 0:
        # The last descriptor pass (see the JAX package's config.py).
        descs = _polish_research(family, cfg, params, data, point_mask,
                                 point_weights, descs, active, labels)
    trunc_sq = truncated_sq_threshold(params.threshold)
    r2_f = family.squared_residual(data, descs)
    if cfg.final_relabel > 0:
        dcost_f = data_costs(r2_f, active, point_mask, params.spatial_weight, trunc_sq)
        labels, _ = icm_sweeps(dcost_f, labels, adj, params.spatial_weight,
                               cfg.final_relabel)
    pref_f = (truncated_preference(r2_f, trunc_sq) * active[..., None]
              * point_mask[:, None, :])
    energy = _total_energy(family, params, data, point_mask, adj, descs, active, labels)
    if rank is not None:
        labels = labels.gather(1, rank)  # back to the caller's point order
    return FitResult(
        descs=descs,
        active=active,
        labels=labels,
        n_models=active.sum(-1),
        total_iters=state.total_iters,
        rounds_run=rounds_run,
        energy=energy,
        round_log=log,
        compound_pref=torch.clamp(pref_f.amax(-2), min=0.0),
        samples_drawn=samples_drawn,
    )


def row_result(rows: FitResult, r: int) -> FitResult:
    """Row r of `fit_rows`' result as one fit, its counts and round log
    read to the host."""
    n_rounds = int(rows.rounds_run[r])
    return FitResult(
        descs=rows.descs[r], active=rows.active[r], labels=rows.labels[r],
        n_models=int(rows.n_models[r]), total_iters=int(rows.total_iters[r]),
        rounds_run=n_rounds, energy=rows.energy[r],
        round_log=RoundLog(*(col[r, :n_rounds].tolist() for col in rows.round_log)),
        compound_pref=rows.compound_pref[r], samples_drawn=int(rows.samples_drawn[r]))


def fit(family: ModelFamily, cfg: EngineConfig, params: RuntimeParams, data,
        point_mask, point_weights, generator: torch.Generator | None = None,
        presampled=None, graph_data=None) -> FitResult:
    """The full multi-model fit of one padded scene (data [N, d], point
    mask and weights [N], graph coordinates `graph_data` [N, d'] if not
    those of `data`), on the device of `data`: its `cfg.n_restarts`
    restarts run as the rows of one `fit_rows` call, and `select_restart`
    picks the winner. Samples come from `generator` (a CPU
    torch.Generator): restart 0 draws all of its rounds first, then
    restart 1, and so on, so that a fit on the card and one on the CPU
    with the same seed see the same samples. `presampled = (idx_all
    [rounds, B, m], ok_all [rounds, B], idx_ext [S-1, B, m], ok_ext
    [S-1, B])` replaces the draws of one run (a sequence of `n_restarts`
    such tuples when `n_restarts > 1`), as the sampler returns them."""
    _check_slice(cfg)
    n_restarts = cfg.n_restarts
    if presampled is not None:
        runs = [presampled] if n_restarts == 1 else list(presampled)
        if len(runs) != n_restarts:
            raise ValueError(f"presampled holds {len(runs)} runs for "
                             f"{n_restarts} restarts")
        presampled = tuple(torch.stack([torch.as_tensor(run[i]) for run in runs])
                           for i in range(4))
    elif generator is None:
        raise ValueError("fit needs a torch.Generator or presampled samples")

    def rows(t):
        return t[None].repeat(n_restarts, *([1] * t.ndim))

    res = fit_rows(family, dataclasses.replace(cfg, n_restarts=1), params,
                   rows(data), rows(point_mask), rows(point_weights),
                   generators=[generator] * n_restarts, presampled=presampled,
                   graph_data=None if graph_data is None else rows(graph_data))
    energies = res.energy.tolist()  # one read for every restart
    best = select_restart(energies, cfg.restart_rule, res.n_models.tolist())
    return row_result(res, best)._replace(restart=best,
                                          restart_energies=tuple(energies))


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


def _draw(generators, cfg, family, n_valid, samp_idx, samp_mask, n_sub):
    """Every row's samples, drawn on the host from its generator: the
    row's max_rounds proposal batches, then its n_sub - 1 extension
    batches, row after row; with `cfg.hyp_axis`, replica after replica
    within a row, each from its own of the row's generators. Returns the
    `presampled` tuple (with the replica axis after the row axis)."""
    samp_idx, samp_mask = samp_idx.cpu(), samp_mask.cpu()  # one copy each

    def batches(gen, r, count):
        draws = [sample_minimal(gen, cfg.sampler_id, cfg.n_hypotheses,
                                family.sample_size, int(n_valid[r]), samp_idx[r],
                                samp_mask[r]) for _ in range(count)]
        if not draws:
            return (torch.zeros(0, cfg.n_hypotheses, family.sample_size, dtype=torch.long),
                    torch.zeros(0, cfg.n_hypotheses, dtype=torch.bool))
        return torch.stack([d[0] for d in draws]), torch.stack([d[1] for d in draws])

    def run(gen, r):
        return (*batches(gen, r, cfg.max_rounds), *batches(gen, r, n_sub - 1))

    def stack(runs, i):
        return torch.stack([one[i] for one in runs])

    if cfg.hyp_axis is None:
        runs = [run(g, r) for r, g in enumerate(generators)]
        return tuple(stack(runs, i) for i in range(4))
    runs = [[run(g, r) for g in gens] for r, gens in enumerate(generators)]
    return tuple(torch.stack([stack(reps, i) for reps in runs]) for i in range(4))


def _final_polish(family, cfg, params, data, pmask, pweights, descs, active, labels):
    """cfg.final_polish IRLS refit passes on the final instances of every
    row (progressivex_tpu/core/engine.py:670-724): each pass refits every
    instance on its labeled points with truncated-preference weights and
    keeps the refit where its truncated residual sum over those points
    drops (PEARL's acceptance rule). With cfg.polish_trim > 0 a pass first
    keeps only the members below the instance's (1 - trim) residual
    quantile, never fewer than the family's non-minimal size, and both
    the weights and the sums see only those. data [R, N, d], descs
    [R, K, D], active [R, K], labels [R, N] -> descs [R, K, D]."""
    trunc_sq = truncated_sq_threshold(params.threshold)  # [R]
    tau = per_row(trunc_sq, 3)
    cap = 2.25 * tau
    slot_ids = torch.arange(cfg.max_models, device=data.device)
    member = (labels[:, None, :] == slot_ids[:, None]) & pmask[:, None, :]  # [R, K, N]
    fit_w = member.to(data.dtype) * pweights[:, None, :]
    nk = member.sum(-1)

    def keep_mask(r2m):
        if cfg.polish_trim <= 0.0:
            return member
        srt = torch.sort(torch.where(member, r2m, torch.inf), dim=-1).values
        floor_n = max(int(family.nonminimal_min), 4)
        keep_n = torch.maximum(torch.ceil((1.0 - cfg.polish_trim) * nk).long(),
                               torch.clamp(nk, max=floor_n))
        idx = torch.clamp(keep_n - 1, 0, r2m.shape[-1] - 1)
        return member & (r2m <= srt.gather(-1, idx[..., None]))

    def trunc_sum(r2m, kmask):
        return row_sum(kmask * torch.sqrt(torch.minimum(r2m, cap)))

    for _ in range(cfg.final_polish):
        r2 = family.squared_residual(data, descs)
        kmask = keep_mask(r2)
        pref = torch.clamp(1.0 - r2 / tau, min=0.0)
        new_descs, ok = family.refit(data, fit_w * pref * kmask, descs)
        r2_new = family.squared_residual(data, new_descs)
        accept = ok & active & (trunc_sum(r2_new, kmask) < trunc_sum(r2, kmask))
        descs = torch.where(accept[..., None], new_descs, descs)
    return descs


def _polish_research(family, cfg, params, data, pmask, pweights, descs, active, labels):
    """Tight-threshold local minimal re-search on the final instances of
    every row (cfg.polish_research; progressivex_tpu/core/engine.py:727-821,
    where the reasons are): cfg.polish_research minimal samples from each
    instance's labeled points, placed by a fixed hash permutation of the
    point positions; the candidate with the most points within half the
    threshold over all valid points, three warm-started refits at that
    tight scale (a step kept if the tight count does not drop); the
    instance takes the candidate if it keeps at least half of its tight
    core and beats its tight count by 25%. data [R, N, d], descs
    [R, K, D], active [R, K], labels [R, N] -> descs [R, K, D]."""
    n_samples, m = cfg.polish_research, family.sample_size
    rows, n = data.shape[:2]
    k_slots, dim = cfg.max_models, family.desc_dim
    dev = data.device
    ar = torch.arange(rows, device=dev)
    tight = params.threshold * 0.5
    t2 = tight * tight  # [R]
    t2_k = t2[:, None, None]  # against [R, K, N]

    # Knuth multiplicative hashes of the positions, one odd multiplier a
    # sample: the JAX package's uint32 products, wrapped mod 2^32 here in
    # int64; each row of keys is a permutation, argsorted stably.
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    mult = torch.arange(n_samples, dtype=torch.int64, device=dev) * 2 + 2654435761
    keys = ((pos[None, :] + 1) * mult[:, None]) & 0xFFFFFFFF
    s_pos = torch.argsort(keys, dim=1, stable=True)[:, :m]  # [S, m]

    part = (labels[:, None, :] == torch.arange(k_slots, device=dev)[:, None]) \
        & pmask[:, None, :]  # [R, K, N]
    npart = part.sum(-1)
    order = torch.argsort(torch.where(part, 0, 1), dim=-1, stable=True)
    s_ix = s_pos % torch.clamp(npart, min=1)[..., None, None]  # [R, K, S, m]
    pick = order.gather(-1, s_ix.reshape(rows, k_slots, -1))
    samples = data[ar[:, None, None], pick].reshape(-1, m, data.shape[-1])
    dh, vh = family.minimal_solver_batched(samples)
    flat = dh.reshape(rows, k_slots, -1, dim)
    vf = vh.reshape(rows, k_slots, -1)

    def tight_count(r2v):
        """Valid points within the tight threshold, r2v [R, ..., N] -> [R, ...]."""
        lead = [1] * (r2v.ndim - 2)
        return ((r2v < t2.reshape(rows, *lead, 1)) & pmask.reshape(rows, *lead, n)).sum(-1)

    sup = tight_count(family.squared_residual(data, flat))  # [R, K, H]
    sup = torch.where(vf & torch.isfinite(flat).all(-1), sup, -1)
    best = sup.argmax(-1)
    cand = flat.gather(2, best[..., None, None].expand(-1, -1, 1, dim))[:, :, 0]
    cand_ok = sup.gather(-1, best[..., None])[..., 0] > 0
    wts = (pmask.to(data.dtype) * pweights)[:, None, :]

    def tight_global(d):
        return tight_count(family.squared_residual(data, d))

    for _ in range(3):
        pref = torch.clamp(1.0 - family.squared_residual(data, cand) / (2.25 * t2_k),
                           min=0.0)
        c2, ok2 = family.refit(data, pref * wts, cand)
        better = ok2 & torch.isfinite(c2).all(-1) & (tight_global(c2) >= tight_global(cand))
        cand = torch.where(better[..., None], c2, cand)
    core = (family.squared_residual(data, descs) < t2_k) & part
    anchored = ((core & (family.squared_residual(data, cand) < t2_k)).sum(-1).to(data.dtype)
                >= 0.5 * core.sum(-1).to(data.dtype))
    take = (active & cand_ok & anchored
            & (tight_global(cand).to(data.dtype) > 1.25 * tight_global(descs).to(data.dtype)))
    return torch.where(take[..., None], cand, descs)


def _total_energy(family, params, data, pmask, adj, descs, active, labels):
    """Labeling energy + label cost x live instances, per row (ranks
    restarts)."""
    trunc_sq = truncated_sq_threshold(params.threshold)
    dcost = data_costs(family.squared_residual(data, descs), active, pmask,
                       params.spatial_weight, trunc_sq)
    e = labeling_energy(dcost, labels, adj, params.spatial_weight)
    return e + float(params.min_inliers) * active.sum(-1)


def compact_result(result: FitResult, n_valid: int):
    """Renumber active slots to 0..K-1 in insertion order; outliers get K
    (the reference labeling convention). Returns numpy (descs, labels)."""
    active = result.active.cpu().numpy()
    descs = result.descs.cpu().numpy()[active]
    remap = np.full(active.shape[0] + 1, descs.shape[0], np.int64)
    remap[:active.shape[0]][active] = np.arange(descs.shape[0])
    labels = remap[result.labels.cpu().numpy()][:n_valid]
    return descs, labels.astype(np.int32)
