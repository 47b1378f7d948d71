"""PEARL: labeling / per-instance refit / weak-instance rejection, plus the
final merge and split moves — counterpart of progressivex_tpu/core/pearl.py.

The JAX package runs each of these loops as predicated unrolled steps that
leave a converged carry unchanged; here a Python loop breaks at the same
point. All slots refit at once through the family's batched solvers.

`pearl_run` runs on the engine's row axis (one scene or restart a row),
holding each converged row. `merge_instances` and `split_instances` run
once after the round loop, on the row axis too, as the JAX package vmaps
them: every candidate of every row at once (merge's pairs [R, P], split's
slots [R, K]), their relabels against the row's own adjacency, and
predicated rounds, so that no value is read to the host and a row gives
the same bits alone and in a batch. The design notes behind each step
(truncated-sum acceptance, the exact group-move deletion test, the
merged-and-relabeled energy test) are in the JAX module and hold here
unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from progressivex_tpu_torch.core.config import (EngineConfig, RuntimeParams, per_row,
                                                rows_params, truncated_sq_threshold)
from progressivex_tpu_torch.models.base import ModelFamily
from progressivex_tpu_torch.ops import labeling as labeling_ops
from progressivex_tpu_torch.ops.linalg import gram, row_sum

_BIG_COST = 1e18
_SPLIT_SAMPLES = 32  # minimal samples per split half


class PearlResult(NamedTuple):
    descs: torch.Tensor  # [K, D]
    active: torch.Tensor  # [K] bool
    labels: torch.Tensor  # [N] int64 slot labels; K = outlier
    energy: torch.Tensor  # scalar labeling energy


def _top_k(x, k: int):
    """Indices of the k largest entries over the last axis, ties to the
    lower index (the order of lax.top_k)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _pref(r2, trunc_sq):
    return torch.clamp(1.0 - r2 / trunc_sq, min=0.0)


def _total_energy(dcost, labels, active, adj, w, label_cost):
    return (labeling_ops.labeling_energy(dcost, labels, adj, w)
            + label_cost * active.sum(-1))


def pearl_run(
    family: ModelFamily,
    cfg: EngineConfig,
    params: RuntimeParams,
    data,  # [R, N, d], or [N, d] for one scene
    point_mask,  # [(R,) N] bool
    point_weights,  # [(R,) N]
    descs,  # [(R,) K, D]
    active,  # [(R,) K] bool
    labels,  # [(R,) N] warm-start labels (slot space; K = outlier)
    adj,  # dense [(R,) N, N] or BandedAdj
) -> PearlResult:
    """PEARL over the rows at once; params.threshold is shared or [R].
    The loop runs while any row has not converged, and a row that has
    converged (PEARL.h:463-467) is held from then on, so that its result
    does not depend on the other rows."""
    if data.ndim == 2:  # one scene: a single row
        res = pearl_run(family, cfg, rows_params(params, 1, data.device),
                        data[None], point_mask[None],
                        point_weights[None], descs[None], active[None],
                        labels[None], labeling_ops.adj_one_row(adj))
        return PearlResult(*(t[0] for t in res))
    k_slots = cfg.max_models
    dev = data.device
    params = rows_params(params, data.shape[0], dev)
    trunc_sq = truncated_sq_threshold(params.threshold)  # [R]
    tau = per_row(trunc_sq, 3)  # against [R, K, N]
    w = params.spatial_weight
    cap = 2.25 * tau
    slot_ids = torch.arange(k_slots, device=dev)
    label_ids = torch.arange(k_slots + 1, device=dev)

    labels = torch.where(labeling_ops.labels_active_mask(labels, active),
                         labels, k_slots)
    r2 = family.squared_residual(data, descs)  # [R, K, N], kept current
    e_prev = torch.full(data.shape[:1], float("inf"), device=dev)
    energy = e_prev
    running = torch.ones(data.shape[:1], dtype=torch.bool, device=dev)
    for _ in range(cfg.pearl_iters):
        old = (descs, active, labels, energy, r2)
        active0, labels0 = active, labels

        # 1. labeling, started from the per-point data argmin
        with record_function("progx_labeling"):
            dcost = labeling_ops.data_costs(r2, active, point_mask, w, trunc_sq)
            labels, energy = labeling_ops.icm_sweeps(
                dcost, dcost.argmin(-2), adj, w, cfg.icm_sweeps)

        # 2. per-instance refit: two IRLS passes, truncated-sum acceptance
        member = (labels[:, None, :] == slot_ids[:, None]) & point_mask[:, None, :]  # [R, K, N]
        counts = member.sum(-1)
        fit_w = member.to(data.dtype) * point_weights[:, None, :]

        def trunc_sum(r2m):
            return row_sum(member * torch.sqrt(torch.minimum(r2m, cap)))

        with record_function("progx_refit"):
            new_descs, fit_ok = family.refit(data, fit_w * _pref(r2, tau), descs)
            r2_mid = family.squared_residual(data, new_descs)
        res_before = trunc_sum(r2)
        res_one = torch.where(fit_ok, trunc_sum(r2_mid), float("inf"))
        with record_function("progx_refit"):
            descs2, ok2 = family.refit(data, fit_w * _pref(r2_mid, tau), new_descs)
            r2_two = family.squared_residual(data, descs2)
        res_two = torch.where(fit_ok & ok2, trunc_sum(r2_two), float("inf"))
        use_two = res_two < res_one
        new_descs = torch.where(use_two[..., None], descs2, new_descs)
        r2_new = torch.where(use_two[..., None], r2_two, r2_mid)
        accept = (fit_ok & active & (counts >= family.nonminimal_min)
                  & (torch.minimum(res_one, res_two) < res_before))
        descs = torch.where(accept[..., None], new_descs, descs)
        r2 = torch.where(accept[..., None], r2_new, r2)

        # 3. label-cost elimination (exact group-move test on the weakest
        #    label by data margin) and weak-instance rejection
        dcost2 = labeling_ops.data_costs(r2, active, point_mask, w, trunc_sq)
        own_oh = labels[:, None, :] == label_ids[:, None]  # [R, L, N]
        chosen = torch.where(own_oh, dcost2, 0.0).sum(-2)
        excl = torch.where(own_oh, _BIG_COST, dcost2)
        alt, alt_label = excl.min(-2)
        point_gain = torch.where(point_mask, alt - chosen, 0.0)
        data_delta = row_sum(torch.where(own_oh[:, :k_slots], point_gain[:, None, :], 0.0))
        data_delta = torch.where(active, data_delta, float("inf"))
        weakest = data_delta.argmin(-1)  # [R]
        labels_wo = torch.where(labels == weakest[:, None], alt_label, labels)
        same_wo = labeling_ops.neighbor_label_counts(adj, labels_wo, k_slots + 1)
        own_wo = same_wo.gather(-2, labels_wo[:, None, :])[:, 0]
        same_now = labeling_ops.neighbor_label_counts(adj, labels, k_slots + 1)
        own_now = torch.where(own_oh, same_now, 0.0).sum(-2)
        potts_delta = w * (own_now.sum(-1) - own_wo.sum(-1))
        gain = (data_delta.gather(-1, weakest[:, None])[:, 0]
                + torch.clamp(potts_delta, max=0.0))
        do_delete = gain < float(params.min_inliers)
        active = active & ~(do_delete[:, None] & (slot_ids == weakest[:, None]))
        counts2 = ((labels[:, None, :] == slot_ids[:, None]) & point_mask[:, None, :]).sum(-1)
        active = active & (counts2 >= int(params.min_inliers))

        dcost3 = labeling_ops.data_costs(r2, active, point_mask, w, trunc_sq)
        labels = torch.where(labeling_ops.labels_active_mask(labels, active),
                             labels, dcost3.argmin(-2))

        # convergence (PEARL.h:463-467): nothing changed and |dE| small;
        # rows that converged before this iteration keep their state
        changed = (accept.any(-1) | (active != active0).any(-1)
                   | (labels != labels0).any(-1)
                   | ((energy - e_prev).abs() >= 1e-5 * (1.0 + energy.abs())))
        descs, active, labels, energy, r2 = (
            torch.where(per_row(running, new.ndim), new, prev)
            for new, prev in zip((descs, active, labels, energy, r2), old))
        e_prev = torch.where(running, energy, e_prev)
        running = running & changed
        if not bool(running.any()):
            break
    return PearlResult(descs, active, labels, energy)


def _one_row(move, family, cfg, params, data, point_mask, point_weights, descs,
             active, labels, adj, n_rounds):
    """`move` on one scene (data [N, d]) as a batch of one row."""
    out = move(family, cfg, rows_params(params, 1, data.device), data[None],
               point_mask[None], point_weights[None], descs[None], active[None],
               labels[None], labeling_ops.adj_one_row(adj), n_rounds=n_rounds)
    return tuple(t[0] for t in out)


def _hold(keep, new, old):
    """Per row: `new` where keep [R] is true, else `old`."""
    return tuple(torch.where(per_row(keep, n.ndim), n, o) for n, o in zip(new, old))


def _pick(t, best):
    """t [R, C, ...] at candidate best [R] of each row -> [R, ...]."""
    return t[torch.arange(t.shape[0], device=t.device), best]


def merge_instances(family, cfg: EngineConfig, params: RuntimeParams, data,
                    point_mask, point_weights, descs, active, labels, adj,
                    n_rounds: int = 3):
    """Explicit pairwise instance-merge moves (see the JAX module), on the
    row axis (data [R, N, d], point mask and weights [R, N], descs
    [R, K, D], active [R, K], labels [R, N], params.threshold shared or
    [R]; without the row axis, one scene). Per round, the 8 active pairs
    of each row with the most boundary contact each refit one model on
    their union (warm and cold IRLS candidates); every candidate of every
    row, [R, P], is scored by the full energy of its merged and relabeled
    state (infeasible ones computed too and set to inf), and each row
    applies its best if it lowers the row's energy. The rounds are
    predicated as the JAX package unrolls them: a row whose last round
    merged nothing passes through unchanged, and nothing is read to the
    host."""
    if data.ndim == 2:
        return _one_row(merge_instances, family, cfg, params, data, point_mask,
                        point_weights, descs, active, labels, adj, n_rounds)
    k_slots = cfg.max_models
    dev = data.device
    n_rows, n = data.shape[:2]
    params = rows_params(params, n_rows, dev)
    trunc_sq = truncated_sq_threshold(params.threshold)  # [R]
    tau = per_row(trunc_sq, 3)  # against [R, P, N]
    cap = 2.25 * tau
    w = params.spatial_weight
    label_cost = float(params.min_inliers)
    n_cand = min(8, (k_slots * (k_slots - 1)) // 2)
    all_pi, all_pj = torch.triu_indices(k_slots, k_slots, 1, device=dev)  # i < j, row-major
    label_ids = torch.arange(k_slots + 1, device=dev)
    slot_ids = torch.arange(k_slots, device=dev)
    ar = torch.arange(n_rows, device=dev)[:, None]

    def total_energy(dcost, labels, active):
        return _total_energy(dcost, labels, active, adj, w, label_cost)

    def one_round(descs, active, labels):
        r2 = family.squared_residual(data, descs)  # [R, K, N]
        dcost = labeling_ops.data_costs(r2, active, point_mask, w, trunc_sq)
        own_oh = labels[:, None, :] == label_ids[:, None]  # [R, L, N]
        chosen = torch.where(own_oh, dcost, 0.0).sum(-2)  # one term a point
        same = labeling_ops.neighbor_label_counts(adj, labels, k_slots + 1)
        contact = own_oh.to(torch.float32) @ same.transpose(-1, -2)  # [R, L, L]
        both_all = active[:, all_pi] & active[:, all_pj]
        pair_score = torch.where(both_all, contact[:, all_pi, all_pj]
                                 + contact[:, all_pj, all_pi], -1.0)
        cand = _top_k(pair_score, n_cand)  # [R, P]
        pi, pj = all_pi[cand], all_pj[cand]

        # try_pair for every candidate of every row: [R, P, N] unions
        union = (((labels[:, None, :] == pi[..., None])
                  | (labels[:, None, :] == pj[..., None])) & point_mask[:, None, :])
        unionf = union.to(data.dtype) * point_weights[:, None, :]

        def trunc_sum(r2v):
            return row_sum(torch.where(union, torch.sqrt(torch.minimum(r2v, cap)), 0.0))

        def irls(nd, r2n):
            for _ in range(3):
                nd2, ok2 = family.refit(data, _pref(r2n, tau) * unionf, nd)
                r2n2 = family.squared_residual(data, nd2)
                better = ok2 & (trunc_sum(r2n2) < trunc_sum(r2n))
                nd = torch.where(better[..., None], nd2, nd)
                r2n = torch.where(better[..., None], r2n2, r2n)
            return nd, r2n

        pref_ij = torch.maximum(_pref(r2[ar, pi], tau), _pref(r2[ar, pj], tau))
        nd_w, ok_w = family.refit(data, pref_ij * unionf, descs[ar, pi])
        nd_w, r2_w = irls(nd_w, family.squared_residual(data, nd_w))
        nd_c, ok_c = family.nonminimal_solver(data, unionf)
        nd_c, r2_c = irls(nd_c, family.squared_residual(data, nd_c))
        use_cold = ok_c & ((trunc_sum(r2_c) < trunc_sum(r2_w)) | ~ok_w)
        new_descs = torch.where(use_cold[..., None], nd_c, nd_w)  # [R, P, D]
        r2n = torch.where(use_cold[..., None], r2_c, r2_w)  # [R, P, N]
        ratio = r2n / tau
        c_new = torch.where(ratio > 1.0, 2.0 * (1.0 - w), (1.0 - w) * ratio)
        d_data = row_sum(torch.where(union, c_new - chosen[:, None, :], 0.0))
        delta = d_data - label_cost - 2.0 * w * contact[ar, pi, pj]
        feasible = (active[ar, pi] & active[ar, pj] & (ok_w | ok_c)
                    & torch.isfinite(delta))

        # eval_pair for every candidate: the full energy of its merged and
        # relabeled state, [R, P, K] states relabeled against the row's
        # adjacency. Slot i's residuals are the merged model's, r2n.
        is_i = (slot_ids == pi[..., None])[..., None]  # [R, P, K, 1]
        m_descs = torch.where(is_i, new_descs[:, :, None, :], descs[:, None])
        m_active = active[:, None, :] & (slot_ids != pj[..., None])
        r2_m = torch.where(is_i, r2n[:, :, None, :], r2[:, None])  # [R, P, K, N]
        dcost_m = labeling_ops.data_costs(r2_m, m_active, point_mask[:, None],
                                          w, trunc_sq)
        m_labels = torch.where(labels[:, None, :] == pj[..., None], pi[..., None],
                               labels[:, None, :])
        m_labels, _ = labeling_ops.icm_sweeps(dcost_m, m_labels, adj, w, 2,
                                              early_exit=False)
        e_all = torch.where(feasible, total_energy(dcost_m, m_labels, m_active),
                            float("inf"))
        best = e_all.argmin(-1)  # [R]
        e_best = _pick(e_all, best)
        do = (e_best < total_energy(dcost, labels, active)) & torch.isfinite(e_best)
        moved = (_pick(m_descs, best), _pick(m_active, best), _pick(m_labels, best))
        return _hold(do, moved, (descs, active, labels)), do

    going = torch.ones(n_rows, dtype=torch.bool, device=dev)
    for _ in range(n_rounds):
        new, do = one_round(descs, active, labels)
        descs, active, labels = _hold(going, new, (descs, active, labels))
        going = going & do
    labels = torch.where(labeling_ops.labels_active_mask(labels, active),
                         labels, k_slots)
    return descs, active, labels


def split_instances(family, cfg: EngineConfig, params: RuntimeParams, data,
                    point_mask, point_weights, descs, active, labels, adj,
                    n_rounds: int = 2):
    """Explicit instance-split moves, the dual of `merge_instances` (see
    the JAX module), on the row axis (shapes as `merge_instances`). Per
    round, every slot of every row, [R, K], splits its support by the
    sign of the projection on its principal axis; each half gets a model
    from a local minimal-sample search plus preference IRLS, the second
    half takes the row's first free slot, a 4-sweep ICM relabel
    re-equilibrates, and each row applies its best split if it lowers the
    full energy (label costs included). Infeasible splits (an inactive
    slot, no free slot, a half too small or without a model) are computed
    too and set to inf. Rounds are predicated as in `merge_instances`;
    nothing is read to the host."""
    if data.ndim == 2:
        return _one_row(split_instances, family, cfg, params, data, point_mask,
                        point_weights, descs, active, labels, adj, n_rounds)
    k_slots = cfg.max_models
    dev = data.device
    n_rows, n, d = data.shape
    dim = family.desc_dim
    params = rows_params(params, n_rows, dev)
    trunc_sq = truncated_sq_threshold(params.threshold)  # [R]
    tau = per_row(trunc_sq, 3)  # against [R, H, N]
    cap = 2.25 * tau
    w = params.spatial_weight
    label_cost = float(params.min_inliers)
    min_half = max(family.nonminimal_min, 3)
    m = family.sample_size
    stride = torch.arange(_SPLIT_SAMPLES, device=dev)[:, None] * 7  # [S, 1]
    slot_j = torch.arange(m, device=dev)[None, :]  # [1, m]
    slot_ids = torch.arange(k_slots, device=dev)
    ar = torch.arange(n_rows, device=dev)

    def fit_half(part):
        """Models of the halves part [R, H, N]: the best of the minimal
        samples at strides over each half's points, polished by three
        preference-IRLS steps. Returns descs [R, H, D], ok [R, H] and
        their residuals [R, H, N]."""
        halves = part.shape[1]
        npart = part.sum(-1)[..., None, None]  # [R, H, 1, 1]
        order = torch.argsort(torch.where(part, 0, 1), dim=-1, stable=True)
        s_ix = (stride + (slot_j * npart) // m) % torch.clamp(npart, min=1)  # [R, H, S, m]
        pick = order.gather(-1, s_ix.reshape(n_rows, halves, -1))
        samples = data[ar[:, None, None], pick].reshape(-1, m, d)
        dh, vh = family.minimal_solver_batched(samples)
        flat = dh.reshape(n_rows, halves, -1, dim)  # [R, H, S * solutions, D]
        r2h = family.squared_residual(data, flat)  # [R, H, S * solutions, N]
        support = row_sum(_pref(r2h, per_row(trunc_sq, 4)) * part[:, :, None, :])
        support = torch.where(vh.reshape(n_rows, halves, -1), support, -1.0)
        best_h = support.argmax(-1)  # [R, H]
        nd = flat.gather(2, best_h[..., None, None].expand(-1, -1, 1, dim))[:, :, 0]
        ok = support.gather(-1, best_h[..., None])[..., 0] > 0.0
        wts = part.to(data.dtype) * point_weights[:, None, :]

        def tsum(r2v):
            return row_sum(torch.where(part, torch.sqrt(torch.minimum(r2v, cap)), 0.0))

        r2n = family.squared_residual(data, nd)
        for _ in range(3):
            nd2, ok2 = family.refit(data, _pref(r2n, tau) * wts, nd)
            r2n2 = family.squared_residual(data, nd2)
            better = ok2 & (tsum(r2n2) < tsum(r2n))
            nd = torch.where(better[..., None], nd2, nd)
            r2n = torch.where(better[..., None], r2n2, r2n)
        return nd, ok, r2n

    def one_round(descs, active, labels):
        r2 = family.squared_residual(data, descs)  # [R, K, N]
        dcost = labeling_ops.data_costs(r2, active, point_mask, w, trunc_sq)
        e_cur = _total_energy(dcost, labels, active, adj, w, label_cost)
        # The split-off half takes the first free slot; with none there is
        # no legal split.
        free = active.to(torch.uint8).argmin(-1)  # [R]
        has_free = ~active[ar, free]

        # try_split for every slot of every row: [R, K] candidates
        sup = (labels[:, None, :] == slot_ids[:, None]) & point_mask[:, None, :]
        wsup = sup.to(data.dtype)[..., None]  # [R, K, N, 1]
        n_sup = torch.clamp(sup.sum(-1), min=1).to(data.dtype)
        mu = row_sum(data[:, None] * wsup, -2) / n_sup[..., None]  # [R, K, d]
        xc = (data[:, None] - mu[:, :, None, :]) * wsup  # [R, K, N, d]
        cov = gram(xc, xc)  # [R, K, d, d]
        v = torch.ones(n_rows, k_slots, d, dtype=data.dtype, device=dev)
        for _ in range(8):  # power iteration, products summed over d
            v = (cov * v[..., None, :]).sum(-1)
            v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                                min=1e-12)
        part2 = sup & ((xc * v[:, :, None, :]).sum(-1) > 0)
        part1 = sup & ~part2
        nd_h, ok_h, r2_h = fit_half(torch.cat([part1, part2], 1))
        nd1, nd2 = nd_h[:, :k_slots], nd_h[:, k_slots:]
        r2_1, r2_2 = r2_h[:, :k_slots], r2_h[:, k_slots:]

        # [R, K, K] states: candidate i, slot k. Slot i takes the first
        # half, the free slot the second (the free slot wins where they
        # are the same, an infeasible candidate).
        is_i = (slot_ids[:, None] == slot_ids)[None, :, :, None]  # [1, K, K, 1]
        is_free = (slot_ids == free[:, None])[:, None, :, None]  # [R, 1, K, 1]
        m_descs = torch.where(is_free, nd2[:, :, None, :],
                              torch.where(is_i, nd1[:, :, None, :], descs[:, None]))
        r2_m = torch.where(is_free, r2_2[:, :, None, :],
                           torch.where(is_i, r2_1[:, :, None, :], r2[:, None]))
        m_active = (active[:, None, :] | is_free[..., 0]).expand(-1, k_slots, -1)
        dcost_m = labeling_ops.data_costs(r2_m, m_active, point_mask[:, None],
                                          w, trunc_sq)
        m_labels = torch.where(part2, free[:, None, None], labels[:, None, :])
        m_labels, _ = labeling_ops.icm_sweeps(dcost_m, m_labels, adj, w, 4,
                                              early_exit=False)
        e = _total_energy(dcost_m, m_labels, m_active, adj, w, label_cost)
        feasible = (active & has_free[:, None] & ok_h[:, :k_slots] & ok_h[:, k_slots:]
                    & (part1.sum(-1) >= min_half) & (part2.sum(-1) >= min_half))
        e_all = torch.where(feasible, e, float("inf"))
        best = e_all.argmin(-1)
        e_best = _pick(e_all, best)
        do = torch.isfinite(e_best) & (e_best < e_cur)
        moved = (_pick(m_descs, best), _pick(m_active, best), _pick(m_labels, best))
        return _hold(do, moved, (descs, active, labels)), do

    going = torch.ones(n_rows, dtype=torch.bool, device=dev)
    for _ in range(n_rounds):
        new, do = one_round(descs, active, labels)
        descs, active, labels = _hold(going, new, (descs, active, labels))
        going = going & do
    labels = torch.where(labeling_ops.labels_active_mask(labels, active),
                         labels, k_slots)
    return descs, active, labels
