"""PEARL: labeling / per-instance refit / weak-instance rejection, plus the
final merge and split moves — counterpart of progressivex_tpu/core/pearl.py.

The JAX package runs each of these loops as predicated unrolled steps that
leave a converged carry unchanged; here a Python loop breaks at the same
point. All slots refit at once through the family's batched solvers.

`pearl_run` runs on the engine's row axis (one scene or restart a row),
holding each converged row. `merge_instances` and `split_instances` run
once after the round loop and hold candidate loops whose length depends on
the data; they take one row, and the engine calls them row by row. The
design notes behind each step (truncated-sum acceptance, the exact
group-move deletion test, the merged-and-relabeled energy test) are in the
JAX module and hold here unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from progressivex_tpu_torch.core.config import (EngineConfig, RuntimeParams, per_row,
                                                rows_params, truncated_sq_threshold)
from progressivex_tpu_torch.models.base import ModelFamily
from progressivex_tpu_torch.ops import labeling as labeling_ops
from progressivex_tpu_torch.ops.linalg import row_sum

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
            + label_cost * active.sum())


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


def merge_instances(family, cfg: EngineConfig, params: RuntimeParams, data,
                    point_mask, point_weights, descs, active, labels, adj,
                    n_rounds: int = 3):
    """Explicit pairwise instance-merge moves (see the JAX module), on one
    row (data [N, d]; the engine loops over the rows of a fit): per
    round, the 8 active pairs with the most boundary contact each refit one
    model on their union (warm and cold IRLS candidates); every candidate
    is scored by the full energy of its merged and relabeled state, and
    the best is applied if it lowers the current energy."""
    k_slots = cfg.max_models
    dev = data.device
    trunc_sq = truncated_sq_threshold(params.threshold)
    w = params.spatial_weight
    label_cost = float(params.min_inliers)
    cap = 2.25 * trunc_sq
    n_cand = min(8, (k_slots * (k_slots - 1)) // 2)
    pairs = [(i, j) for i in range(k_slots) for j in range(i + 1, k_slots)]
    all_pi = torch.tensor([p[0] for p in pairs], device=dev)
    all_pj = torch.tensor([p[1] for p in pairs], device=dev)
    label_ids = torch.arange(k_slots + 1, device=dev)

    for _ in range(n_rounds):
        r2 = family.squared_residual(data, descs)
        dcost = labeling_ops.data_costs(r2, active, point_mask, w, trunc_sq)
        own_oh = labels[None, :] == label_ids[:, None]
        chosen = torch.where(own_oh, dcost, 0.0).sum(0)
        same = labeling_ops.neighbor_label_counts(adj, labels, k_slots + 1)
        contact = own_oh.to(torch.float32) @ same.T  # [L, L] directed edges
        pair_score = torch.where(active[all_pi] & active[all_pj],
                                 contact[all_pi, all_pj] + contact[all_pj, all_pi],
                                 -1.0)
        cand = _top_k(pair_score, n_cand)
        pi, pj = all_pi[cand], all_pj[cand]

        # try_pair for all candidates at once: [P, N] union masks
        union = (((labels[None, :] == pi[:, None]) | (labels[None, :] == pj[:, None]))
                 & point_mask[None, :])
        unionf = union.to(data.dtype) * point_weights[None, :]

        def trunc_sum(r2v):
            return torch.where(union, torch.sqrt(torch.clamp(r2v, max=cap)), 0.0).sum(-1)

        def irls(nd, r2n):
            for _ in range(3):
                nd2, ok2 = family.refit(data, _pref(r2n, trunc_sq) * unionf, nd)
                r2n2 = family.squared_residual(data, nd2)
                better = ok2 & (trunc_sum(r2n2) < trunc_sum(r2n))
                nd = torch.where(better[:, None], nd2, nd)
                r2n = torch.where(better[:, None], r2n2, r2n)
            return nd, r2n

        pref_ij = torch.maximum(_pref(r2[pi], trunc_sq), _pref(r2[pj], trunc_sq))
        nd_w, ok_w = family.refit(data, pref_ij * unionf, descs[pi])
        nd_w, r2_w = irls(nd_w, family.squared_residual(data, nd_w))
        nd_c, ok_c = family.nonminimal_solver(data, unionf)
        nd_c, r2_c = irls(nd_c, family.squared_residual(data, nd_c))
        use_cold = ok_c & ((trunc_sum(r2_c) < trunc_sum(r2_w)) | ~ok_w)
        new_descs = torch.where(use_cold[:, None], nd_c, nd_w)
        r2n = torch.where(use_cold[:, None], r2_c, r2_w)
        ratio = r2n / trunc_sq
        c_new = torch.where(ratio > 1.0, 2.0 * (1.0 - w), (1.0 - w) * ratio)
        d_data = torch.where(union, c_new - chosen[None, :], 0.0).sum(-1)
        delta = d_data - label_cost - 2.0 * w * contact[pi, pj]
        feasible = (active[pi] & active[pj] & (ok_w | ok_c)
                    & torch.isfinite(delta)).tolist()

        # eval_pair: full energy of each feasible merged + relabeled state
        e_all, m_labels_all = [], []
        for c, ok in enumerate(feasible):
            if not ok:
                e_all.append(float("inf"))
                m_labels_all.append(None)
                continue
            i, j = pi[c], pj[c]
            m_descs = descs.clone()
            m_descs[i] = new_descs[c]
            m_active = active.clone()
            m_active[j] = False
            dcost_m = labeling_ops.data_costs(
                family.squared_residual(data, m_descs), m_active, point_mask,
                w, trunc_sq)
            m_labels, _ = labeling_ops.icm_sweeps(
                dcost_m, torch.where(labels == j, i, labels), adj, w, 2)
            e_all.append(float(_total_energy(dcost_m, m_labels, m_active, adj,
                                             w, label_cost)))
            m_labels_all.append(m_labels)
        best = min(range(len(e_all)), key=e_all.__getitem__)
        e_cur = float(_total_energy(dcost, labels, active, adj, w, label_cost))
        if not (e_all[best] < e_cur):
            break
        descs = descs.clone()
        descs[pi[best]] = new_descs[best]
        active = active.clone()
        active[pj[best]] = False
        labels = m_labels_all[best]
    labels = torch.where(labeling_ops.labels_active_mask(labels, active),
                         labels, k_slots)
    return descs, active, labels


def split_instances(family, cfg: EngineConfig, params: RuntimeParams, data,
                    point_mask, point_weights, descs, active, labels, adj,
                    n_rounds: int = 2):
    """Explicit instance-split moves, the dual of `merge_instances` (see
    the JAX module), on one row (data [N, d]; the engine loops over the
    rows of a fit): per round, every active instance splits its support
    by the sign of the projection on its principal axis, each half gets a
    model from a local minimal-sample search plus preference IRLS, the
    second half takes the first free slot, a 4-sweep ICM relabel
    re-equilibrates, and the best split is applied if it lowers the full
    energy (label costs included)."""
    k_slots = cfg.max_models
    trunc_sq = truncated_sq_threshold(params.threshold)
    w = params.spatial_weight
    label_cost = float(params.min_inliers)
    cap = 2.25 * trunc_sq
    min_half = max(family.nonminimal_min, 3)
    m = family.sample_size
    dev = data.device
    stride = torch.arange(_SPLIT_SAMPLES, device=dev)[:, None] * 7
    slot_j = torch.arange(m, device=dev)[None, :]

    def fit_half(part):
        npart = int(part.sum())
        order = torch.argsort(torch.where(part, 0, 1), stable=True)
        s_ix = (stride + (slot_j * npart) // m) % max(npart, 1)
        dh, vh = family.minimal_solver_batched(data[order[s_ix]])
        flat = dh.reshape(-1, family.desc_dim)
        support = (_pref(family.squared_residual(data, flat), trunc_sq)
                   * part[None, :]).sum(1)
        support = torch.where(vh.reshape(-1), support, -1.0)
        best_h = support.argmax()
        nd, ok = flat[best_h], bool(support[best_h] > 0.0)
        wts = part.to(data.dtype) * point_weights

        def tsum(r2v):
            return torch.where(part, torch.sqrt(torch.clamp(r2v, max=cap)), 0.0).sum()

        r2n = family.squared_residual(data, nd)
        for _ in range(3):
            nd2, ok2 = family.refit(data, _pref(r2n, trunc_sq) * wts, nd)
            r2n2 = family.squared_residual(data, nd2)
            if bool(ok2 & (tsum(r2n2) < tsum(r2n))):
                nd, r2n = nd2, r2n2
        return nd, ok

    for _ in range(n_rounds):
        dcost = labeling_ops.data_costs(family.squared_residual(data, descs),
                                        active, point_mask, w, trunc_sq)
        e_cur = float(_total_energy(dcost, labels, active, adj, w, label_cost))
        act = active.tolist()
        if all(act):
            break  # no free slot: no legal split
        free = act.index(False)
        best = (float("inf"), None)
        for i in range(k_slots):
            if not act[i]:
                continue
            sup = (labels == i) & point_mask
            wsup = sup.to(data.dtype)
            mu = (data * wsup[:, None]).sum(0) / torch.clamp(sup.sum(), min=1).to(data.dtype)
            xc = (data - mu) * wsup[:, None]
            cov = xc.T @ xc
            v = torch.ones(data.shape[1], dtype=data.dtype, device=dev)
            for _ in range(8):
                v = cov @ v
                v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)
            part2 = sup & (xc @ v > 0)
            part1 = sup & ~part2
            if int(part1.sum()) < min_half or int(part2.sum()) < min_half:
                continue
            nd1, ok1 = fit_half(part1)
            nd2, ok2 = fit_half(part2)
            if not (ok1 and ok2):
                continue
            m_descs = descs.clone()
            m_descs[i] = nd1
            m_descs[free] = nd2
            m_active = active.clone()
            m_active[free] = True
            dcost_m = labeling_ops.data_costs(
                family.squared_residual(data, m_descs), m_active, point_mask,
                w, trunc_sq)
            m_labels, _ = labeling_ops.icm_sweeps(
                dcost_m, torch.where(part2, free, labels), adj, w, 4)
            e = float(_total_energy(dcost_m, m_labels, m_active, adj, w, label_cost))
            if e < best[0]:
                best = (e, (m_descs, m_active, m_labels))
        if not best[0] < e_cur:
            break
        descs, active, labels = best[1]
    labels = torch.where(labeling_ops.labels_active_mask(labels, active),
                         labels, k_slots)
    return descs, active, labels
