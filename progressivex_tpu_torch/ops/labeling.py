"""Point-to-instance labeling by parallel ICM over the kNN graph —
counterpart of progressivex_tpu/ops/labeling.py.

Energy (reference PEARL.h:82-128):
  E = sum_i data(i, l_i) + w * sum_{(i,j) in E} [l_i != l_j]
with data costs (1 - w) for the outlier label, 2 (1 - w) for an assigned
point beyond tau_t, (1 - w) r^2 / tau_t^2 within it. Every [label, point]
tensor is [L, N]; label L - 1 is the outlier class.

The Potts histograms are adjacency products (A @ one_hot(labels)), dense
[N, N] for small scenes and block-banded over spatially sorted points for
large ones, exactly as in the JAX package, which drops the same
out-of-band edges. This port keeps the f32 adjacency of the JAX package's
CPU path; its int8 adjacency and 127-level `neighbor_mean` quantization
are TPU-only.

Rows: every function also takes a leading row axis (one graph and one
labeling a row: dense adjacency [R, N, N], BandedAdj blocks
[R, nb, 128, C] and degrees [R, N], costs [R, L, N], labels [R, N]), as the
JAX functions under `jax.vmap`. All rows of a fit share N, and so whether
the adjacency is banded. `icm_sweeps` stops when no row moved a point; a
row that has converged is held, so its result does not depend on the
others.

Candidates: labels (and costs) may carry more leading axes than the
adjacency has rows, [(R,) C..., N]: candidate labelings of each row's
scene (the merge and split moves relabel every candidate state at once).
They share their row's adjacency, which is never copied: the candidates
are folded into the columns of one adjacency product.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from progressivex_tpu_torch.core.config import per_row
from progressivex_tpu_torch.ops.linalg import row_sum

_INF = 1e18


class BandedAdj(NamedTuple):
    """Block-banded adjacency over spatially sorted points:
    blocks[b, r, c] = 1 iff point j = 128 b + c - W is a neighbor of point
    i = 128 b + r (c in [0, 128 + 2W))."""

    blocks: torch.Tensor  # [(R,) nb, 128, 128 + 2W] f32
    deg: torch.Tensor  # [(R,) N] f32 row degrees


def adj_one_row(adj):
    """A one-scene adjacency as a batch of one row."""
    if isinstance(adj, BandedAdj):
        return BandedAdj(blocks=adj.blocks[None], deg=adj.deg[None])
    return adj[None]


def data_costs(sq_residuals, active, point_mask, spatial_weight, trunc_sq):
    """Per-(label, point) data costs [(R,) K + 1, N] from sq_residuals
    [(R,) K, N]; trunc_sq is shared or [R]. Padded points cost 0 as
    outliers and INF elsewhere."""
    one_minus_w = 1.0 - spatial_weight
    ratio = sq_residuals / per_row(trunc_sq, sq_residuals.ndim)
    model_cost = torch.where(ratio > 1.0, 2.0 * one_minus_w, one_minus_w * ratio)
    model_cost = torch.where(active[..., None], model_cost, _INF)
    outlier = torch.full_like(model_cost[..., :1, :], float(one_minus_w))
    costs = torch.cat([model_cost, outlier], dim=-2)
    pad_col = torch.zeros_like(costs)
    pad_col[..., :-1, :] = _INF
    return torch.where(point_mask[..., None, :], costs, pad_col)


def adjacency_from_knn(knn_idx, knn_mask):
    """Dense directed adjacency A [(R,) N, N] f32: A[i, j] = 1 iff j is a
    valid kNN neighbor of i."""
    n = knn_idx.shape[-2]
    A = torch.zeros(*knn_idx.shape[:-1], n, dtype=torch.float32, device=knn_idx.device)
    return A.scatter_add_(-1, knn_idx.long(), knn_mask.to(torch.float32))


def adjacency_banded(knn_idx, knn_mask, half_width: int, block: int = 128):
    """BandedAdj from a kNN graph over spatially sorted points; edges
    outside the +-half_width window are dropped."""
    n = knn_idx.shape[-2]
    w = half_width
    ctx = block + 2 * w
    nb = -(-n // block)
    i = torch.arange(n, device=knn_idx.device)
    r = i % block
    c = knn_idx.long() - (i - r)[:, None] + w
    inband = (c >= 0) & (c < ctx) & knn_mask
    lead = knn_idx.shape[:-2]
    rows = torch.zeros(*lead, nb * block, ctx, dtype=torch.float32, device=knn_idx.device)
    rows[..., :n, :].scatter_add_(-1, torch.where(inband, c, 0), inband.to(torch.float32))
    deg = inband.sum(-1).to(torch.float32)
    return BandedAdj(blocks=rows.reshape(*lead, nb, block, ctx), deg=deg)


def _banded_matmul(adj: BandedAdj, Y):
    """Banded A @ Y for Y [(R,) N, L] -> [(R,) N, L]."""
    nb, block, ctx = adj.blocks.shape[-3:]
    w = (ctx - block) // 2
    n = Y.shape[-2]
    yp = torch.nn.functional.pad(Y, (0, 0, w, nb * block - n + w))
    slabs = yp.unfold(-2, ctx, block)  # [(R,) nb, L, ctx]
    out = adj.blocks @ slabs.transpose(-1, -2)  # [(R,) nb, block, L]
    return out.reshape(*out.shape[:-3], nb * block, -1)[..., :n, :]


def _adj_matmul(adj, Y):
    if isinstance(adj, BandedAdj):
        return _banded_matmul(adj, Y)
    return adj @ Y


def degrees(adj):
    """[(R,) N] f32 neighbor counts for either adjacency representation."""
    if isinstance(adj, BandedAdj):
        return adj.deg
    return adj.sum(-1)


def _adj_rows(adj) -> int:
    """How many leading row axes the adjacency has (0 or 1)."""
    if isinstance(adj, BandedAdj):
        return adj.blocks.ndim - 3
    return adj.ndim - 2


def _degrees_like(adj, labels):
    """degrees(adj) [(R,) N] shaped to broadcast against labels
    [(R,) C..., N]: [(R,) 1..., N]."""
    deg = degrees(adj)
    n_cand = labels.ndim - deg.ndim
    return deg.reshape(*deg.shape[:-1], *([1] * n_cand), deg.shape[-1])


def neighbor_label_counts(adj, labels, num_labels: int):
    """[(R,) C..., L, N]: how many of each point's neighbors carry each
    label, for labels [(R,) C..., N]. The candidate axes C ride in the
    columns of one product with the row's adjacency; the counts are whole
    numbers, exact in any summation order."""
    Y = torch.nn.functional.one_hot(labels.long(), num_labels).to(torch.float32)
    lead = _adj_rows(adj)
    rows, cand, n = Y.shape[:lead], Y.shape[lead:-2], Y.shape[-2]
    # [(R,) C..., N, L] -> [(R,) N, C... * L]
    Yc = Y.movedim(-2, lead).reshape(*rows, n, -1)
    out = _adj_matmul(adj, Yc).reshape(*rows, n, *cand, num_labels)
    return out.movedim(lead, -1)


def neighbor_mean(adj, values):
    """Mean of values over each point's neighbors, (A @ v) / deg. values
    [(R,) N] -> [(R,) N], or [(R,) T, N] -> [(R,) T, N] for T vectors at
    once (the row axis is the adjacency's). The product is taken as
    elementwise products and a `row_sum` over each adjacency row, not by
    a matrix product, whose float32 sums would depend on the batch size."""
    deg = torch.clamp(degrees(adj), min=1.0)  # [(R,) N]
    lead = deg.shape[:-1]
    v = values.to(torch.float32).reshape(*lead, -1, values.shape[-1])  # [(R,) T, N]
    if isinstance(adj, BandedAdj):
        nb, block, ctx = adj.blocks.shape[-3:]
        w = (ctx - block) // 2
        n = v.shape[-1]
        vp = torch.nn.functional.pad(v, (w, nb * block - n + w))
        slabs = vp.unfold(-1, ctx, block)  # [(R,) T, nb, ctx]
        s = row_sum(adj.blocks[..., None, :, :, :] * slabs[..., :, :, None, :])
        s = s.reshape(*s.shape[:-2], nb * block)[..., :n]  # [(R,) T, N]
    else:
        s = row_sum(adj[..., None, :, :] * v[..., :, None, :])  # [(R,) T, N]
    return (s / deg[..., None, :]).reshape(values.shape)


def labels_active_mask(labels, active):
    """[(R,) N] bool: does each point's label name an active slot or the
    outlier class (label K = active.shape[-1])?"""
    act_ext = torch.cat([active, torch.ones_like(active[..., :1])], -1)
    return act_ext.gather(-1, labels.long())


def _local_costs(dcost, labels, adj, deg, spatial_weight):
    """dcost + Potts term against the current neighbor labels. [(R,) C..., L, N]."""
    same = neighbor_label_counts(adj, labels, dcost.shape[-2])
    return dcost + spatial_weight * (deg[..., None, :] - same)


def icm_sweeps(dcost, labels, adj, spatial_weight, n_sweeps: int,
               early_exit: bool = True):
    """Up to n_sweeps checkerboard ICM sweeps (even, then odd index
    parity), stopping after the first sweep that moves no point (of any
    row; a row whose sweep moved nothing is held from then on). Returns
    (labels, energy). With `early_exit` false all n_sweeps run and no
    value is read to the host; a row that stopped is held all the same,
    so the result is the same."""
    n = dcost.shape[-1]
    parity = (torch.arange(n, device=dcost.device) % 2).to(torch.bool)
    deg = _degrees_like(adj, labels)

    def half_sweep(labels, move_mask):
        best = _local_costs(dcost, labels, adj, deg, spatial_weight).argmin(-2)
        return torch.where(move_mask, best.to(labels.dtype), labels)

    moving = torch.ones(labels.shape[:-1], dtype=torch.bool, device=labels.device)
    for _ in range(n_sweeps):
        new = half_sweep(half_sweep(labels, parity), ~parity)
        changed = (new != labels).any(-1)
        labels = torch.where(moving[..., None], new, labels)
        moving = moving & changed
        if early_exit and not bool(moving.any()):
            break
    return labels, labeling_energy(dcost, labels, adj, spatial_weight)


def labeling_energy(dcost, labels, adj, spatial_weight):
    """Total energy [(R,) C...] of a labeling: data costs plus w times the
    number of directed edges whose ends disagree."""
    lab = labels.long()[..., None, :]
    data = row_sum(dcost.gather(-2, lab)[..., 0, :])
    own = neighbor_label_counts(adj, labels, dcost.shape[-2]).gather(-2, lab)[..., 0, :]
    return data + spatial_weight * (_degrees_like(adj, labels) - own).sum(-1)
