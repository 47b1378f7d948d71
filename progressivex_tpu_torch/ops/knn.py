"""Radius-gated k-nearest-neighbor graph — counterpart of
progressivex_tpu/ops/knn.py::knn_graph.

Dense [N, k] index table plus validity mask, from row-chunked pairwise
distance matmuls and a top-k; edges beyond the ball radius, self-edges and
padding are masked (the reference's FLANN ball graph, degree-capped at k).
A leading row axis ([R, N, D] points, [R, N] masks) gives one graph a row.
"""

from __future__ import annotations

import torch

_SENTINEL = 3.4e38  # larger than any radius^2: the radius gate rejects it


def knn_graph(points, valid_mask, radius, k: int, chunk: int = 256):
    """points [(R,) N, D], valid_mask [(R,) N] bool -> (idx [(R,) N, k]
    int32, mask [(R,) N, k] bool). The JAX package's `lax.approx_max_k` is
    an exact top-k on its CPU backend, which `torch.topk` matches up to
    ties."""
    n = points.shape[-2]
    sq = (points * points).sum(-1)
    cols = torch.arange(n, device=points.device)
    idx_c, d2_c = [], []
    for c0 in range(0, n, min(chunk, n)):
        rows = points[..., c0:c0 + chunk, :]
        d2 = (sq[..., c0:c0 + chunk, None] + sq[..., None, :]
              - 2.0 * (rows @ points.transpose(-1, -2)))
        d2 = torch.clamp(d2, min=0.0)
        self_edge = (c0 + torch.arange(rows.shape[-2], device=points.device))[:, None] == cols[None, :]
        d2 = torch.where(self_edge | ~valid_mask[..., None, :], _SENTINEL, d2)
        neg_d2, idx = torch.topk(-d2, k, dim=-1)
        idx_c.append(idx)
        d2_c.append(-neg_d2)
    idx = torch.cat(idx_c, -2).to(torch.int32)
    d2k = torch.cat(d2_c, -2)
    mask = (d2k <= float(radius) * float(radius)) & valid_mask[..., None]
    return idx, mask
