"""Neighborhood graphs — counterpart of progressivex_tpu/ops/knn.py
(`knn_graph`, `grid_graph`).

Dense [N, k] index table plus validity mask, from row-chunked pairwise
distance matmuls and a top-k. `knn_graph` masks edges beyond the ball
radius, self-edges and padding (the reference's FLANN ball graph,
degree-capped at k); `grid_graph` keeps the k nearest points of the same
grid cell (the reference's GridNeighborhoodGraph). A leading row axis
([R, N, D] points, [R, N] masks) gives one graph a row.
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


# The JAX package's cell-hash primes, one a coordinate.
_CELL_PRIMES = (73856093, 19349663, 83492791, 32452843, 87382121)


def cell_ids(points, cell_size):
    """Grid-cell ids [(R,) N] int32 of points [(R,) N, D]: the sum of each
    coordinate's cell index times a large prime, wrapped to int32 as the
    JAX package's int32 arithmetic wraps it. The products and the sum are
    taken in int64 (where torch sums int32, it promotes) and wrapped
    once at the end, which gives the same ids modulo 2^32."""
    cells = torch.floor(points / cell_size).to(torch.int32).to(torch.int64)
    primes = torch.tensor(_CELL_PRIMES[:points.shape[-1]], dtype=torch.int64,
                          device=points.device)
    total = (cells * primes).sum(-1)
    return (((total + 2**31) % 2**32) - 2**31).to(torch.int32)


def grid_graph(points, valid_mask, cell_size, k: int, chunk: int = 256):
    """points [(R,) N, D], valid_mask [(R,) N] bool -> (idx [(R,) N, k]
    int32, mask [(R,) N, k] bool): at most k neighbors a point, the
    nearest valid points of its own grid cell (cell width `cell_size` in
    every coordinate), self-edges masked. Ties of equal distance may come
    in another order than the JAX package's `lax.top_k`; the set of
    masked-in neighbors is the same."""
    n = points.shape[-2]
    cid = cell_ids(points, float(cell_size))
    sq = (points * points).sum(-1)
    cols = torch.arange(n, device=points.device)
    idx_c, d2_c = [], []
    for c0 in range(0, n, min(chunk, n)):
        rows = points[..., c0:c0 + chunk, :]
        d2 = (sq[..., c0:c0 + chunk, None] + sq[..., None, :]
              - 2.0 * (rows @ points.transpose(-1, -2)))
        d2 = torch.clamp(d2, min=0.0)
        self_edge = (c0 + torch.arange(rows.shape[-2], device=points.device))[:, None] == cols[None, :]
        same = cid[..., c0:c0 + chunk, None] == cid[..., None, :]
        bad = self_edge | ~valid_mask[..., None, :] | ~same
        d2 = torch.where(bad, _SENTINEL, d2)
        neg_d2, idx = torch.topk(-d2, k, dim=-1)
        idx_c.append(idx)
        d2_c.append(-neg_d2)
    idx = torch.cat(idx_c, -2).to(torch.int32)
    d2k = torch.cat(d2_c, -2)
    mask = (d2k < _SENTINEL) & valid_mask[..., None]
    return idx, mask
