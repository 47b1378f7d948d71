"""Batched minimal-sample generation — counterpart of
progressivex_tpu/ops/sampling.py, on the JAX package's keys
(ops/prng.py), so that a key draws the JAX package's samples bit for
bit. Sampler ids follow the reference front ends: 0 = uniform, 1 =
PROSAC, 2 = Progressive NAPSAC, 3 = NAPSAC.

Padding rows are a suffix: valid rows are 0..n_valid-1, so a uniform
valid index is randint(0, n_valid). A sample with a repeated index is
marked invalid (`ok=False`), not redrawn. `n_valid` is a tensor on the
keys' device and nothing is read to the host, so a CUDA graph can
capture a draw. The Gumbel top-k is a stable descending selection (the
first index on ties, as lax.top_k), by repeated first-occurrence argmax:
torch.topk promises no order for ties.

Every sampler takes a batch of keys [G, T, 2] with one kNN table (and
one n_valid) a group g: [G, N, K] tables, [G] counts, the engine's rows
(T keys a row: its rounds, its replicas' rounds) or one table for all
(G = 1), as the JAX package vmaps `sample_minimal` over round keys.
`sample_minimal` takes any leading shape and returns (idx [..., B, m]
int64, ok [..., B] bool).
"""

from __future__ import annotations

import math

import torch

from progressivex_tpu_torch.ops import prng

_NEG = -1e30


def _distinct(idx):
    """[..., B] bool: no duplicate indices within a sample of idx [..., B, m]."""
    m = idx.shape[-1]
    eye = torch.eye(m, dtype=torch.bool, device=idx.device)
    dup = (idx[..., :, None] == idx[..., None, :]) & ~eye
    return ~dup.any(-1).any(-1)


def _top_k(g, k: int):
    """(values, indices) [..., k] of the k largest entries of g [..., K]
    in descending order, the first index on ties (lax.top_k's order);
    g is overwritten."""
    vals, picks = [], []
    for _ in range(k):
        a = g.argmax(-1, keepdim=True)
        vals.append(g.gather(-1, a))
        picks.append(a)
        g.scatter_(-1, a, float("-inf"))
    return torch.cat(vals, -1), torch.cat(picks, -1)


def _n_valid(n_valid):
    """[G] counts -> [G, 1, 1], to broadcast against [G, T, B]."""
    return n_valid[:, None, None]


def uniform_sample(keys, n_hyp: int, m: int, n_valid):
    """m uniform draws from the valid prefix [0, n_valid) per hypothesis.
    keys [G, T, 2], n_valid [G]."""
    hi = torch.clamp(n_valid, min=1)[:, None]
    idx = prng.randint(keys, (n_hyp, m), 0, hi)
    return idx, _distinct(idx) & (_n_valid(n_valid) >= m)


def prosac_sample(keys, n_hyp: int, m: int, n_valid):
    """Prefix growth: hypothesis b draws from the top-n(b) rows, n(b)
    ramping from m + 1 to n_valid across the batch. Rows must be sorted by
    quality, best first."""
    dev = keys.device
    b = torch.arange(n_hyp, dtype=torch.float32, device=dev)[:, None]
    frac = (b + 1.0) / n_hyp
    nv = n_valid.to(torch.float32)[:, None, None, None]  # [G, 1, 1, 1]
    prefix = torch.minimum(m + torch.ceil(frac * (nv - m)), nv)
    prefix = torch.clamp(prefix, min=1.0).to(torch.int64)  # [G, 1, B, 1]
    u = prng.uniform(keys, (n_hyp, m))
    idx = torch.floor(u * prefix.to(torch.float32)).to(torch.int64)
    idx = torch.minimum(idx, prefix - 1)
    return idx, _distinct(idx) & (_n_valid(n_valid) >= m)


def _centers(keys, n_hyp, n_valid):
    hi = torch.clamp(n_valid, min=1)[:, None]
    return prng.randint(keys, (n_hyp,), 0, hi)  # [G, T, B]


def _local(knn_idx, centers, pick):
    """[G, T, B, m]: each center, then its neighbors in the picked slots."""
    g = torch.arange(knn_idx.shape[0], device=knn_idx.device)[:, None, None, None]
    picked = knn_idx[g, centers[..., None], pick].to(torch.int64)
    return torch.cat([centers[..., None], picked], -1)


def napsac_sample(keys, n_hyp: int, m: int, n_valid, knn_idx, knn_mask):
    """A random center plus m-1 distinct valid kNN neighbors of it, chosen
    by a Gumbel top-k over the neighbor slots; hypotheses whose center has
    too few neighbors fall back to a uniform sample."""
    sub = prng.split(keys, 3)
    k_center, k_nbr, k_fallback = sub[..., 0, :], sub[..., 1, :], sub[..., 2, :]
    centers = _centers(k_center, n_hyp, n_valid)
    g_ix = torch.arange(knn_mask.shape[0], device=keys.device)[:, None, None]
    nbr_ok = knn_mask[g_ix, centers]  # [G, T, B, K]
    g = prng.gumbel(k_nbr, (n_hyp, knn_mask.shape[-1])) + torch.where(nbr_ok, 0.0, _NEG)
    vals, pick = _top_k(g, m - 1)
    idx = _local(knn_idx, centers, pick)
    ok = vals[..., -1] > _NEG / 2
    u_idx, u_ok = uniform_sample(k_fallback, n_hyp, m, n_valid)
    return torch.where(ok[..., None], idx, u_idx), ok | u_ok


def progressive_napsac_sample(keys, n_hyp: int, m: int, n_valid, knn_idx, knn_mask):
    """Progressive NAPSAC: hypothesis b draws its m-1 companions from the
    center's nearest k(b) neighbors, k(b) ramping from m-1 to the whole
    sampler neighborhood over the first 7/8 of the batch; the last eighth,
    and every local draw whose window holds too few valid neighbors, takes
    a global uniform sample."""
    dev = keys.device
    sub = prng.split(keys, 3)
    k_center, k_nbr, k_global = sub[..., 0, :], sub[..., 1, :], sub[..., 2, :]
    k_max = knn_idx.shape[-1]
    centers = _centers(k_center, n_hyp, n_valid)
    g_ix = torch.arange(knn_mask.shape[0], device=dev)[:, None, None]
    nbr_ok = knn_mask[g_ix, centers]  # [G, T, B, K]
    n_local = (n_hyp * 7) // 8
    b = torch.arange(n_hyp, dtype=torch.float32, device=dev)
    frac = torch.clamp(b / max(n_local - 1, 1), max=1.0)
    k_b = torch.ceil((m - 1) + frac * (k_max - (m - 1)))  # [B]
    in_window = torch.arange(k_max, device=dev)[None, :] < k_b[:, None]
    g = prng.gumbel(k_nbr, (n_hyp, k_max)) + torch.where(nbr_ok & in_window, 0.0, _NEG)
    vals, pick = _top_k(g, m - 1)
    l_idx = _local(knn_idx, centers, pick)
    l_ok = vals[..., -1] > _NEG / 2
    g_idx, g_ok = uniform_sample(k_global, n_hyp, m, n_valid)
    take_local = (torch.arange(n_hyp, device=dev) < n_local) & l_ok
    idx = torch.where(take_local[..., None], l_idx, g_idx)
    return idx, torch.where(take_local, l_ok, g_ok)


def sample_minimal(keys, sampler_id: int, n_hyp: int, m: int, n_valid, knn_idx,
                   knn_mask):
    """The JAX package's `sample_minimal` of every key. keys [*Lt, *Lk, 2];
    knn_idx, knn_mask [*Lt, N, K], the tables of each group of keys, and
    n_valid an int or a tensor that broadcasts to Lt (one count a table).
    Returns (idx [*Lt, *Lk, B, m] int64, ok [*Lt, *Lk, B] bool)."""
    keys = torch.as_tensor(keys)
    lead_t = tuple(knn_idx.shape[:-2])
    lead = tuple(keys.shape[:-1])
    if lead[:len(lead_t)] != lead_t:
        raise ValueError(f"keys of shape {tuple(keys.shape)} for tables "
                         f"{tuple(knn_idx.shape)}")
    n_groups = math.prod(lead_t)
    keys = keys.reshape(n_groups, -1, 2)
    knn_idx = knn_idx.reshape(n_groups, *knn_idx.shape[-2:])
    knn_mask = knn_mask.reshape(n_groups, *knn_mask.shape[-2:])
    n_valid = torch.as_tensor(n_valid, dtype=torch.int64, device=keys.device)
    n_valid = n_valid.expand(lead_t).reshape(n_groups)
    if sampler_id == 0:
        idx, ok = uniform_sample(keys, n_hyp, m, n_valid)
    elif sampler_id == 1:
        idx, ok = prosac_sample(keys, n_hyp, m, n_valid)
    elif sampler_id == 2:
        idx, ok = progressive_napsac_sample(keys, n_hyp, m, n_valid, knn_idx, knn_mask)
    elif sampler_id == 3:
        idx, ok = napsac_sample(keys, n_hyp, m, n_valid, knn_idx, knn_mask)
    else:
        raise ValueError(f"Unknown sampler id {sampler_id}")
    return idx.reshape(*lead, n_hyp, m), ok.reshape(*lead, n_hyp)
