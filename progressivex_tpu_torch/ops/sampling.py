"""Batched minimal-sample generation — counterpart of
progressivex_tpu/ops/sampling.py. Sampler ids follow the reference front
ends: 0 = uniform, 1 = PROSAC, 2 = Progressive NAPSAC, 3 = NAPSAC.

Samples are index tensors drawn from an explicit `torch.Generator`,
whose device decides where they are drawn. The engine draws on a CPU
generator, so that a fit on the card and a fit on the CPU with the same
seed see the same samples. Padding rows are a suffix: valid rows are
0..n_valid-1, so a uniform valid index is randint(0, n_valid). A sample
with a repeated index is marked invalid (`ok=False`), not redrawn.

All samplers return (idx [B, m] int64, ok [B] bool). torch's numbers
differ from jax.random's for the same seed; the tests hold the samplers
to their invariants, not to values.
"""

from __future__ import annotations

import torch

_NEG = -1e30


def _distinct(idx):
    """[B] bool: no duplicate indices within a row of idx [B, m]."""
    m = idx.shape[-1]
    eye = torch.eye(m, dtype=torch.bool, device=idx.device)
    dup = (idx[:, :, None] == idx[:, None, :]) & ~eye[None]
    return ~dup.any(-1).any(-1)


def _gumbel(gen, shape):
    """Standard Gumbel noise of the given shape."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    u = torch.clamp(u, min=torch.finfo(u.dtype).tiny)
    return -torch.log(-torch.log(u))


def uniform_sample(gen, n_hyp: int, m: int, n_valid: int):
    """m uniform draws from the valid prefix [0, n_valid) per hypothesis."""
    idx = torch.randint(0, max(int(n_valid), 1), (n_hyp, m), generator=gen,
                        device=gen.device)
    return idx, _distinct(idx) & (int(n_valid) >= m)


def napsac_sample(gen, n_hyp: int, m: int, n_valid: int, knn_idx, knn_mask):
    """A random center plus m-1 distinct valid kNN neighbors of it, chosen
    by a Gumbel top-k over the neighbor slots; hypotheses whose center has
    too few neighbors fall back to a uniform sample."""
    dev = gen.device
    knn_idx = knn_idx.to(dev).long()
    knn_mask = knn_mask.to(dev)
    centers = torch.randint(0, max(int(n_valid), 1), (n_hyp,), generator=gen,
                            device=dev)
    nbr_ok = knn_mask[centers]  # [B, K]
    g = _gumbel(gen, nbr_ok.shape) + torch.where(nbr_ok, 0.0, _NEG)
    vals, pick = torch.topk(g, m - 1, dim=1)
    picked = knn_idx[centers[:, None], pick]
    idx = torch.cat([centers[:, None], picked], dim=1)
    ok = vals[:, -1] > _NEG / 2
    u_idx, u_ok = uniform_sample(gen, n_hyp, m, n_valid)
    return torch.where(ok[:, None], idx, u_idx), ok | u_ok


def prosac_sample(gen, n_hyp: int, m: int, n_valid: int):
    """Prefix growth: hypothesis b draws from the top-n(b) rows, n(b)
    ramping from m + 1 to n_valid across the batch. Rows must be sorted by
    quality, best first."""
    dev = gen.device
    b = torch.arange(n_hyp, dtype=torch.float32, device=dev)[:, None]
    frac = (b + 1.0) / n_hyp
    nv = float(n_valid)
    prefix = torch.clamp(m + torch.ceil(frac * (nv - m)), max=nv)
    prefix = torch.clamp(prefix, min=1.0).long()  # [B, 1]
    u = torch.rand((n_hyp, m), generator=gen, device=dev)
    idx = torch.floor(u * prefix.to(torch.float32)).long()
    idx = torch.minimum(idx, prefix - 1)
    return idx, _distinct(idx) & (int(n_valid) >= m)


def progressive_napsac_sample(gen, n_hyp: int, m: int, n_valid: int, knn_idx,
                              knn_mask):
    """Progressive NAPSAC: hypothesis b draws its m-1 companions from the
    center's nearest k(b) neighbors, k(b) ramping from m-1 to the whole
    sampler neighborhood over the first 7/8 of the batch; the last eighth,
    and every local draw whose window holds too few valid neighbors, takes
    a global uniform sample."""
    dev = gen.device
    knn_idx = knn_idx.to(dev).long()
    knn_mask = knn_mask.to(dev)
    k_max = knn_idx.shape[1]
    centers = torch.randint(0, max(int(n_valid), 1), (n_hyp,), generator=gen,
                            device=dev)
    nbr_ok = knn_mask[centers]  # [B, K]
    n_local = (n_hyp * 7) // 8
    b = torch.arange(n_hyp, dtype=torch.float32, device=dev)
    frac = torch.clamp(b / max(n_local - 1, 1), max=1.0)
    k_b = torch.ceil((m - 1) + frac * (k_max - (m - 1)))  # [B]
    in_window = torch.arange(k_max, device=dev)[None, :] < k_b[:, None]
    g = _gumbel(gen, nbr_ok.shape) + torch.where(nbr_ok & in_window, 0.0, _NEG)
    vals, pick = torch.topk(g, m - 1, dim=1)
    # Slot-first: only the chosen (center, slot) pairs read the kNN table.
    picked = knn_idx.reshape(-1)[centers[:, None] * k_max + pick]
    l_idx = torch.cat([centers[:, None], picked], dim=1)
    l_ok = vals[:, -1] > _NEG / 2
    g_idx, g_ok = uniform_sample(gen, n_hyp, m, n_valid)
    take_local = (torch.arange(n_hyp, device=dev) < n_local) & l_ok
    idx = torch.where(take_local[:, None], l_idx, g_idx)
    return idx, torch.where(take_local, l_ok, g_ok)


def sample_minimal(gen, sampler_id: int, n_hyp: int, m: int, n_valid: int,
                   knn_idx, knn_mask):
    """Dispatch on the sampler id. Returns (idx [B, m], ok [B])."""
    if sampler_id == 0:
        return uniform_sample(gen, n_hyp, m, n_valid)
    if sampler_id == 1:
        return prosac_sample(gen, n_hyp, m, n_valid)
    if sampler_id == 2:
        return progressive_napsac_sample(gen, n_hyp, m, n_valid, knn_idx, knn_mask)
    if sampler_id == 3:
        return napsac_sample(gen, n_hyp, m, n_valid, knn_idx, knn_mask)
    raise ValueError(f"Unknown sampler id {sampler_id}")
