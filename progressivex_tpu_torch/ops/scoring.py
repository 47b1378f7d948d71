"""Compound-penalized MSAC scoring — counterpart of progressivex_tpu/ops/scoring.py.

  per-point preference = max(0, 1 - r^2 / tau_t^2)
  model score          = sum(preference) - (sum min(pref, compound_pref))^e

(reference `scoring_function_with_compound_model.h:61-125`). This is the
plain torch form; on the card the homography, fundamental and PnP
families score through the fused kernels of kernels/scoring.py, which
compute the same function (PnP's plain version is `residual_scorer`), and
lines and vanishing points through `residual_scorer`.

Every function takes an optional leading row axis: sq_residuals [R, B, N]
with compound_pref and point_mask [R, N], and `truncated_sq_threshold`
and `has_compound` either shared scalars or [R] tensors (one per row), as
the JAX functions under `jax.vmap` over rows.
"""

from __future__ import annotations

import torch

from progressivex_tpu_torch.core.config import per_row
from progressivex_tpu_torch.ops.linalg import row_sum


def truncated_preference(sq_residuals, truncated_sq_threshold):
    """max(0, 1 - r^2/tau_t^2) (reference progx_model.h:70-87). Any shape;
    an [R] threshold applies per row of the first axis."""
    tau = per_row(truncated_sq_threshold, sq_residuals.ndim)
    return torch.clamp(1.0 - sq_residuals / tau, min=0.0)


def sigma_marginalized_preference(sq_residuals, truncated_sq_threshold,
                                  n_levels: int):
    """MAGSAC++-style preference marginalized over the noise ladder
    sigma_j = (j/m) sigma_max, j = 1..m:

        pref(r) = 1/m * sum_j max(0, 1 - r^2 / (j/m)^2 tau_t^2)
    """
    x = sq_residuals / per_row(truncated_sq_threshold, sq_residuals.ndim)
    m = float(n_levels)
    acc = torch.zeros_like(x)
    for j in range(1, n_levels + 1):
        acc = acc + torch.clamp(1.0 - x / ((j / m) ** 2), min=0.0)
    return acc / m


def compound_penalized_scores(
    sq_residuals,  # [B, N] or [R, B, N]
    compound_pref,  # [N] or [R, N]
    point_mask,  # [N] or [R, N] bool (False for padding)
    truncated_sq_threshold,  # scalar or [R]
    exponent,  # scalar
    has_compound,  # bool or [R] bool: any model in the compound instance yet?
    magsac_levels: int = 0,  # 0 = MSAC ranking; > 0 = sigma-marginalized
    fixed_order: bool = False,
):
    """Returns scores [.., B], inlier counts [.., B] int32, pref_dot [.., B]
    = <pref_b, compound_pref> and pref_sqnorm [.., B] = <pref_b, pref_b>.

    The overlap penalty and the Tanimoto moments use the hard-tau
    preference whatever the ranking; inliers count at the raw threshold
    tau^2 = tau_t^2 / 2.25 (see the JAX module for the reasons). With
    `fixed_order` the sums over the points go through `row_sum`, so that a
    row's scores are the same bits at any number of rows on the card too
    (the scorer of the families that reach no kernel)."""
    total = row_sum if fixed_order else (lambda x: x.sum(-1))
    pm = point_mask[..., None, :]
    tau = per_row(truncated_sq_threshold, sq_residuals.ndim)
    pref = torch.where(pm, truncated_preference(sq_residuals, tau), 0.0)
    if magsac_levels > 0:
        rank_pref = torch.where(pm, sigma_marginalized_preference(
            sq_residuals, tau, magsac_levels), 0.0)
    else:
        rank_pref = pref
    raw = total(rank_pref)
    shared = total(torch.minimum(pref, compound_pref[..., None, :]))
    penalized = raw - torch.clamp(shared, min=0.0) ** exponent
    if isinstance(has_compound, torch.Tensor):
        scores = torch.where(per_row(has_compound, raw.ndim), penalized, raw)
    else:  # a host bool picks on the host, with no copy to the device
        scores = penalized if has_compound else raw
    inliers = ((sq_residuals < tau / 2.25) & pm).sum(-1)
    # An elementwise product and a sum, not a matrix-vector product: a row's
    # sum then does not depend on how many rows there are (torch's CPU
    # product takes another path for one row than for several).
    pref_dot = total(pref * compound_pref[..., None, :])
    pref_sqnorm = total(pref * pref)
    return scores, inliers.to(torch.int32), pref_dot, pref_sqnorm


def residual_scorer(squared_residual):
    """The proposal scorer of a family that reaches no kernel in the JAX
    package (its engine scores them with `compound_penalized_scores` in
    XLA, progressivex_tpu/core/engine.py:189-195): the same function over
    `squared_residual`, in plain torch on every device, with its sums in a
    fixed order. It takes the arguments of `ModelFamily.scorer`."""
    def scorer(data, descs, compound_pref, point_mask, trunc_sq, exponent,
               has_compound, magsac_levels=0):
        return compound_penalized_scores(
            squared_residual(data, descs), compound_pref, point_mask, trunc_sq,
            exponent, has_compound, magsac_levels, fixed_order=True)
    return scorer


def tanimoto_similarity(pref, compound_pref):
    """Tanimoto similarity of preference vectors over the last axis
    (reference progressive_x.h:583-585); leading axes broadcast. Sums by
    `row_sum`, as the engine takes them on the row axis."""
    dot = row_sum(pref * compound_pref)
    denom = row_sum(pref * pref) + row_sum(compound_pref * compound_pref) - dot
    return torch.where(denom > 1e-12, dot / torch.clamp(denom, min=1e-12), 0.0)
