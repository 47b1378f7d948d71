"""The scoring kernels' least time on an H100: a frozen copy of
chip_smoke.py's `_score_bound` and peaks (its `RESIDUAL_OPS` are each
family module's own, families/*.py), and the count of the launches a
fit's scoring needs. `family` is a family's name, as a configuration and
the harness's traced calls give it.

Peaks (NVIDIA H100 SXM data sheet, at its 700 W limit): 67 TFLOP/s in
float32 outside the tensor cores and 3.35 TB/s of HBM. A run prints the
card's power limit beside them.
"""

from __future__ import annotations

from bench_port import families

PEAK_F32_FLOP_S = 67e12
PEAK_BYTES_S = 3.35e12


def score_bound_s(b, n_valid, n_pts, magsac_levels, family):
    """Least seconds of one scoring pass of b hypotheses over rows whose
    valid points are `n_valid` (one entry a row), padded to n_pts:
    operations over the f32 peak against bytes over the HBM rate, the
    larger. Operations per (hypothesis, valid point): the residual's (the
    family's RESIDUAL_OPS), x = r2 / tau_t^2 1, pref 2 (sub, max), five
    sums 9; with m MAGSAC levels, 4 m + 1 more. Only valid points count. Bytes a
    row: 21 per point, 36 per descriptor and 16 of outputs per
    hypothesis, and 5 of the row's threshold and compound flag."""
    residual = families.load(family).RESIDUAL_OPS
    flops_pair = residual + 12 + (4 * magsac_levels + 1 if magsac_levels else 0)
    flops = b * sum(n_valid) * flops_pair
    nbytes = len(n_valid) * (n_pts * 21 + b * (36 + 16) + 5)
    return max(flops / PEAK_F32_FLOP_S, nbytes / PEAK_BYTES_S)


def round_bound_s(work, family, n_valid, n_pts):
    """Least seconds of the scoring of one round of rows with `n_valid`
    valid points at pad n_pts: `subbatches` proposal passes of
    hypotheses x solutions, then `lo_steps` passes of `lo_candidates`
    (configs/*.json "work", from the protocol)."""
    m = work["magsac_levels"]
    proposal = score_bound_s(work["hypotheses"] * work["solutions"], n_valid, n_pts, m,
                             family)
    lo = score_bound_s(work["lo_candidates"], n_valid, n_pts, m, family)
    return work["subbatches"] * proposal + work["lo_steps"] * lo


def call_bound_s(work, family, groups, launches):
    """Least seconds of the scoring of one entry-point call: `groups` is
    [(n_pts, n_valid of each real row)], one a pad level, each one
    `fit_rows` call whose rounds all launch `subbatches + lo_steps`
    kernels; `launches` the kernel launches the call counted. When the
    launches fall short of every level running `rounds_max` rounds, the
    missing rounds are taken from the levels of the largest round first,
    so the count never exceeds what ran. None when the launches do not
    fit the groups."""
    per_round = work["subbatches"] + work["lo_steps"]
    if launches % per_round:
        return None
    rounds = launches // per_round
    costs = sorted((round_bound_s(work, family, n_valid, n_pts) for n_pts, n_valid in groups),
                   reverse=True)
    full = work["rounds_max"] * len(costs)
    if not len(costs) <= rounds <= full:
        return None
    missing = full - rounds
    total = 0.0
    for cost in costs:
        cut = min(missing, work["rounds_max"] - 1)
        missing -= cut
        total += cost * (work["rounds_max"] - cut)
    return total
