"""Model-family plugin interface — counterpart of progressivex_tpu/models/base.py.

Unlike the JAX package, whose family functions take a single problem and
are batched by `jax.vmap`, every function here takes the batch as leading
dimensions:

  minimal_solver_batched(samples [B, m, d]) -> (descs [B, S, D], valid [B, S])
  nonminimal_solver(data [N, d], weights [..., N]) -> (desc [..., D], valid [...])
  squared_residual(data [N, d], descs [..., D])    -> [..., N]
  refine_solver(data, weights [..., N], init [..., D]) -> (desc, valid)  [optional]
  scorer(data, descs [B, D], compound_pref, point_mask, trunc_sq, exponent,
         has_compound, magsac_levels) -> (scores, inliers, dots, norms) [B]

The engine's row axis (scenes or restarts, `jax.vmap(engine.fit)` in the
JAX package) comes first: data [R, N, d] pairs with weights [R, ..., N],
descriptors [R, ..., D] and a scorer's [R, B, D], compound_pref and
point_mask [R, N], and trunc_sq and has_compound [R].

`scorer` is the family's proposal scoring pass: a hand-written kernel on
the card and its plain torch version on the CPU (kernels/). It computes
`ops/scoring.compound_penalized_scores` over `squared_residual`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class ModelFamily:
    name: str
    sample_size: int
    nonminimal_min: int
    max_solutions: int
    desc_dim: int
    minimal_solver_batched: Callable
    nonminimal_solver: Callable
    squared_residual: Callable
    scorer: Callable
    refine_solver: Callable | None = None

    def refit(self, data, weights, init_desc):
        """Warm-started non-minimal fit: refine_solver when the family has
        one, else the stateless nonminimal_solver."""
        if self.refine_solver is not None:
            return self.refine_solver(data, weights, init_desc)
        return self.nonminimal_solver(data, weights)


def row_view(t, data, batched, tail: int):
    """A per-row tensor t [(R,) *T] (T its `tail` trailing dimensions) seen
    as [(R,) 1, ..., 1, *T], to broadcast against `batched`, whose leading
    dimensions are the row axis of `data` (if data [R, N, d] has one)
    followed by the batch dimensions of the call."""
    lead = data.ndim - 2
    n_batch = batched.ndim - lead - 1
    return t.reshape(*t.shape[:lead], *([1] * n_batch), *t.shape[t.ndim - tail:])


def point_columns(data, descs):
    """The d coordinate columns of data [N, d] (or [R, N, d]) shaped to
    broadcast against descs [..., D, 1] (or [R, ..., D, 1]): [N] (or
    [R, 1, ..., 1, N])."""
    cols = data.unbind(-1)
    if data.ndim == 2:
        return cols
    shape = (data.shape[0], *([1] * (descs.ndim - 2)), data.shape[1])
    return tuple(c.reshape(shape) for c in cols)


_REGISTRY: dict = {}


def register_family(family: ModelFamily) -> ModelFamily:
    _REGISTRY[family.name] = family
    return family


def get_family(name: str) -> ModelFamily:
    return _REGISTRY[name]
