"""Where, round by round, the port's fit leaves the JAX package's when both
run on the JAX replicas' own samples.

  python3 tools/hyp_lockstep.py [--scene unihouse] [--hyp 1,2,4] [--seeds 0,8]
                                [--port-device cuda|cpu] [--jax-platform cpu]
                                [--out FILE]

For each (hyp size H, seed) the JAX package runs the fit of `--scene` under
its AdelaideRMF protocol's engine (the hyp axis as tools/hyp_spread.py
emulates it: replica h draws with fold_in(PRNGKey(seed), h)) one round at a
time, on its default device. At the start of every round the port is handed
the JAX state and runs each stage of the round on the same inputs, on
`--port-device` (the scoring kernel on a card, its plain version on the
CPU). Both sides run their engine's own code:

  pre_lo  each replica's proposal without LO (lo_steps 0): scoring, the
          admissible top-T and the winner;
  lo      the same with LO; where it parts, `refit` refits each replica's
          pre-LO winner on LO's weights in both packages and in float64;
  pearl   pearl_run on the round's PEARL inputs; where it parts, `refit`
          refits every active slot on PEARL's first weights (the first
          labeling's members times their truncated preference);
  round   validation, PEARL and the update given the JAX package's winner.

`refit` gives the descriptor gap, each package's gap to the float64 result
of the same algorithm, and the two smallest eigenvalues of the row's
conditioned normal matrix over its largest. Then both go on from the JAX
package's next state. Prints one JSON line a (H, seed) with the port's kNN
graph against the JAX package's and the first (round, stage) whose outputs
differ; `--out` writes every round's stages. `--jax-platform cpu` runs the
JAX side on the CPU.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

DESC_TOL = 1e-3  # unit-scaled descriptors, tests/test_torch_engine.py's atol
SCORE_RTOL = 1e-4


def _unit(d):
    d = np.asarray(d, np.float64)
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-300)
    sign = np.sign(np.take_along_axis(d, np.abs(d).argmax(-1)[..., None], -1))
    return d * np.where(sign == 0, 1.0, sign)


def _desc_gap(a, b):
    ok = np.isfinite(a).all(-1) & np.isfinite(b).all(-1)
    return np.where(ok, np.abs(_unit(a) - _unit(b)).max(-1), 0.0)


class _Jax:
    """The JAX package's fit pieces for one scene and hyp size, compiled
    once; `start(seed)` draws a seed's samples and resets the state."""

    def __init__(self, name, hyp):
        import jax
        import jax.numpy as jnp

        from hyp_spread import _jax_setup, _jax_sorted
        from progressivex_tpu.core import engine as jengine
        from progressivex_tpu.core import pearl as jpearl
        from progressivex_tpu.core.config import truncated_sq_threshold
        from progressivex_tpu.ops import labeling as jlab
        from progressivex_tpu.ops.knn import knn_graph
        from progressivex_tpu.ops.sampling import sample_minimal
        from progressivex_tpu.ops.scoring import (sigma_marginalized_preference,
                                                  truncated_preference)

        family, cfg, params, data, mask, _, _ = _jax_setup(name, hyp)
        if max(int(cfg.n_subbatches), 1) != 1:
            raise SystemExit("hyp_lockstep.py replays one sub-batch a round")
        self.family, self.cfg, self.params, self.hyp = family, cfg, params, hyp
        self.use_band = cfg.potts_band > 0 and len(mask) > 128 + 2 * cfg.potts_band
        d, m, _ = _jax_sorted(data, mask, self.use_band)
        self.data, self.mask = np.asarray(d), np.asarray(m)
        w = jnp.ones(len(mask), jnp.float32)
        samp_idx, samp_mask = knn_graph(d, m, params.neighborhood_radius,
                                        max(cfg.knn_k, cfg.sampler_k))
        self.samp_idx, self.samp_mask = np.asarray(samp_idx), np.asarray(samp_mask)
        knn_idx, knn_mask = samp_idx[:, :cfg.knn_k], samp_mask[:, :cfg.knn_k]
        adj = (jlab.adjacency_banded(knn_idx, knn_mask, cfg.potts_band) if self.use_band
               else jlab.adjacency_from_knn(knn_idx, knn_mask))
        b, ms = cfg.n_hypotheses, family.sample_size
        ie, oe = jnp.zeros((0, b, ms), jnp.int32), jnp.zeros((0, b), bool)
        trunc_sq = truncated_sq_threshold(params.threshold)
        self.trunc_sq = float(trunc_sq)

        def draw(key):
            return jax.vmap(lambda k: sample_minimal(
                k, cfg.sampler_id, b, ms, m, params.n_valid, samp_idx, samp_mask))(
                jax.random.split(key, cfg.max_rounds))

        self.draw = jax.jit(draw)
        self.new_state = lambda key: jengine.FitState(
            key=key, descs=jnp.zeros((cfg.max_models, family.desc_dim), jnp.float32),
            active=jnp.zeros((cfg.max_models,), bool),
            labels=jnp.full((len(mask),), cfg.max_models, jnp.int32),
            compound_pref=jnp.zeros((len(mask),), jnp.float32),
            n_slots_used=jnp.int32(0), total_iters=jnp.int32(0),
            rejections=jnp.int32(0), energy=jnp.full((), jnp.nan, jnp.float32),
            done=jnp.zeros((), bool))
        cfg1 = dataclasses.replace(cfg, hyp_axis=None)
        cfg0 = dataclasses.replace(cfg1, lo_steps=0)

        def proposals(idx_h, ok_h, pref, has_c):
            def run(c):
                return jax.vmap(lambda i, o: jengine._proposal(
                    family, c, params, d, m, w, i, o, ie, oe, adj, pref, has_c)[:2])(
                    idx_h, ok_h)
            return run(cfg0), run(cfg1)

        def round_(state, idx_h, ok_h):
            out = jax.vmap(lambda i, o: jengine._round(
                family, cfg, params, d, m, w, i, o, ie, oe, adj, state),
                axis_name=cfg.hyp_axis)(idx_h, ok_h)
            return jax.tree.map(lambda x: x[0], out)

        def pearl(descs, active, labels):
            return jpearl.pearl_run(family, cfg, params, d, m, w, descs, active, labels, adj)

        def lo_weights(descs):
            """LO's refit weights of each descriptor (engine._proposal's
            lo_weight and spatial_weights)."""
            r2 = jax.vmap(family.squared_residual, (None, 0))(d, descs)
            pref = (sigma_marginalized_preference(r2, trunc_sq, cfg.magsac_levels)
                    if cfg.magsac_levels > 0 else truncated_preference(r2, trunc_sq))
            lam = cfg.lo_spatial_lambda
            if lam != 0.0:
                pref = jnp.clip((1.0 - lam) * pref + lam * jax.vmap(
                    lambda p: jlab.neighbor_mean(adj, p))(pref), 0.0, 1.0)
            return pref * w * m

        def pearl_weights(descs, active):
            """PEARL's first refit weights: the members of each slot in the
            first labeling (data argmin, ICM sweeps) times their truncated
            preference."""
            r2 = jax.vmap(family.squared_residual, (None, 0))(d, descs)
            dcost = jlab.data_costs(r2, active, m, params.spatial_weight, trunc_sq)
            labels, _ = jlab.icm_sweeps(dcost, jnp.argmin(dcost, 0), adj,
                                        params.spatial_weight, cfg.icm_sweeps)
            member = (labels[None, :] == jnp.arange(cfg.max_models)[:, None]) & m[None, :]
            return member * jnp.maximum(0.0, 1.0 - r2 / trunc_sq)

        def refit(weights, descs):
            return jax.vmap(family.refit, (None, 0, 0))(d, weights, descs)

        self.jnp = jnp
        self.proposals, self.round, self.pearl = (jax.jit(proposals), jax.jit(round_),
                                                  jax.jit(pearl))
        self.lo_weights, self.pearl_weights = jax.jit(lo_weights), jax.jit(pearl_weights)
        self.refit = jax.jit(refit)

    def start(self, seed):
        """Replica h of `seed` draws with fold_in(PRNGKey(seed), h)."""
        import jax

        key = jax.random.PRNGKey(seed)
        draws = [self.draw(jax.random.fold_in(key, h)) for h in range(self.hyp)]
        self.idx = np.stack([np.asarray(i) for i, _ in draws], 1)  # [rounds, H, B, m]
        self.ok = np.stack([np.asarray(o) for _, o in draws], 1)
        self.state = self.new_state(key)


def _graph_check(jx, idx, mask):
    """The port's kNN graph against the JAX package's: the rows whose
    neighbour sets differ and, over them, the largest ratio of the farthest
    to the nearest float64 distance among the neighbours only one package
    keeps (1 when the two break a tie at the k-th neighbour apart)."""
    p = jx.data.astype(np.float64)
    rows, ratio = 0, 1.0
    for i in range(len(idx)):
        a = set(idx[i][mask[i]].tolist())
        b = set(jx.samp_idx[i][jx.samp_mask[i]].tolist())
        if a != b:
            rows += 1
            dist = [float(np.linalg.norm(p[j] - p[i])) for j in a ^ b]
            ratio = max(ratio, max(dist) / max(min(dist), 1e-300))
    return {"rows_differ": rows, "rows": len(idx), "max_far_over_near": ratio}


class _Port:
    """The port's stages on the JAX package's sorted scene and kNN graph."""

    def __init__(self, jx, device):
        import torch

        from progressivex_tpu_torch import convert
        from progressivex_tpu_torch.core import engine
        from progressivex_tpu_torch.core.config import rows_params
        from progressivex_tpu_torch.models import get_family
        from progressivex_tpu_torch.ops.knn import knn_graph
        from progressivex_tpu_torch.ops.labeling import adjacency_banded, adjacency_from_knn

        self.torch, self.engine, self.dev = torch, engine, torch.device(device)
        self.family = get_family(jx.family.name)
        self.cfg = convert.engine_config(dataclasses.asdict(jx.cfg))
        params = convert.runtime_params(jx.params._asdict())
        self.hyp = jx.hyp
        self.params1 = rows_params(params, 1, self.dev)
        self.paramsh = rows_params(params, self.hyp, self.dev)
        self.data = self.t(jx.data)[None]
        self.mask = self.t(jx.mask)[None]
        self.w = torch.ones_like(self.data[..., 0])
        samp_idx, samp_mask = knn_graph(self.data, self.mask, self.params1.neighborhood_radius,
                                        max(self.cfg.knn_k, self.cfg.sampler_k))
        self.graph = _graph_check(jx, samp_idx[0].cpu().numpy(), samp_mask[0].cpu().numpy())
        k = self.cfg.knn_k
        samp_idx, samp_mask = self.t(jx.samp_idx, torch.long)[None], self.t(jx.samp_mask)[None]
        self.adj = (adjacency_banded(samp_idx[..., :k], samp_mask[..., :k], self.cfg.potts_band)
                    if jx.use_band else adjacency_from_knn(samp_idx[..., :k], samp_mask[..., :k]))
        self.adjh = engine._repeat_rows(self.adj, self.hyp)
        self.datah, self.maskh, self.wh = (engine._repeat_rows(x, self.hyp)
                                           for x in (self.data, self.mask, self.w))

    def t(self, x, dtype=None):
        x = self.torch.as_tensor(np.asarray(x), device=self.dev)
        return x if dtype is None else x.to(dtype)

    def state(self, js):
        long = self.torch.long
        return self.engine.FitState(
            descs=self.t(js.descs)[None], active=self.t(js.active)[None],
            labels=self.t(js.labels, long)[None], compound_pref=self.t(js.compound_pref)[None],
            n_slots_used=self.t(js.n_slots_used, long)[None],
            total_iters=self.t(js.total_iters, long)[None],
            rejections=self.t(js.rejections, long)[None], energy=self.t(js.energy)[None],
            done=self.t(js.done)[None])

    def search(self, idx_h, ok_h, pref, has_c, lo_steps):
        torch = self.torch
        cfg = dataclasses.replace(self.cfg, hyp_axis=None, lo_steps=lo_steps)
        b, ms = idx_h.shape[1:]
        desc, score, _ = self.engine._search(
            self.family, cfg, self.paramsh, self.datah, self.maskh, self.wh,
            self.t(idx_h, torch.long), self.t(ok_h),
            torch.zeros(self.hyp, 0, b, ms, dtype=torch.long, device=self.dev),
            torch.zeros(self.hyp, 0, b, dtype=torch.bool, device=self.dev), self.adjh,
            self.t(pref)[None].expand(self.hyp, -1).contiguous(),
            torch.full((self.hyp,), bool(has_c), device=self.dev))
        return desc.cpu().numpy(), score.cpu().numpy()

    def round(self, js, desc, score, drawn):
        torch = self.torch
        cfg = dataclasses.replace(self.cfg, hyp_axis=None)

        def propose(pref, has_c):
            return (self.t(desc)[None], self.t(score, torch.float32).reshape(1),
                    self.t(drawn, torch.long).reshape(1))

        ns, stats, _ = self.engine._round(self.family, cfg, self.params1, self.data,
                                          self.mask, self.w, self.adj, propose, self.state(js))
        return ns, [x[0].cpu().numpy() for x in stats]

    def refit(self, weights, descs):
        out = self.family.refit(self.data, self.t(weights)[None], self.t(descs)[None])
        return [x[0].cpu().numpy() for x in out]

    def pearl(self, descs, active, labels):
        from progressivex_tpu_torch.core.pearl import pearl_run

        res = pearl_run(self.family, self.cfg, self.params1, self.data, self.mask, self.w,
                        self.t(descs)[None], self.t(active)[None],
                        self.t(labels, self.torch.long)[None], self.adj)
        return [x[0].cpu().numpy() for x in res]


def _refit_check(jx, pt, weights, descs):
    """Both packages' refit of each row of `descs` [K, D] on the same
    `weights` [K, N]: the descriptor gap, each one's gap to the float64
    result of the same algorithm, and the two smallest eigenvalues of the
    row's conditioned normal matrix over its largest (where they sit within
    a small factor of each other near float32's resolution, the rounding of
    the matrix decides its smallest eigenvector). Homographies only."""
    jnp = jx.jnp
    jd, jok = (np.asarray(x) for x in jx.refit(jnp.array(weights), jnp.array(descs)))
    pd, pok = pt.refit(weights, descs)
    rows, cond = [], []
    for q in (jx.data[:, :2].astype(np.float64), jx.data[:, 2:4].astype(np.float64)):
        c = q.mean(0)
        s = np.sqrt(2.0) / np.linalg.norm(q - c, axis=1).mean()
        rows.append((q - c) * s)
        cond.append((c, s))
    (x1, y1), (x2, y2) = rows[0].T, rows[1].T
    z, o = np.zeros_like(x1), np.ones_like(x1)
    r0 = np.stack([-x1, -y1, -o, z, z, z, x2 * x1, x2 * y1, x2], 1)
    r1 = np.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], 1)
    (c1, s1), (c2, s2) = cond
    t1 = np.array([[s1, 0, -s1 * c1[0]], [0, s1, -s1 * c1[1]], [0, 0, 1]])
    t2inv = np.array([[1 / s2, 0, c2[0]], [0, 1 / s2, c2[1]], [0, 0, 1]])
    out = []
    for k in range(len(descs)):
        w = weights[k].astype(np.float64)
        m = (r0 * w[:, None]).T @ r0 + (r1 * w[:, None]).T @ r1
        ev = np.linalg.eigvalsh(m)
        # the refit's own algorithm (shifted inverse iteration, six steps,
        # models/homography._nonminimal) in float64: the answer without rounding
        ms = m + max(1e-6 * np.trace(m) / 9, 1e-12) * np.eye(9)
        v = np.arange(1.0, 10.0) / np.linalg.norm(np.arange(1.0, 10.0))
        for _ in range(6):
            v = np.linalg.solve(ms, v)
            v = v / np.linalg.norm(v)
        h64 = (t2inv @ v.reshape(3, 3) @ t1).reshape(9)
        out.append({"row": k, "weighted": int((w > 0).sum()),
                    "desc_gap": float(_desc_gap(jd[k], pd[k])),
                    "gap_to_float64": [float(_desc_gap(jd[k], h64)),
                                       float(_desc_gap(pd[k], h64))],
                    "ok": [bool(jok[k]), bool(pok[k])],
                    "eig_small_over_max": [float(ev[0] / ev[-1]), float(ev[1] / ev[-1])]})
    return out


def _round_stages(jx, pt, rnd):
    """Every stage of round `rnd` on the JAX state at its start."""
    jnp = jx.jnp
    js = jx.state
    pref, has_c = np.asarray(js.compound_pref), bool(np.asarray(js.active).any())
    idx_h, ok_h = jx.idx[rnd], jx.ok[rnd]
    st = {}
    (j0d, j0s), (j1d, j1s) = (tuple(np.asarray(y) for y in x) for x in jx.proposals(
        jnp.array(idx_h), jnp.array(ok_h), jnp.array(pref), has_c))
    for name, (jdd, jss), lo in (("pre_lo", (j0d, j0s), 0), ("lo", (j1d, j1s), jx.cfg.lo_steps)):
        pdd, pss = pt.search(idx_h, ok_h, pref, has_c, lo)
        g = _desc_gap(jdd, pdd)
        st[name] = {"desc_gap": g.tolist(), "score_jax": jss.tolist(),
                    "score_port": pss.tolist(),
                    "same": bool((g <= DESC_TOL).all() and np.allclose(
                        pss, jss, rtol=SCORE_RTOL))}
    if not st["lo"]["same"]:
        st["lo"]["refit"] = _refit_check(
            jx, pt, np.asarray(jx.lo_weights(jnp.array(j0d))), j0d)
    # the round given the JAX winner
    ns, jstats = jx.round(js, jnp.array(idx_h), jnp.array(ok_h))
    best = int(np.argmax(j1s))
    pns, pstats = pt.round(js, j1d[best], j1s[best], jx.cfg.n_hypotheses * jx.hyp)
    names = ("accepted", "inliers", "tanimoto", "score", "energy", "n_active")
    jst = [np.asarray(x) for x in jstats]
    st["round"] = {"jax": {k: v.item() for k, v in zip(names, jst)},
                   "port": {k: v.item() for k, v in zip(names, pstats)},
                   "labels_differ": int((np.asarray(ns.labels)
                                         != pns.labels[0].cpu().numpy()).sum()),
                   "active_same": bool(np.array_equal(np.asarray(ns.active),
                                                      pns.active[0].cpu().numpy()))}
    st["round"]["same"] = bool(
        st["round"]["labels_differ"] == 0 and st["round"]["active_same"]
        and all(st["round"]["jax"][k] == st["round"]["port"][k]
                for k in ("accepted", "inliers", "n_active"))
        and np.allclose(jst[4], pstats[4], rtol=1e-5, equal_nan=True))
    # PEARL on the round's inputs
    slot = int(np.asarray(js.n_slots_used))
    descs, active = np.asarray(js.descs).copy(), np.asarray(js.active).copy()
    if bool(jst[0]):
        descs[slot], active[slot] = j1d[best], True
    if bool(jst[0]) and active.sum() > 1:
        jres = jx.pearl(jnp.array(descs), jnp.array(active), js.labels)
        pres = pt.pearl(descs, active, np.asarray(js.labels))
        st["pearl"] = {"labels_differ": int((np.asarray(jres.labels) != pres[2]).sum()),
                       "active_same": bool(np.array_equal(np.asarray(jres.active), pres[1])),
                       "energy_jax": float(jres.energy), "energy_port": float(pres[3]),
                       "max_desc_gap": float(_desc_gap(np.asarray(jres.descs),
                                                       pres[0]).max())}
        st["pearl"]["same"] = bool(st["pearl"]["labels_differ"] == 0
                                   and st["pearl"]["active_same"]
                                   and np.isclose(float(jres.energy), float(pres[3]),
                                                  rtol=1e-5))
        if not st["pearl"]["same"]:
            act = np.nonzero(active)[0]
            weights = np.asarray(jx.pearl_weights(jnp.array(descs), jnp.array(active)))
            st["pearl"]["refit"] = _refit_check(jx, pt, weights[act], descs[act])
            for r, k in zip(st["pearl"]["refit"], act):
                r["slot"] = int(k)
    jx.state = ns
    return st, bool(np.asarray(ns.done))


STAGES = ("pre_lo", "lo", "pearl", "round")  # PEARL runs inside the round


def _detail(s):
    """The quantities that tell what parted the two packages at a stage."""
    out = {k: s[k] for k in ("desc_gap", "score_jax", "score_port", "labels_differ",
                             "energy_jax", "energy_port", "jax", "port") if k in s}
    if "refit" in s:  # the refit on the same weights that parted the most
        out["refit"] = max(s["refit"], key=lambda r: r["desc_gap"])
    return out


def lockstep(jx, pt, seed):
    jx.start(seed)
    rounds, first = [], None
    for rnd in range(jx.cfg.max_rounds):
        st, done = _round_stages(jx, pt, rnd)
        rounds.append(st)
        for stage in STAGES:
            if first is None and stage in st and not st[stage]["same"]:
                first = {"round": rnd, "stage": stage, **_detail(st[stage])}
        if done:
            break
    return {"hyp": jx.hyp, "seed": seed, "graph": pt.graph, "rounds": rounds,
            "first_difference": first}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="unihouse")
    ap.add_argument("--hyp", default="1,2,4")
    ap.add_argument("--seeds", default="0", help="comma separated seeds")
    ap.add_argument("--port-device", default="cuda")
    ap.add_argument("--jax-platform", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import jax

    if args.jax_platform:
        jax.config.update("jax_platforms", args.jax_platform)
    print("jax devices", jax.devices(), flush=True)
    lines = []
    for hyp in (int(h) for h in args.hyp.split(",")):
        jx = _Jax(args.scene, hyp)
        pt = _Port(jx, args.port_device)
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            line = {"scene": args.scene, "port_device": args.port_device,
                    **lockstep(jx, pt, seed), "seconds": time.perf_counter() - t0}
            print(json.dumps({k: v for k, v in line.items() if k != "rounds"}), flush=True)
            lines.append(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)


if __name__ == "__main__":
    main()
