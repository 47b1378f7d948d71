"""The fit's stages read nothing to the host (the port's counterpart of the
JAX package's device loops, which a CUDA graph captures on the card,
core/graphs.py), checked on the CPU.

- Every stage that core/graphs.py captures (`engine.prepare`, `draw`,
  `start`, `round_propose`, `round_update`, `finish`) runs with torch.Tensor's
  host reads (`__bool__`, `__int__`, `__float__`, `__index__`, `item`,
  `tolist`, `cpu`, `numpy`) patched to raise, for H, F (two restarts as
  rows), E, lines, VPs and PnP at a few hundred points and three rounds,
  and for a banded PROSAC fit (the spatial sort and the samples mapped
  through it); `icm_sweeps` and `pearl_run` on their own likewise.
- `icm_sweeps` gives the same labels and energy with and without its early
  exit on random costs.
- core/graphs.py's dataflow: engine.fit_rows' stages through the graph
  runner with every graph replaced by an eager call that writes into the
  same buffers (a replay's semantics) give the eager fit's FitResult bit
  for bit, with live progress and with two hypothesis replicas too.
- `ops/linalg.svd3_jacobi`, the card's SVD, against torch.linalg.svd.
- The launch table's recording (kernels/_build.py).

No JAX program is compiled here.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import progressivex_tpu_torch as px
from progressivex_tpu_torch.core import engine, graphs
from progressivex_tpu_torch.core.config import EngineConfig, make_params, rows_params
from progressivex_tpu_torch.core.pearl import pearl_run
from progressivex_tpu_torch.eval import extras
from progressivex_tpu_torch.io.data import load_corr_scene, load_tless_scene
from progressivex_tpu_torch.kernels import _build
from progressivex_tpu_torch.models import get_family
from progressivex_tpu_torch.ops import labeling, linalg, prng

_READS = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "cpu",
          "numpy")
_STAGES = ("prepare", "draw", "start", "round_propose", "round_update", "finish")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _no_host_reads():
    """Inside, every host read of a tensor raises."""
    saved = {name: getattr(torch.Tensor, name) for name in _READS}

    def refuse(name):
        def read(self, *a, **k):
            raise AssertionError(f"host read: Tensor.{name}")
        return read

    for name in _READS:
        setattr(torch.Tensor, name, refuse(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


@pytest.fixture
def read_free_stages(monkeypatch):
    """Patch the engine's captured stages to run under `_no_host_reads`;
    yields {stage: calls}."""
    calls = dict.fromkeys(_STAGES, 0)
    for name in _STAGES:
        fn = getattr(engine, name)

        def guarded(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            with _no_host_reads():
                return _fn(*a, **k)

        monkeypatch.setattr(engine, name, guarded)
    return calls


def _corrs(scene, n):
    return load_corr_scene(scene)[0][:n]


def _tless(n):
    xy, xyz, K, _ = load_tless_scene()
    return xy[:n], xyz[:n], K


SMALL = dict(max_iters=100, max_rounds=3, device="cpu", random_seed=0)
CASES = {
    "H": lambda: px.findHomographiesBatched([_corrs("oldclassicswing", 300)], **SMALL),
    "F": lambda: px.findTwoViewMotionsBatched([_corrs("book", 300)], n_restarts=2,
                                              **SMALL),
    "E": lambda: px.findEssentialMatricesBatched(
        [extras.gauntlet_scene("two", 0)[0][:300]], extras.gauntlet_camera(),
        extras.gauntlet_camera(), split_pass=1, magsac_levels=4, **SMALL),
    "lines": lambda: px.findLinesBatched(
        [extras.make_lines_scene(n_lines=3, per_line=80, n_outliers=60)[0]], **SMALL),
    "VPs": lambda: px.findVanishingPointsBatched([extras.make_vp_scene(seed=0)[0]],
                                                 **SMALL),
    "PnP": lambda: px.find6DPosesBatched(*([x] for x in _tless(300)), **SMALL),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_captured_stages_read_nothing(case, read_free_stages):
    out = CASES[case]()
    assert len(out) == 1 and np.isfinite(out[0][0]).all()
    assert all(read_free_stages[s] > 0 for s in _STAGES), read_free_stages


def _banded_fit(**cfg_kw):
    """A banded (potts_band 8), PROSAC-sampled homography fit of two rows
    on engine.fit_rows: the spatial sort, the samples mapped through it."""
    corrs = np.stack([_corrs("oldclassicswing", 256), _corrs("unionhouse", 256)])
    data = torch.as_tensor(corrs, dtype=torch.float32)
    mask = torch.ones(2, 256, dtype=torch.bool)
    cfg = EngineConfig(family="homography", n_hypotheses=64, max_rounds=3,
                       pearl_iters=2, icm_sweeps=2, potts_band=8, sampler_id=1,
                       final_relabel=2, magsac_levels=4, **cfg_kw)
    params = make_params(threshold=4.0, confidence=0.5, min_inliers=10, n_valid=256,
                         neighborhood_radius=200.0, max_tanimoto=0.4)
    return engine.fit_rows(get_family("homography"), cfg, params, data, mask,
                           torch.ones(2, 256),
                           keys=torch.stack([prng.key(s) for s in (1, 2)]))


def test_banded_prosac_stages_read_nothing(read_free_stages):
    res = _banded_fit()
    assert res.labels.shape == (2, 256)
    assert all(read_free_stages[s] > 0 for s in _STAGES), read_free_stages


def _labeling_case(seed, rows=3, n=200, k=5):
    r = np.random.default_rng(seed)
    dcost = torch.as_tensor(r.uniform(0, 1, (rows, k + 1, n)), dtype=torch.float32)
    knn = torch.as_tensor(r.integers(0, n, (rows, n, 8)), dtype=torch.int32)
    adj = labeling.adjacency_from_knn(knn, torch.ones(rows, n, 8, dtype=torch.bool))
    start = torch.as_tensor(r.integers(0, k + 1, (rows, n)))
    return dcost, start, adj


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_icm_early_exit_gives_the_same_labels(seed):
    dcost, start, adj = _labeling_case(seed)
    with _no_host_reads():
        labels, energy = labeling.icm_sweeps(dcost, start, adj, 0.3, 6)
    want_labels, want_energy = labeling.icm_sweeps(dcost, start, adj, 0.3, 6,
                                                   early_exit=True)
    assert torch.equal(labels, want_labels)
    assert torch.equal(energy, want_energy)


def test_pearl_run_reads_nothing():
    corrs = _corrs("oldclassicswing", 200)
    data = torch.as_tensor(corrs, dtype=torch.float32)[None]
    family = get_family("homography")
    cfg = EngineConfig(family="homography", max_models=4, max_rounds=4, pearl_iters=3,
                       icm_sweeps=3)
    params = rows_params(make_params(threshold=4.0, min_inliers=10, n_valid=200), 1, "cpu")
    r = np.random.default_rng(0)
    idx = torch.as_tensor(r.integers(0, 200, (4, 4)))
    descs, ok = family.minimal_solver_batched(data[0][idx])
    mask = torch.ones(1, 200, dtype=torch.bool)
    knn = torch.as_tensor(r.integers(0, 200, (1, 200, 8)), dtype=torch.int32)
    adj = labeling.adjacency_from_knn(knn, torch.ones(1, 200, 8, dtype=torch.bool))
    with _no_host_reads():
        res = pearl_run(family, cfg, params, data, mask, torch.ones(1, 200),
                        descs.reshape(1, 4, 9), ok.reshape(1, 4),
                        torch.full((1, 200), 4), adj)
    assert res.labels.shape == (1, 200)


def _fields(res):
    out = {}
    for f in res._fields:
        v = getattr(res, f)
        if f == "round_log":
            out.update({f"round_log.{n}": c.numpy().tobytes() for n, c in zip(v._fields, v)})
        elif isinstance(v, torch.Tensor):
            out[f] = v.numpy().tobytes()
    return out


@pytest.fixture
def emulated_graphs(monkeypatch):
    """The graph runner (core/graphs.py's `_Graphs`) on the CPU, with every
    CUDA graph replaced by an eager call of its function that writes into
    the graph's output buffers, as a replay writes them; `graphs.eager()`
    still runs the eager runner."""
    def capture(self, name, fn, outs):
        warm = fn()
        bufs = graphs._map(torch.empty_like, warm) if outs is None else outs(warm)

        class Replay:
            def replay(_):
                graphs._write(bufs, fn())

        self.graphs[name] = (Replay(), ())
        self.outs[name] = bufs

    graphs.clear()
    monkeypatch.setattr(graphs._Graphs, "_capture", capture)
    monkeypatch.setattr(graphs, "applies",
                        lambda dev, hyp_devices=None: graphs._EAGER[0] == 0)
    yield
    graphs.clear()


def _f_restarts():
    """The F case's FitResult (two restarts as rows)."""
    seen, orig = [], engine.fit_rows

    def keep(*a, **k):
        seen.append(orig(*a, **k))
        return seen[-1]

    engine.fit_rows = keep
    try:
        CASES["F"]()
    finally:
        engine.fit_rows = orig
    return seen[0]


def _hyp_fit(scenes):
    """A homography fit of two rows on engine.fit_rows with two replicas of
    each row's proposal on the fit's device (cfg.hyp_axis), on the first
    256 points of `scenes`."""
    data = torch.as_tensor(np.stack([_corrs(s, 256) for s in scenes]), dtype=torch.float32)
    cfg = EngineConfig(family="homography", n_hypotheses=32, max_rounds=3,
                       pearl_iters=2, icm_sweeps=2, final_relabel=2, hyp_axis="hyp")
    params = make_params(threshold=4.0, confidence=0.5, min_inliers=10, n_valid=256,
                         neighborhood_radius=200.0, max_tanimoto=0.4)
    keys = torch.stack([torch.stack([prng.key(10 * r + h) for h in range(2)])
                        for r in range(2)])
    return engine.fit_rows(get_family("homography"), cfg, params, data,
                           torch.ones(2, 256, dtype=torch.bool), torch.ones(2, 256),
                           keys=keys)


@pytest.mark.parametrize("case", ["banded PROSAC", "unroll_rounds", "F restarts",
                                  "hyp replicas"])
def test_graph_dataflow_matches_the_eager_fit(case, emulated_graphs):
    if case == "F restarts":
        fits = [_f_restarts] * 2
    elif case == "hyp replicas":
        # The second call replays the first call's graphs on other data: a
        # proposal whose replicas copied the first call's inputs would
        # score the wrong points.
        fits = [lambda: _hyp_fit(["oldclassicswing", "unionhouse"]),
                lambda: _hyp_fit(["unionhouse", "unihouse"])]
    else:
        fits = [lambda: _banded_fit(unroll_rounds=case == "unroll_rounds")] * 2
    with graphs.eager():
        want = [_fields(fit()) for fit in fits]
    # the first call builds the stages, the second replays them
    assert [_fields(fit()) for fit in fits] == want


def test_graph_dataflow_live_progress(emulated_graphs):
    runs = []
    for form in (graphs.eager, contextlib.nullcontext):
        events = []
        engine.LIVE_CALLBACK = events.append
        try:
            with form():
                runs.append((_fields(_banded_fit(live_progress=True)), events))
        finally:
            engine.LIVE_CALLBACK = None
    (want, want_events), (got, events) = runs
    assert got == want
    assert len(events) == len(want_events) > 0
    for a, b in zip(events, want_events):
        assert a.keys() == b.keys()
        assert all(np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes() for k in a)


def test_svd3_jacobi_against_torch():
    r = np.random.default_rng(0)
    M = torch.as_tensor(r.normal(size=(500, 3, 3)), dtype=torch.float32)
    M[:100, :, 2] = 0.3 * M[:100, :, 0] + M[:100, :, 1]  # rank 2, as Kabsch on 3 points
    U, S, Vh = linalg.svd3_jacobi(M)
    U2, S2, Vh2 = torch.linalg.svd(M)

    def rotation(U, Vh):
        V, Ut = Vh.transpose(-1, -2), U.transpose(-1, -2)
        sgn = torch.sign(torch.linalg.det(V @ Ut))
        return V @ torch.diag_embed(torch.stack([torch.ones_like(sgn)] * 2 + [sgn], -1)) @ Ut

    np.testing.assert_allclose(S.numpy(), S2.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rotation(U, Vh).numpy(), rotation(U2, Vh2).numpy(),
                               atol=2e-5)
    # U^T M V is diag(S) up to the sign of the last pair (u3 = u1 x u2)
    np.testing.assert_allclose((U.transpose(-1, -2) @ M @ Vh.transpose(-1, -2)).abs().numpy(),
                               torch.diag_embed(S).numpy(), atol=1e-5)


def test_launch_counts_are_recorded_for_replays(monkeypatch):
    for counts in (_build.LAUNCHES, _build.UNITS):
        monkeypatch.setitem(counts, "score_homography", 0)
    with _build.recording() as tally:
        _build._count("score_homography", 3)
        _build._count("score_homography", 3)
    assert tally == [("score_homography", 3)] * 2
    assert _build.LAUNCHES["score_homography"] == 0
    _build.add_counts(tally)
    _build._count("score_homography", 2)
    assert _build.LAUNCHES["score_homography"] == 3
    assert _build.UNITS["score_homography"] == 8


def test_graphs_apply_only_on_the_card():
    cuda = torch.device("cuda", 0)
    assert not graphs.applies(torch.device("cpu"))
    assert graphs.applies(cuda) and graphs.applies(cuda, [cuda, cuda])
    assert not graphs.applies(cuda, [cuda, torch.device("cpu")])
    with graphs.eager():
        assert not graphs.applies(cuda)
    assert graphs.applies(cuda)


def test_eager_config_fields_are_kept():
    cfg = dataclasses.replace(EngineConfig(family="homography"), unroll_rounds=True)
    assert engine.unrolled(cfg)
    assert not engine.unrolled(dataclasses.replace(cfg, live_progress=True))


@pytest.mark.parametrize("case", ["banded PROSAC", "F restarts"])
def test_graph_fit_reads_nothing_before_the_rounds(case, emulated_graphs, monkeypatch):
    """A graph fit reads nothing to the host from the choice of its runner
    until its rounds start (the draw of the samples from the rows' keys
    runs in the `start` graph), then at most two values a round
    (`any_pearl`, `all_done`)."""
    saved = {name: getattr(torch.Tensor, name) for name in _READS}
    reads = {"before": 0, "rounds": 0}
    where = ["outside"]

    def counting(name):
        def read(self, *a, **k):
            if where[0] in reads:
                reads[where[0]] += 1
            return saved[name](self, *a, **k)
        return read

    runner, stage = graphs.runner, graphs._Graphs.stage

    @contextlib.contextmanager
    def watched_runner(*a, **k):
        where[0] = "before"
        try:
            with runner(*a, **k) as run:
                yield run
        finally:
            where[0] = "outside"

    def watched_stage(self, name, fn, outs=None):
        if name in ("propose", "finish"):
            where[0] = "rounds" if name == "propose" else "finish"
        return stage(self, name, fn, outs)

    monkeypatch.setattr(graphs, "runner", watched_runner)
    monkeypatch.setattr(graphs._Graphs, "stage", watched_stage)
    fit = _f_restarts if case == "F restarts" else _banded_fit
    fit()  # builds the stages
    reads.update(before=0, rounds=0)
    for name in _READS:
        monkeypatch.setattr(torch.Tensor, name, counting(name))
    res = fit()
    for name, fn in saved.items():
        monkeypatch.setattr(torch.Tensor, name, fn)
    assert reads["before"] == 0
    assert 0 < reads["rounds"] <= 2 * int(res.rounds_run.max())
