"""The port's hypothesis parallelism and scene sharding
(parallel/sharding, core/engine's replica axis, api_batch's mesh), on a
virtual mesh of the CPU: a list of devices that names "cpu" several
times, as the JAX package's tests force eight host devices.

- Scenes-axis sharding gives the unsharded call's bits (labels and
  descriptors equal), for H and for F with restarts
  (tests/test_batch_mesh.py's rule and keywords), and through the
  dataset pass under PROGX_BENCH_DEVICES.
- A 2-replica proposal with LO off equals one argmax over the pooled 2B
  samples (tests/test_sharding.py:130-184; rtol 1e-6).
- `fit_batch` over a mesh equals `fit_rows` on the same replica draws,
  exactly.
- The host side of a launch from several threads: the launch counts,
  the library build and the per-device workers.

Port only; tests/test_torch_sharding_jax.py holds the port against the
JAX package.
"""

import dataclasses
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import progressivex_tpu_torch
from progressivex_tpu_torch import _device, api_batch
from progressivex_tpu_torch.core import engine
from progressivex_tpu_torch.core.config import EngineConfig, make_params, rows_params
from progressivex_tpu_torch.eval import adelaide
from progressivex_tpu_torch.kernels import _build
from progressivex_tpu_torch.kernels import scoring as kscoring
from progressivex_tpu_torch.models import get_family
from progressivex_tpu_torch.parallel import sharding
from progressivex_tpu_torch.parallel.sharding import fit_batch, make_mesh


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the shards' own host threads would otherwise
    oversubscribe the cores with torch's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n_scenes, n_hyp=1):
    return make_mesh(n_scenes, n_hyp, devices=["cpu"] * (n_scenes * n_hyp))


def _homography_scenes(n_scenes=3, n=160, seed=0):
    """tests/test_batch_mesh._scenes: two homographies of n // 3 points
    each and uniform outliers."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n_scenes):
        Hs = [np.array([[1.0, 0.05 * s, 30.0], [0.0, 1.0, -5.0 * s], [0.0, 0.0, 1.0]]),
              np.array([[0.9, 0.1, -20.0], [-0.1, 1.1, 30.0], [0.0, 0.0, 1.0]])]
        per = n // 3
        corrs = []
        for H in Hs:
            p1 = rng.uniform(0, 200, (per, 2))
            ph = np.concatenate([p1, np.ones((per, 1))], 1) @ H.T
            p2 = ph[:, :2] / ph[:, 2:3] + rng.normal(scale=0.5, size=(per, 2))
            corrs.append(np.concatenate([p1, p2], 1))
        corrs.append(rng.uniform(0, 200, (n - 2 * per, 4)))
        out.append(np.concatenate(corrs))
    return out


KW = dict(threshold=3.0, conf=0.9, spatial_coherence_weight=0.1,
          neighborhood_ball_radius=50.0, maximum_tanimoto_similarity=0.4,
          max_iters=128, minimum_point_number=16, maximum_model_number=4,
          random_seed=7)


def _line_scenes(n_scenes, n=128, seed=0):
    """tests/test_sharding._scenes: two lines a scene."""
    r = np.random.default_rng(seed)
    data = np.zeros((n_scenes, n, 2), np.float32)
    for s in range(n_scenes):
        t = r.uniform(0, 100, n // 2)
        l1 = np.stack([t, 0.5 * t + 5 * s], 1)
        t2 = r.uniform(0, 100, n - n // 2)
        l2 = np.stack([t2, -0.3 * t2 + 60.0], 1)
        data[s] = np.concatenate([l1, l2]) + r.normal(scale=0.2, size=(n, 2))
    return (torch.from_numpy(data), torch.ones(n_scenes, n, dtype=torch.bool),
            torch.ones(n_scenes, n))


LINE_CFG = EngineConfig(family="line2d", n_hypotheses=64, max_rounds=4,
                        pearl_iters=2, icm_sweeps=2, sampler_id=0)
LINE_PARAMS = make_params(threshold=1.0, confidence=0.95, min_inliers=20, n_valid=128)


def _assert_same(a, b):
    for (d0, l0), (d1, l1) in zip(a, b):
        np.testing.assert_array_equal(l0, l1)
        np.testing.assert_array_equal(d0, d1)


def _assert_same_fit(a, b):
    for f in ("labels", "active", "descs", "energy", "n_models", "total_iters",
              "rounds_run", "samples_drawn"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# (a) the mesh and its errors

def test_make_mesh_raises_on_too_few_devices():
    with pytest.raises(ValueError, match="need 4 devices, have 3"):
        make_mesh(2, 2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match=r"need \d+ devices"):
        make_mesh(torch.cuda.device_count() + 1, 1)  # the visible cards


def test_virtual_cpu_mesh_builds():
    mesh = make_mesh(2, 3, devices=["cpu"] * 7)
    assert mesh.axis_names == ("scenes", "hyp")
    assert mesh.shape == {"scenes": 2, "hyp": 3}
    assert mesh.devices.shape == (2, 3)
    assert all(d == torch.device("cpu") for d in mesh.devices.reshape(-1))
    assert make_mesh(1, 1, devices=["cuda"]).devices[0, 0] == torch.device("cuda", 0)


def test_mesh_without_scenes_axis_raises():
    scene = _homography_scenes(1)[0]
    bad = sharding.Mesh(np.array([torch.device("cpu")] * 2, dtype=object), ("x",))
    with pytest.raises(ValueError, match="scenes"):
        progressivex_tpu_torch.findHomographiesBatched([scene], **KW, mesh=bad,
                                                       device="cpu")
    assert api_batch._resolve_mesh(None, 1) is None
    assert api_batch._resolve_mesh(None, None) is None
    mesh = cpu_mesh(2)
    assert api_batch._resolve_mesh(mesh, 8) is mesh


# (b) scenes-axis sharding changes no bit

@pytest.mark.parametrize("n_scenes_axis", [2, 4])
def test_homographies_mesh_parity(n_scenes_axis):
    scenes = _homography_scenes()
    ref = progressivex_tpu_torch.findHomographiesBatched(scenes, **KW, device="cpu")
    got = progressivex_tpu_torch.findHomographiesBatched(
        scenes, **KW, mesh=cpu_mesh(n_scenes_axis), device="cpu")
    _assert_same(ref, got)
    assert all(d.shape[0] >= 3 for d, _ in got)


@pytest.mark.parametrize("n_scenes_axis", [2, 4])
def test_two_view_motions_mesh_parity_with_restarts(n_scenes_axis):
    scenes = _homography_scenes(n_scenes=2, seed=3)
    kw = dict(KW, threshold=1.0, n_restarts=2, magsac_levels=2, final_relabel=1)
    ref = progressivex_tpu_torch.findTwoViewMotionsBatched(scenes, **kw, device="cpu")
    got = progressivex_tpu_torch.findTwoViewMotionsBatched(
        scenes, **kw, mesh=cpu_mesh(n_scenes_axis), device="cpu")
    _assert_same(ref, got)


def test_lanes_round_up_to_the_scenes_axis(capsys):
    progressivex_tpu_torch.findHomographiesBatched(
        _homography_scenes(1), **KW, mesh=cpu_mesh(4), device="cpu", do_logging=True)
    assert "1 scenes (4 lanes x 1 restarts" in capsys.readouterr().err
    with pytest.raises(ValueError, match="do not divide"):
        api_batch._run_batched(
            "homography", [s.astype(np.float32) for s in _homography_scenes(1)], None,
            thresholds=3.0, conf=0.9, spatial_coherence_weight=0.1,
            neighborhood_ball_radius=50.0, maximum_tanimoto_similarity=0.4,
            max_iters=128, minimum_point_number=16, maximum_model_number=4,
            sampler_id=3, scoring_exponent=2, lanes=3, mesh=cpu_mesh(2))


@pytest.fixture
def two_scene_root(tmp_path):
    """Two homography scenes in the dataset layout
    (<root>/<scene>/<scene>.txt, rows x1 y1 1 x2 y2 1 label), both in the
    256 bucket."""
    for i, corrs in enumerate(_homography_scenes(2, n=150, seed=5)):
        labels = np.repeat([1, 2, 0], 50)  # two structures, then outliers
        rows = np.c_[corrs[:, :2], np.ones(150), corrs[:, 2:], np.ones(150), labels]
        os.makedirs(tmp_path / f"s{i}")
        np.savetxt(tmp_path / f"s{i}" / f"s{i}.txt", rows)
    return str(tmp_path)


def test_dataset_pass_under_bench_devices(two_scene_root, monkeypatch):
    """PROGX_BENCH_DEVICES=4 on a virtual mesh: every batch rounds up to
    4 lanes and gives the unsharded pass's ME on the same lanes."""
    plan = adelaide.lane_plan("H", [150, 150], 1, n_devices=4)
    assert [(b.n_pad, b.lanes, b.rows, b.scenes) for b in plan] == [(256, 4, 4, (0, 1))]
    kw = dict(root=two_scene_root, n_timing_runs=1, lane_target=4, device="cpu")
    ref = adelaide.throughput_batch("H", **kw)
    monkeypatch.setenv("PROGX_BENCH_DEVICES", "4")
    with pytest.raises(ValueError, match=r"need 4 devices"):
        adelaide.throughput_batch("H", **kw)  # no four cards here
    monkeypatch.setattr(adelaide, "make_mesh", lambda n, h: cpu_mesh(n, h))
    got = adelaide.throughput_batch("H", **kw)
    assert [(b["lanes"], b["rows"]) for b in got.buckets] == [(4, 4)]
    assert got.mean_me == ref.mean_me and got.n_distinct == 2


# (c) the replica reduction

def test_hyp_winner_reduction_equals_single_double_budget():
    """tests/test_sharding.py:130-184 on the port: with LO off, the
    winner of two replicas of B samples is the argmax over the pooled 2B
    samples."""
    family = get_family("line2d")
    n, b = 128, 32
    data, mask, w = _line_scenes(1, n=n, seed=9)
    params = rows_params(LINE_PARAMS, 1, "cpu")
    g = torch.Generator().manual_seed(11)
    idx = torch.randint(0, n, (1, 2 * b, family.sample_size), generator=g)
    ok = torch.ones(1, 2 * b, dtype=torch.bool)
    adj = torch.zeros(1, n, n)
    compound = torch.zeros(1, n)
    has = torch.zeros(1, dtype=torch.bool)
    single = EngineConfig(family="line2d", n_hypotheses=2 * b, lo_candidates=1,
                          lo_steps=0, lo_spatial_lambda=0.0, sampler_id=0)
    dual = dataclasses.replace(single, n_hypotheses=b, hyp_axis="hyp")

    def no_ext(*lead):
        return (torch.zeros(*lead, 0, b, family.sample_size, dtype=torch.long),
                torch.zeros(*lead, 0, b, dtype=torch.bool))

    want = engine._make_propose(family, single, params, data, mask, w, adj,
                                (idx[:, None], ok[:, None], *no_ext(1)))(0, compound, has)
    got = engine._make_propose(family, dual, params, data, mask, w, adj,
                               (idx.reshape(1, 2, 1, b, -1), ok.reshape(1, 2, 1, b),
                                *no_ext(1, 2)))(0, compound, has)
    assert bool(want[1] > engine._NEG / 2) and bool(got[1] > engine._NEG / 2)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-6, atol=1e-6)
    assert int(got[2]) == int(want[2]) == 2 * b


# (d) fit_batch

def test_fit_batch_scene_mesh_equals_fit_rows():
    """A (2, 1) mesh: each scene's one replica draws from
    replica_seed(seed, 0, 0), so fit_rows on those draws, and fit_batch
    without a mesh, give the same bits."""
    family = get_family("line2d")
    data, mask, w = _line_scenes(2, seed=3)
    seeds = [5, 6]
    got = fit_batch("line2d", LINE_CFG, LINE_PARAMS, data, mask, w, seeds,
                    mesh=cpu_mesh(2))
    gens = [torch.Generator().manual_seed(sharding.replica_seed(s, 0, 0)) for s in seeds]
    want = engine.fit_rows(family, LINE_CFG, LINE_PARAMS, data, mask, w, generators=gens)
    _assert_same_fit(got, want)
    _assert_same_fit(fit_batch(family, LINE_CFG, LINE_PARAMS, data, mask, w, seeds), want)
    assert got.restart == (0, 0) and bool((got.n_models == 2).all())


def test_fit_batch_hyp_mesh_equals_fit_rows_on_replica_draws():
    """A (1, 3) mesh: three replicas of each row, against fit_rows with
    the hyp axis on the same three generators a row; the samples drawn
    are three times one replica's."""
    family = get_family("line2d")
    data, mask, w = _line_scenes(1, seed=4)
    got = fit_batch("line2d", LINE_CFG, LINE_PARAMS, data, mask, w, [8],
                    mesh=cpu_mesh(1, 3))
    gens = [[torch.Generator().manual_seed(sharding.replica_seed(8, 0, h))
             for h in range(3)]]
    want = engine.fit_rows(family, dataclasses.replace(LINE_CFG, hyp_axis="hyp"),
                           LINE_PARAMS, data, mask, w, generators=gens)
    _assert_same_fit(got, want)
    one = fit_batch("line2d", LINE_CFG, LINE_PARAMS, data, mask, w, [8])
    per_round = LINE_CFG.n_hypotheses
    assert int(one.samples_drawn[0]) == per_round * int(one.rounds_run[0])
    assert int(got.samples_drawn[0]) == 3 * per_round * int(got.rounds_run[0])
    assert int(got.n_models[0]) == 2


def test_replicas_on_two_devices_keep_replica_order():
    """Three replicas on devices that alternate ("cpu", "cpu:0", "cpu":
    two groups, the second replica in the second) give the bits of all
    three on one device: the groups' winners come back in replica order."""
    family = get_family("line2d")
    data, mask, w = _line_scenes(2, seed=6)
    cfg = dataclasses.replace(LINE_CFG, hyp_axis="hyp")

    def fit(hyp_devices):
        gens = [[torch.Generator().manual_seed(100 * r + h) for h in range(3)]
                for r in range(2)]
        return engine.fit_rows(family, cfg, LINE_PARAMS, data, mask, w, generators=gens,
                               hyp_devices=hyp_devices)

    devices = [torch.device("cpu"), torch.device("cpu", 0), torch.device("cpu")]
    reps = engine._Replicas(devices, rows_params(LINE_PARAMS, 2, "cpu"), data, mask, w,
                            torch.zeros(2, data.shape[1], data.shape[1]),
                            *(torch.zeros(2, 3, 1, 4, 2, dtype=torch.long),
                              torch.ones(2, 3, 1, 4, dtype=torch.bool),
                              torch.zeros(2, 3, 0, 4, 2, dtype=torch.long),
                              torch.zeros(2, 3, 0, 4, dtype=torch.bool)))
    assert [g["replicas"] for g in reps.groups] == [[0, 2], [1]]
    assert reps.perm.tolist() == [0, 2, 1]
    _assert_same_fit(fit(devices), fit(None))


def test_fit_batch_restarts_over_a_two_by_two_mesh():
    """F with two restarts a scene on a (2, 2) mesh (tests/test_sharding.py's
    fundamental case): both restarts of a scene sit on its shard, and
    the winner is select_restart's over fit_rows on the same draws."""
    family = get_family("fundamental")
    r = np.random.default_rng(2)
    n = 128
    data = torch.as_tensor(r.uniform(0, 100, (2, n, 4)), dtype=torch.float32)
    mask = torch.ones(2, n, dtype=torch.bool)
    w = torch.ones(2, n)
    cfg = EngineConfig(family="fundamental", n_hypotheses=32, max_rounds=2,
                       pearl_iters=1, icm_sweeps=1, sampler_id=0, n_restarts=2)
    params = make_params(threshold=1.0, confidence=0.9, min_inliers=10, n_valid=n)
    gens = [torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)]
    got = fit_batch(family, cfg, params, data, mask, w, gens, mesh=cpu_mesh(2, 2))
    gens = [torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)]
    rows = engine.fit_rows(
        family, dataclasses.replace(cfg, n_restarts=1, hyp_axis="hyp"), params,
        data.repeat_interleave(2, 0), mask.repeat_interleave(2, 0),
        w.repeat_interleave(2, 0), generators=[[g, g] for g in gens for _ in range(2)])
    for s in range(2):
        energies = rows.energy[2 * s:2 * s + 2].tolist()
        best = engine.select_restart(energies, cfg.restart_rule,
                                     rows.n_models[2 * s:2 * s + 2].tolist())
        assert got.restart[s] == best and got.restart_energies[s] == tuple(energies)
        assert torch.equal(got.labels[s], rows.labels[2 * s + best])
        assert torch.equal(got.descs[s], rows.descs[2 * s + best])
    assert bool(torch.isfinite(got.energy).all())
    with pytest.raises(ValueError, match="generator of its own"):
        fit_batch(family, cfg, params, data, mask, w, [gens[0]] * 2, mesh=cpu_mesh(2))


# The host side of launches from several threads

@pytest.fixture
def fast_switching():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    yield
    sys.setswitchinterval(old)


def test_launch_counts_exact_under_threads(monkeypatch, fast_switching):
    """`_launch` with its C call stubbed, from 8 threads at once: every
    launch is counted, and every row."""
    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(kscoring, "_kernel", lambda name: lambda *args: 0)
    monkeypatch.setattr(kscoring, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    r, n, b = 3, 16, 8
    args = (torch.zeros(r, n, 4), torch.zeros(r, b, 9), torch.zeros(r, n),
            torch.ones(r, n, dtype=torch.bool), torch.ones(r), 2.0,
            torch.zeros(r, dtype=torch.bool), 0)
    name = "score_homography"
    before = (kscoring.LAUNCHES[name], kscoring.ROWS[name])
    n_threads, per_thread = 8, 300

    def work():
        for _ in range(per_thread):
            kscoring._launch(name, *args)

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert kscoring.LAUNCHES[name] - before[0] == n_threads * per_thread
    assert kscoring.ROWS[name] - before[1] == n_threads * per_thread * r


def test_build_loads_a_library_once_under_threads(monkeypatch, fast_switching):
    calls = {"start": 0, "cdll": 0}
    lock = threading.Lock()

    def start(name):
        with lock:
            calls["start"] += 1
        time.sleep(0.05)  # a build in progress while the other threads arrive
        return None

    def cdll(path):
        with lock:
            calls["cdll"] += 1
        return object()

    monkeypatch.setattr(_build, "_start", start)
    monkeypatch.setattr(_build.ctypes, "CDLL", cdll)
    monkeypatch.setattr(_build, "_LIBS", {})
    libs = []
    threads = [threading.Thread(target=lambda: libs.append(_build.load("score_fundamental")))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert calls == {"start": 1, "cdll": 1}
    assert len(libs) == 8 and all(lib is libs[0] for lib in libs)


def test_run_per_device_runs_every_job_and_reraises():
    ran = []

    def job(i):
        ran.append(i)
        if i == 1:
            raise RuntimeError("shard 1 failed")
        time.sleep(0.05)
        return i * 10

    cpu = torch.device("cpu")
    assert _device.run_per_device(job, [(cpu, (0,)), (cpu, (2,))]) == [0, 20]
    ran.clear()
    with pytest.raises(RuntimeError, match="shard 1 failed"):
        _device.run_per_device(job, [(cpu, (i,)) for i in range(4)])
    assert sorted(ran) == [0, 1, 2, 3]
