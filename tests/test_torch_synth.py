"""The port's dataset pass against the JAX package's harness, on the CPU:
the synthetic full-cardinality datasets (`eval/synth_adelaide`), the
bucket sizes and lane plan (`eval/adelaide._bucket_size`, `lane_plan`
against `_prepare_lane_batches`), and `throughput_batch`,
`throughput_all`, `dataset_pass_seconds`, `evaluate_scenes` and
`cli.eval_main` on a two-scene synthetic root.

- The scene generators equal the JAX functions exactly for the same
  `np.random.default_rng`.
- The port's dataset files are the same bytes in two processes with
  different string-hash seeds (the JAX module seeds each scene with
  Python's per-process `hash`).
- `physics` (106 points) pads to 256 in the dataset pass, the JAX
  package's batched floor, not to the single-scene level 128.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from progressivex_tpu.eval import adelaide as jadelaide
from progressivex_tpu.eval import synth_adelaide as jsynth

from progressivex_tpu_torch import cli
from progressivex_tpu_torch.eval import adelaide, synth_adelaide

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RESULT_KEYS = {"problem", "full_dataset", "n_scenes", "mean_me", "per_scene"}


@pytest.mark.parametrize("problem,spec", [
    ("H", 0), ("H", 1), ("H", 15), ("F", 0), ("F", 4), ("F", 14)])
def test_scene_generators_equal_jax(problem, spec):
    specs = synth_adelaide.H_SPECS if problem == "H" else synth_adelaide.F_SPECS
    assert specs == (jsynth.H_SPECS if problem == "H" else jsynth.F_SPECS)
    name, n, k, rate = specs[spec]
    gen = "_h_scene" if problem == "H" else "_f_scene"
    got = getattr(synth_adelaide, gen)(np.random.default_rng(7 + spec), n, k, rate)
    want = getattr(jsynth, gen)(np.random.default_rng(7 + spec), n, k, rate)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _write(root, hash_seed):
    code = ("import sys; from progressivex_tpu_torch.eval.synth_adelaide import "
            "ensure_synth_dataset as e; [e(p, root=sys.argv[1]) for p in 'HF']")
    env = dict(os.environ, PYTHONHASHSEED=str(hash_seed), PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code, str(root)], check=True, env=env)


def test_dataset_is_the_same_in_every_process(tmp_path):
    _write(tmp_path / "a", 1)
    _write(tmp_path / "b", 2)
    for problem, specs in (("H", synth_adelaide.H_SPECS), ("F", synth_adelaide.F_SPECS)):
        for name, n, *_ in specs:
            rel = os.path.join(f"synth_adelaide{problem}", name, f"{name}.txt")
            a = (tmp_path / "a" / rel).read_bytes()
            assert a == (tmp_path / "b" / rel).read_bytes(), rel
            if problem == "H":  # F drops points that leave the frame
                assert a.count(b"\n") == n, rel
    root, names, full = adelaide.discover_scenes("H", str(tmp_path / "a" / "synth_adelaideH"))
    assert full and len(names) == 19 and names == sorted(s[0] for s in synth_adelaide.H_SPECS)


def test_bucket_size_equals_jax():
    for allowed in (None, {384, 2304}, {256}, {512, 768}):
        got = [adelaide._bucket_size(n, allowed) for n in range(1, 8001)]
        want = [jadelaide._bucket_size(n, allowed) for n in range(1, 8001)]
        assert got == want, allowed
    assert adelaide._bucket_size(106) == 256


@pytest.fixture(scope="module")
def synth_roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("synth")
    return {p: synth_adelaide.ensure_synth_dataset(p, root=str(base)) for p in "HF"}


@pytest.mark.parametrize("problem", ["H", "F"])
@pytest.mark.parametrize("lane_target,allowed", [
    (1, None), (None, None), (4, None), (None, {384, 2304}), (1, {256})])
def test_lane_plan_equals_jax(synth_roots, problem, lane_target, allowed):
    """n_pad, lanes, rows, the split gate and the scenes of every batch,
    against the JAX package's `_prepare_lane_batches` (which builds the
    batches' arrays and jit wrappers but compiles nothing)."""
    root = synth_roots[problem]
    jbatches, jfull = jadelaide._prepare_lane_batches(problem, root, 0, lane_target,
                                                      allowed)
    _, names, full = adelaide.discover_scenes(problem, root)
    sizes = [len(adelaide.load_corr_scene(n, root=root)[1]) for n in names]
    plan = adelaide.lane_plan(problem, sizes, lane_target, allowed)
    assert full and jfull
    assert len(plan) == len(jbatches)
    for b, jb in zip(plan, jbatches):
        assert (b.n_pad, b.lanes, b.n_restarts, b.rows) == (jb.n_pad, jb.lanes,
                                                            jb.n_restarts, jb.ns)
        assert b.split_pass == jb._build_args[1].split_pass
        assert b.scenes == tuple(jb._build_args[5])
        assert b.lane_ids == tuple(jb.lane_ids)


@pytest.fixture(scope="module")
def two_scene_root(tmp_path_factory, synth_roots):
    """physics (106 points) and ladysymon (217), both in the 256 bucket."""
    root = tmp_path_factory.mktemp("two") / "synth_adelaideH"
    for name in ("physics", "ladysymon"):
        os.makedirs(root / name)
        with open(os.path.join(synth_roots["H"], name, f"{name}.txt"), "rb") as f:
            (root / name / f"{name}.txt").write_bytes(f.read())
    return str(root)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_throughput_all_on_cpu(two_scene_root, one_thread):
    out, warm_s = adelaide.throughput_all("H", root={"H": two_scene_root},
                                          n_timing_runs=1, lane_target=1, device="cpu")
    r = out["H"]
    assert r.full_dataset and r.n_distinct == 2 and r.n_scenes == 2
    assert [(b["n_pad"], b["lanes"], b["rows"]) for b in r.buckets] == [(256, 2, 2)]
    assert r.buckets[0]["launches"] == 0  # the CPU takes the plain scorer
    assert np.isfinite(r.mean_me) and 0.0 <= r.mean_me <= 0.08
    assert r.pass_seconds == pytest.approx(r.buckets[0]["best_s"])
    assert r.scenes_per_sec == pytest.approx(2 / r.pass_seconds)
    assert warm_s > 0 and r.compile_seconds == warm_s


def test_throughput_batch_and_pass_seconds_on_cpu(two_scene_root, one_thread, monkeypatch):
    r = adelaide.throughput_batch("H", root=two_scene_root, n_timing_runs=1,
                                  lane_target=1, device="cpu")
    assert r.full_dataset and r.n_distinct == 2 and r.buckets[0]["n_pad"] == 256
    assert r._fields == jadelaide.ThroughputResult._fields
    seen = {}

    def fake(problem, **kw):
        seen.update(kw, problem=problem)
        return r

    monkeypatch.setattr(adelaide, "throughput_batch", fake)
    assert adelaide.dataset_pass_seconds("H", root=two_scene_root, device="cpu") == (
        r.pass_seconds, 2, r.compile_seconds)
    assert seen["root"] == two_scene_root and seen["n_timing_runs"] == 3


def test_eval_main_on_cpu(two_scene_root, one_thread, capsys):
    res = cli.main(["eval", "--problem", "H", "--root", two_scene_root,
                    "--device", "cpu"])
    assert set(res) == JAX_RESULT_KEYS
    assert res["problem"] == "H" and res["full_dataset"] and res["n_scenes"] == 2
    assert set(res["per_scene"]) == {"physics", "ladysymon"}
    for v in res["per_scene"].values():
        assert {"me", "time_s", "n"} <= set(v) and 0.0 <= v["me"] <= 0.2
    assert res["per_scene"]["physics"]["n"] == 106
    printed = capsys.readouterr().out
    assert '"full_dataset": true' in printed


def test_discover_scenes_falls_back_to_bundled(tmp_path):
    root, names, full = adelaide.discover_scenes("F", str(tmp_path))
    assert not full and names == ["book", "breadcube", "cubetoy"]
    assert adelaide.discover_scenes("h")[1] == ["oldclassicswing", "unihouse", "unionhouse"]
