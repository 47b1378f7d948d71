"""CPU tests of the benchmark's data, its copies of the program's pieces
and its contract with BENCHMARK.json.

  python -m pytest bench_port/tests -q -p no:cacheprovider
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench_port import families, harness, roofline, synth  # noqa: E402

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("problem", ["H", "F"])
def test_generator_copy_draws_the_port_scenes(problem):
    from progressivex_tpu_torch.eval import synth_adelaide as port

    specs = port.H_SPECS if problem == "H" else port.F_SPECS
    gen = port._h_scene if problem == "H" else port._f_scene
    for seed in (0, 7, 2**31 + 5):
        for spec in specs:
            rng = np.random.default_rng(port.scene_seed(problem, spec[0], seed))
            want = gen(rng, *spec[1:])
            family = families.load("homography" if problem == "H" else "fundamental")
            got = synth.draw_scene(family, f"{problem.lower()}_scene", problem, spec, seed)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("config", ["adelaideH", "adelaideF"])
def test_configs_hold_the_port_protocols(config):
    from progressivex_tpu_torch import api
    from progressivex_tpu_torch.core.config import EngineConfig
    from progressivex_tpu_torch.eval import adelaide, synth_adelaide
    from progressivex_tpu_torch.models import get_family

    cfg = json.load(open(os.path.join(ROOT, "bench_port", "configs", f"{config}.json")))
    problem = cfg["problem"]
    protocol = dict(adelaide.H_PROTOCOL if problem == "H" else adelaide.F_PROTOCOL)
    if "split_pass_min_npad" in protocol:
        assert cfg["split_pass_min_npad"] == protocol.pop("split_pass_min_npad")
    assert cfg["protocol"] == protocol
    specs = synth_adelaide.H_SPECS if problem == "H" else synth_adelaide.F_SPECS
    assert [tuple(s) for s in cfg["specs"]] == list(specs)
    assert tuple(cfg["pad_levels"]) == api.PAD_LEVELS
    family = get_family(cfg["family"])
    n_hyp = api._hyp_budget(protocol["max_iters"], family.max_solutions, family.name)
    defaults = EngineConfig(family=family.name)
    assert cfg["work"] == {
        "hypotheses": n_hyp, "solutions": family.max_solutions,
        "subbatches": api._n_subbatches(protocol["max_iters"], n_hyp),
        "lo_steps": defaults.lo_steps, "lo_candidates": defaults.lo_candidates,
        "rounds_max": protocol.get("max_rounds", defaults.max_rounds),
        "magsac_levels": protocol["magsac_levels"]}
    module = importlib.import_module(f"bench_port.families.{cfg['family']}")
    assert module.KERNEL in __import__(
        "progressivex_tpu_torch.kernels.scoring", fromlist=["LAUNCHES"]).LAUNCHES


@pytest.mark.parametrize("config", ["adelaideH", "adelaideF"])
def test_only_the_bundled_rows_are_not_estimated(config):
    """The rows that `estimated_specs` leaves out are the scenes bundled
    under data/, and hold their point count, structure count and outlier
    rate; `assumed` names every estimated row."""
    cfg = json.load(open(os.path.join(ROOT, "bench_port", "configs", f"{config}.json")))
    names = [s[0] for s in cfg["specs"]]
    assert set(cfg["estimated_specs"]) < set(names)
    for name, n, k, rate in cfg["specs"]:
        if name in cfg["estimated_specs"]:
            assert f"{name} {n}/{k}/{rate}" in cfg["assumed"][1]
            continue
        labels = np.loadtxt(os.path.join(ROOT, "data", name, f"{name}.txt"))[:, -1].astype(int)
        assert (len(labels), len(set(labels[labels > 0])), round(float(np.mean(labels == 0)), 2)) \
            == (n, k, rate)


def test_pad_levels_are_the_port_padding():
    from progressivex_tpu_torch import api

    for n in range(4, 7681, 7):
        assert harness.pad_of(n, api.PAD_LEVELS) == api._pad_to(n)


# The lane counts a request's calls reach: pad level -> lanes (the next
# power of two of its scenes), rows = lanes x restarts.
LANES = {
    "adelH-pass": ({128: 8, 256: 32, 384: 32}, {512: 8, 768: 8, 1536: 8, 2304: 16}),
    "adelF-pass": ({256: 32, 384: 32},),
}


@pytest.mark.parametrize("cell_name", CELLS)
def test_traffic_resolves_to_the_stated_calls(cell_name):
    cell = harness.load_cell(cell_name)
    restarts = int(cell.config["protocol"].get("n_restarts", 1))
    if cell.traffic["entry"] == "single":
        n = len(cell.config["specs"])
        shapes = [harness.make_request(cell, 12345, i).scenes[0].shape for i in range(3 * n)]
        for c in range(3):
            assert sorted(shapes[c * n:(c + 1) * n]) == list(range(n))
        assert shapes[:n] != shapes[n:2 * n]
        return
    request = harness.make_request(cell, 2**31 + 11, 0)
    assert len(request.scenes) == len(cell.config["specs"]) * cell.traffic["copies"]
    calls = harness.calls_of(cell, None, request, "cpu")
    assert len(calls) == len(LANES[cell_name])
    for call, want in zip(calls, LANES[cell_name]):
        lanes = {pad: 1 << (len(rows) // restarts - 1).bit_length() for pad, rows in call.groups}
        assert lanes == want
        for pad, rows in call.groups:
            assert all(n <= pad for n in rows)
    if cell_name == "adelF-pass":
        assert all(lanes * restarts == 128 for lanes in LANES[cell_name][0].values())


def test_same_seed_same_requests():
    cell = harness.load_cell("adelH-pass")
    a, b = (harness.make_request(cell, 99, 3) for _ in range(2))
    c = harness.make_request(cell, 100, 3)
    assert a.random_seed == b.random_seed != c.random_seed
    for x, y, z in zip(a.scenes, b.scenes, c.scenes):
        np.testing.assert_array_equal(x.data, y.data)
        assert not np.array_equal(x.data, z.data)


@pytest.mark.parametrize("family,rows,b,n_pad,n_valid,m", [
    ("homography", 1, 256, 2304, 2084, 4), ("homography", 1, 4, 2304, 2084, 4),
    ("homography", 8, 256, 384, 379, 4), ("homography", 4, 256, 2304, 2084, 0),
    ("fundamental", 1, 1536, 256, 187, 4), ("fundamental", 64, 1536, 384, 330, 4),
    ("fundamental", 12, 4090, 512, 400, 0),
])
def test_roofline_count_is_chip_smoke_s(family, rows, b, n_pad, n_valid, m):
    want, _ = _chip_smoke()._score_bound(b, [n_valid] * rows, n_pad, m, family)
    got = roofline.score_bound_s(b, [n_valid] * rows, n_pad, m, family) * 1e3
    assert got == pytest.approx(want, rel=1e-12)


def test_call_bound_counts_what_ran():
    work = {"hypotheses": 256, "solutions": 1, "subbatches": 1, "lo_steps": 2,
            "lo_candidates": 4, "rounds_max": 10, "magsac_levels": 4}
    groups = [(256, [200] * 8), (2304, [2000] * 4)]
    per = [roofline.round_bound_s(work, "homography", v, p) for p, v in groups]
    assert roofline.call_bound_s(work, "homography", groups, 60) == pytest.approx(10 * sum(per))
    # 3 rounds short: taken from the costlier level
    assert roofline.call_bound_s(work, "homography", groups, 51) == pytest.approx(
        10 * per[0] + 7 * per[1])
    assert roofline.call_bound_s(work, "homography", groups, 61) is None
    assert roofline.call_bound_s(work, "homography", groups, 63) is None


def test_every_name_has_its_file():
    bp = os.path.join(ROOT, "bench_port")
    for c in BENCH["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("bench_port/")
        assert json.load(open(os.path.join(ROOT, c["file"])))["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert os.path.isfile(os.path.join(bp, "traffic", f"{w['traffic']}.json"))
        assert os.path.isfile(os.path.join(bp, "checks", f"{w['name']}.json"))
    for m in BENCH["per_layer"]:
        assert os.path.isfile(os.path.join(bp, "metrics", f"{m['name']}.py"))
    files = {os.path.splitext(f)[0] for f in os.listdir(os.path.join(bp, "metrics"))}
    assert {m["name"] for m in BENCH["per_layer"]} <= files


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"] and 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in names and len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS)
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in BENCH["end_to_end"] + BENCH["per_layer"] + BENCH["configs"] + BENCH["workloads"]:
        assert NAME.match(m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_run_loads_no_jax():
    """What run.py loads, the program's package, the readers and the
    families with it: no module whose top-level name is jax, jaxlib, flax
    or progressivex_tpu (compared whole: progressivex_tpu_torch is not
    progressivex_tpu)."""
    code = (
        "import importlib, os, sys; sys.path.insert(0, %r)\n"
        "sys.argv = ['run.py']\n"
        "import runpy; mod = runpy.run_path(%r, run_name='not_main')\n"
        "from bench_port import harness, control\n"
        "import progressivex_tpu_torch, progressivex_tpu_torch.core.graphs\n"
        "for d in ('metrics', 'families'):\n"
        "    for f in os.listdir(os.path.join(%r, 'bench_port', d)):\n"
        "        if f.endswith('.py'): importlib.import_module(f'bench_port.{d}.{f[:-3]}')\n"
        "print(harness.banned_modules())\n"
    ) % (ROOT, os.path.join(ROOT, "bench_port", "run.py"), ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"
    assert harness.BANNED == ("jax", "jaxlib", "flax", "progressivex_tpu")
    sys.modules.setdefault("progressivex_tpu_torch_fake", object())
    assert "progressivex_tpu_torch_fake" not in harness.banned_modules()
