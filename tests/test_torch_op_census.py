"""tools/op_census.py on the CPU: the operations one eager call launches,
by engine stage and under named functions, on a refit alone and on the
pose cell's own request with its protocol cut for the CPU's time."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from progressivex_tpu_torch.models import pnp as tpnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def oc():
    spec = importlib.util.spec_from_file_location(
        "op_census", os.path.join(ROOT, "tools", "op_census.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _refit_inputs(p=4, n=200, seed=0):
    r = np.random.default_rng(seed)
    X = r.normal(scale=40.0, size=(n, 3))
    xy = X[:, :2] / (X[:, 2:] + 700.0)
    data = torch.from_numpy(np.concatenate([xy, X], 1).astype(np.float32))[None]
    weights = torch.from_numpy(r.random((1, p, n)).astype(np.float32))
    init = torch.tensor([1.0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 690.0]).repeat(1, p, 1)
    return data, weights, init


def test_a_refit_is_all_under_its_function(oc):
    data, weights, init = _refit_inputs()
    specs = ("_refine", "models/pnp.py:_refine", "kernels/pnp.py:refine_plain",
             "models/fundamental.py:_refine", "row_sum")
    res = oc.census(lambda: tpnp._refine(data, weights, init), specs, top=100)
    f = res["functions"]
    assert res["ops"] > 300 and set(res["by_stage"]) == {"other"}
    for spec in specs[:3]:
        assert f[spec]["calls"] == 1 and f[spec]["ops"] == res["ops"]
        assert f[spec]["elements"] == res["elements"]
    assert f["_refine"]["found"] == 2  # the pnp and the fundamental refits
    assert f["models/fundamental.py:_refine"] == {"calls": 0, "ops": 0, "elements": 0,
                                                   "by_stage": {}, "found": 1}
    assert f["row_sum"]["calls"] == 12 and 0 < f["row_sum"]["ops"] < res["ops"]
    top = {op: n for op, n, _ in res["top_ops"]}
    assert top.get("aten._linalg_solve_ex") == 6  # one solve a step


def test_views_and_allocations_are_not_counted(oc):
    x = torch.arange(12.0)

    def views():
        y = x.view(3, 4).transpose(0, 1)[1:]
        torch.empty(5)
        return y.unsqueeze(0)

    assert oc.census(views)["ops"] == 0
    res = oc.census(lambda: (x.view(3, 4) * 2).sum(), ())
    assert res["ops"] == 2 and res["elements"] == 13 and res["functions"] == {}


def test_the_pose_cell_by_stage(oc):
    """The cell's request (1,886 rows at pad 2,304) with one restart and
    64 samples a round: every stage of the fit tagged, the refit inside
    the proposal's LO, the rounds and the final polish."""
    res = oc.cell_census("tless6d-single", 2**33 + 5, 0, ("_refine",),
                         {"n_restarts": 1, "max_iters": 64, "final_polish": 1})
    assert res["calls"] == ["find6DPoses"] and res["device"] == "cpu"
    assert {"prepare", "draw", "round_propose", "finish"} <= set(res["by_stage"])
    assert sum(n for n, _ in res["by_stage"].values()) == res["ops"]
    f = res["functions"]["_refine"]
    assert f["calls"] > 0 and 0 < f["ops"] < res["ops"]
    assert {"round_propose", "finish"} <= set(f["by_stage"])
    assert sum(n for n, _ in f["by_stage"].values()) == f["ops"]
