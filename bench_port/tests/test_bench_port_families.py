"""A model family brings its own files: CPU tests of the family contract
(bench_port/families/__init__.py).

(a) A stub family, registered as a module and nothing else, is drawn,
    called, judged and read through the generic harness: 2D-3D rows
    [n, 5] with a per-scene K, entry points that take (x1y1, x2y2z2, K),
    answers of [3K, 4] poses, no scoring kernel.
(b) The existing cells read as before: their draws, the reference's
    numbers on a fixed answer and the roofline bound of a traced call,
    pinned to what the benchmark computed before families carried them.
(c) The generic modules name no family and no generator.

  python -m pytest bench_port/tests -q -p no:cacheprovider
"""

import ast
import hashlib
import os
import sys
import types

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench_port import families, harness, reference, roofline  # noqa: E402
from bench_port.metrics import score_roofline_pct  # noqa: E402

BP = os.path.join(ROOT, "bench_port")

# --- (a) a stub family ----------------------------------------------------

STUB = "stub_pose"


def _pose_scene(rng, n, k, outlier_rate):
    """k rigid objects before one calibrated camera: rows [n, 5] (x, y of
    the image point, X, Y, Z of the object point) and the camera's K,
    with uniform outliers. The true poses and labels ride along for the
    fake program, keyed by the scene's checksum."""
    n_out = int(round(n * outlier_rate))
    sizes = np.full(k, (n - n_out) // k)
    sizes[:(n - n_out) - sizes.sum()] += 1
    f = rng.uniform(500, 700)
    cam = np.array([[f, 0, 320.0], [0, f, 240.0], [0, 0, 1.0]])
    rows, labels, poses = [], [], []
    for j, sz in enumerate(sizes):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        rot = q * np.sign(np.linalg.det(q))
        t = np.array([rng.uniform(-1, 1), rng.uniform(-0.8, 0.8), rng.uniform(5, 8)])
        x3 = rng.uniform(-0.5, 0.5, (sz, 3))
        p = (x3 @ rot.T + t) @ cam.T
        rows.append(np.concatenate([p[:, :2] / p[:, 2:] + rng.normal(scale=0.3, size=(sz, 2)),
                                    x3], 1))
        labels.append(np.full(sz, j + 1, np.int32))
        poses.append(np.concatenate([rot, t[:, None]], 1))
    rows.append(np.concatenate([rng.uniform(0, 640, (n_out, 1)), rng.uniform(0, 480, (n_out, 1)),
                                rng.uniform(-0.5, 0.5, (n_out, 3))], 1))
    labels.append(np.zeros(n_out, np.int32))
    data, gt = (np.concatenate(rows), cam), np.concatenate(labels)
    _TRUTH[harness.data_sum(data)] = (np.concatenate(poses), np.where(gt == 0, k, gt - 1))
    return data, gt


_TRUTH = {}


def _points(data, dtype, mask=None):
    import torch

    rows = torch.as_tensor(np.asarray(data[0], np.float64))
    if mask is not None:
        rows = rows[torch.as_tensor(mask)]
    return rows.to(dtype), torch.as_tensor(np.asarray(data[1], np.float64)).to(dtype)


def _squared_residual(models, points):
    """models [M, 3, 4] poses [R | t] -> [M, n] squared reprojection error."""
    rows, cam = points
    p = (rows[None, :, 2:] @ models[:, :, :3].transpose(1, 2) + models[:, None, :, 3]) @ cam.T
    d = p[..., :2] / p[..., 2:] - rows[None, :, :2]
    return (d * d).sum(-1)


def _refit(points, dtype):
    """The pose of the rows by DLT on normalized image points, rotated to
    the nearest rotation; [3, 4] float64."""
    import torch

    rows, cam = points
    rows, cam = rows.to(dtype), cam.to(dtype)
    xn = torch.cat([rows[:, :2], torch.ones_like(rows[:, :1])], 1) @ torch.linalg.inv(
        cam.double()).to(dtype).T
    u, v = xn[:, 0:1], xn[:, 1:2]
    xh = torch.cat([rows[:, 2:], torch.ones_like(rows[:, :1])], 1)
    zero = torch.zeros_like(xh)
    a = torch.cat([torch.cat([xh, zero, -u * xh], 1), torch.cat([zero, xh, -v * xh], 1)])
    p = families.null_vector(a).reshape(3, 4)
    p = p * torch.sign(torch.linalg.det(p[:, :3]))
    uu, s, vt = torch.linalg.svd(p[:, :3])
    return torch.cat([uu @ vt, (p[:, 3] / s.mean())[:, None]], 1)


def _model_distance(a, b, points):
    import torch

    rows, cam = points
    ra, rb = (torch.sqrt(_squared_residual(m[None], (rows, cam))[0]) for m in (a, b))
    return float(torch.sqrt(((ra - rb) ** 2).mean()))


def _stub_family():
    m = types.ModuleType(f"bench_port.families.{STUB}")
    m.ENTRY_SINGLE, m.ENTRY_BATCHED = "findStubPoses", "findStubPosesBatched"
    m.GENERATORS = {"pose_rows": _pose_scene}
    m.single_args = lambda data: (data[0][:, :2], data[0][:, 2:], data[1])
    m.batched_args = lambda datas: ([d[0][:, :2] for d in datas], [d[0][:, 2:] for d in datas],
                                    [d[1] for d in datas])
    m.MODEL_SHAPE = (3, 4)
    m.points, m.squared_residual, m.refit, m.model_distance = (
        _points, _squared_residual, _refit, _model_distance)
    m.REFIT_MIN = 8
    m.KERNEL = None
    return m


class FakeProgram:
    """The program's place: records each call and answers with the true
    poses [3K, 4] and labels (K for an outlier) of the scene it is given."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _answer(x1y1, x2y2z2, cam):
        return _TRUTH[harness.data_sum((np.concatenate([x1y1, x2y2z2], 1), cam))]

    def findStubPoses(self, x1y1, x2y2z2, cam, **kw):
        self.calls.append(("single", (x1y1.shape, x2y2z2.shape, cam.shape), kw))
        return (*self._answer(x1y1, x2y2z2, cam), types.SimpleNamespace(rounds_run=3))

    def findStubPosesBatched(self, x1y1s, x2y2z2s, cams, **kw):
        self.calls.append(("batched", ([x.shape for x in x1y1s], [x.shape for x in x2y2z2s],
                                       [c.shape for c in cams]), kw))
        return [self._answer(*a) for a in zip(x1y1s, x2y2z2s, cams)]


@pytest.fixture
def stub(monkeypatch):
    monkeypatch.setitem(sys.modules, f"bench_port.families.{STUB}", _stub_family())
    return families.load(STUB)


def _stub_cell(entry):
    config = {"family": STUB, "problem": "P", "generator": "pose_rows",
              "specs": [["two", 70, 2, 0.2], ["three", 150, 3, 0.3]],
              "protocol": {"threshold": 2.0, "conf": 0.9}, "pad_levels": [128, 256]}
    traffic = {"entry": entry, "copies": 2, "pool_requests": 2, "warm_passes": 1,
               "trace_requests": 1, "check_per_shape": 2}
    checks = {"compare": {"me_mean_pct": {"limit": 1.0}, "gap_mean_pct": {"limit": 5.0},
                          "model_gap_median_px": {"limit": 2.0}}}
    return harness.Cell(f"stub-{entry}", config, traffic, checks,
                        [{"name": "scenes_per_s", "unit": "scenes/s"}],
                        [{"name": "score_roofline_pct", "unit": "%"}])


@pytest.mark.parametrize("entry", ["single", "batched"])
def test_stub_family_plugs_in_as_a_module(stub, entry):
    import torch

    cell = _stub_cell(entry)
    request = harness.make_request(cell, 2**31 + 3, 0)
    for s in request.scenes:
        rows, cam = s.data
        assert rows.shape == (len(s.gt), 5) and cam.shape == (3, 3)
    program = FakeProgram()
    calls = harness.calls_of(cell, program, request, "cpu")
    answers = [a for c in calls for a in c.run()[0]]
    kind, shapes, kw = program.calls[-1]
    assert kind == entry and len(answers) == len(request.scenes)
    n = [len(s.gt) for s in request.scenes]
    want = ((n[0], 2), (n[0], 3), (3, 3))
    if entry == "batched":
        want = ([(k, 2) for k in n], [(k, 3) for k in n], [(3, 3)] * len(n))
    assert shapes == want
    assert {"threshold", "conf", "random_seed", "device"} <= set(kw)
    for s, (models, labels) in zip(request.scenes, answers):
        judged = reference.judge(stub, s.data, s.gt, models, labels, 2.0)
        assert judged.me == 0.0 and judged.n_models == int(s.gt.max())
        assert max(judged.model_gaps) < 2.0  # px: the DLT of 0.3 px noise, not the truth
        # an answer of 3 x 3 models is not this family's
        assert reference.judge(stub, s.data, s.gt, models[:, :3], labels, 2.0) is None
    result, _ = harness.run_cell(cell, 2**31 + 5, 0.0, False, "cpu", program=FakeProgram())
    assert result["correct"], result["checks"]
    window = harness.run_window(cell, FakeProgram(), harness.Pool(cell, 9, 2), 0.0,
                                torch.device("cpu"), False)
    traced = window._replace(summary=types.SimpleNamespace(ops={}),
                             traced_calls=[(STUB, [(128, [70])], 0)])
    assert score_roofline_pct.read(harness.Readings(cell, traced, [], 1.0)) is None


@pytest.mark.parametrize("settle_s", [None, 0.05])
def test_settling_serves_the_pool_before_the_window(stub, settle_s):
    cell = _stub_cell("single")
    if settle_s is not None:
        cell = cell._replace(traffic=dict(cell.traffic, settle_seconds=settle_s))
    program, seed = FakeProgram(), 2**31 + 7
    result, lines = harness.run_cell(cell, seed, 0.0, False, "cpu", program=program)
    assert result["correct"], result["checks"]
    seeds = [kw["random_seed"] for _, _, kw in program.calls]
    # two warm-up calls (one a pad level), the settling, one window request
    settled = len(seeds) - 3
    assert f"{settled} requests settling" in lines[0]
    assert settled == 0 if settle_s is None else settled > 0
    assert seeds[-1] == harness._crc(f"{seed}/0/random_seed") & 0x7FFFFFFF
    assert seeds[-1] not in seeds[2:-1] and len(set(seeds[2:-1])) == settled


# --- (b) the existing cells read as before --------------------------------

SEEDS = (2**31 + 101, 7)
CELLS = ("adelH-pass", "adelF-pass", "adelH-single")
# Computed by the benchmark before the families carried their generators,
# entry arguments, model shape and roofline constants.
DRAWS = {
    ("adelH-pass", SEEDS[0]): "c8111a630b423cbba5142131027873b9c240f7370c1fbe60b1bb2ba02443188c",
    ("adelH-pass", 7): "19b22c9e9389a6292e2bd0979bcde2a0730690f406d9e2281f9e981795b0ec6c",
    ("adelF-pass", SEEDS[0]): "1d6501f6b30bfadb4a0d18c260574295cb96ea3cd3fbf72e0cc3f1809bb62306",
    ("adelF-pass", 7): "140a5c62e90105fe7aa54e62bd9b498c782002d6bce6a5f595f47f301fc9b7ee",
    ("adelH-single", SEEDS[0]): "2661909cbfd275806172d7251bb7c17268d3c63156df7c447c434114acde5436",
    ("adelH-single", 7): "6f66296b07152e6d5f4958064a1c26a69d01ea090a9c3521a45c54cc167f2716",
}
BOUNDS = {"adelH-pass": [3.269029970149254e-05, 7.593252358208955e-05],
          "adelF-pass": [0.0004411762860895522],
          "adelH-single": [3.9567868656716416e-07]}
JUDGED = {
    ("adelH-single", "judge"): [0.1428571428571429, 0.14285714285714285, 0.0967741935483871,
                                [0.04496852856642041, 0.1268195969553363], 2],
    ("adelH-single", "control"): [0.009216589861751112, 0.009216589861751152, 0.0,
                                  [0.22636955017960556, 0.2560974785188354], 2],
    ("adelF-pass", "judge"): [0.1454545454545455, 0.14545454545454545, 0.07878787878787878,
                              [0.05550578743065614], 1],
    ("adelF-pass", "control"): [0.1636363636363637, 0.15454545454545454, 0.0,
                                [0.14269692456103006], 1],
}


def draws_digest(cell, seed):
    """A digest of requests 0-2 and warm-up passes 0-1 of a run of `seed`:
    each scene's shape, data and labels, each request's random_seed."""
    h = hashlib.sha256()
    requests = [harness.make_request(cell, seed, i) for i in range(3)]
    requests += [r for p in range(2) for r in harness.warm_requests(cell, seed, p)]
    for r in requests:
        h.update(f"{r.index}/{r.random_seed}/{len(r.scenes)}".encode())
        for s in r.scenes:
            h.update(str(s[0]).encode())
            h.update(np.ascontiguousarray(s[1], np.float64).tobytes())
            h.update(np.ascontiguousarray(s[2], np.int32).tobytes())
    return h.hexdigest()


def traced_bounds(cell):
    """roofline.call_bound_s of each call of request 0 of SEEDS[0], as the
    harness records a traced call (family, groups, launches), every pad
    level but one round short of `rounds_max`."""
    work = cell.config["work"]
    per_round = work["subbatches"] + work["lo_steps"]
    request = harness.make_request(cell, SEEDS[0], 0)
    return [roofline.call_bound_s(work, cell.config["family"], c.groups,
                                  per_round * (work["rounds_max"] * len(c.groups) - 1))
            for c in harness.calls_of(cell, None, request, "cpu")]


def fixed_answer_numbers(cell, judge):
    """`judge`'s reading of one fixed answer to scene 0 of request 0 of
    SEEDS[0]: the float64 refit of each true structure, rounded to
    float32, with every seventh label moved to the next class."""
    import torch

    family, scene = cell.family, harness.make_request(cell, SEEDS[0], 0).scenes[0]
    data, gt = scene[1], scene[2]
    k = int(gt.max())
    rows = torch.as_tensor(np.asarray(data, np.float64))
    models = np.stack([family.refit(rows[torch.as_tensor(gt == j)], torch.float64).numpy()
                       for j in range(1, k + 1)]).astype(np.float32).reshape(-1, 3)
    labels = np.where(gt == 0, k, gt - 1)
    labels[::7] = (labels[::7] + 1) % (k + 1)
    j = judge(family, data, gt, models, labels, cell.config["protocol"]["threshold"])
    return [j.me, j.gap, j.gross, list(j.model_gaps), j.n_models]


@pytest.mark.parametrize("name,seed", list(DRAWS))
def test_draws_are_the_parents(name, seed):
    assert draws_digest(harness.load_cell(name), seed) == DRAWS[(name, seed)]


@pytest.mark.parametrize("name", CELLS)
def test_roofline_bound_is_the_parents(name):
    assert traced_bounds(harness.load_cell(name)) == pytest.approx(BOUNDS[name], rel=1e-12)


@pytest.mark.parametrize("name,kind", [(c, k) for c in ("adelH-single", "adelF-pass")
                                       for k in ("judge", "control")])
def test_judged_numbers_are_the_parents(name, kind):
    got = fixed_answer_numbers(harness.load_cell(name), getattr(reference, kind))
    want = JUDGED[(name, kind)]
    assert got[4] == want[4] and len(got[3]) == len(want[3])
    assert got[:3] + got[3] == pytest.approx(want[:3] + want[3], rel=1e-9, abs=1e-15)


# --- (c) the generic modules name no family ---------------------------------

GENERIC = ["harness.py", "synth.py", "reference.py", "control.py", "recorder.py", "tracing.py",
           "roofline.py", "run.py"] + sorted(
    f"metrics/{f}" for f in os.listdir(os.path.join(BP, "metrics")) if f.endswith(".py"))


def _family_words():
    names = {f[:-3] for f in os.listdir(os.path.join(BP, "families"))
             if f.endswith(".py") and f != "__init__.py"}
    generators = {g for name in names for g in families.load(name).GENERATORS}
    return names | generators


@pytest.mark.parametrize("path", GENERIC)
def test_generic_module_names_no_family(path):
    words = _family_words()
    assert {"homography", "fundamental", "h_scene", "f_scene"} <= words
    tree = ast.parse(open(os.path.join(BP, path)).read())
    named = {node.value for node in ast.walk(tree)
             if isinstance(node, ast.Constant) and node.value in words}
    assert not named, f"{path} names {sorted(named)}"
