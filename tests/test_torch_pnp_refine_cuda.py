"""The pose family's Gauss-Newton refit kernel (csrc/pnp_refine.cu) on the
card against its plain torch version on the same CUDA tensors, its
counts, its capture in a CUDA graph, and its place in a pose fit.

These tests need a CUDA device and nvcc. They import neither JAX nor the
JAX package (tests/test_torch_pnp.py holds the plain version to the JAX
package's on the CPU):

  python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_pnp_refine_cuda.py

Elsewhere they skip. Tolerance: a refit's validity must be equal, and a
returned start bit for bit; a refitted pose within R_ATOL on each entry
of R and T_RTOL * |t| on t. Each point's terms are the plain version's
operations, but the kernel sums H's upper triangle and g over the points
in its own order (the plain version pairs the padded point axis in
`row_sum`'s tree and rounds H's lower triangle separately), and solves the
6x6 system by its own LU where the plain version calls cuBLAS's: the last
bits of each step's sums and solve differ, and six steps carry them into
the pose. Non-finite entries must lie exactly where the plain version's
do.
"""

import numpy as np
import pytest
import torch

from progressivex_tpu_torch.kernels import _build
from progressivex_tpu_torch.kernels import pnp as kpnp

R_ATOL = 1e-4
T_RTOL = 1e-4
# The cell whose request the pose fit draws, and that request's seed.
CELL, SEED = "tless6d-single", 2**33 + 5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def pose_fit():
    """One eager find6DPoses on the card on the cell's request, under the
    cell's protocol: every refit's inputs (flattened as the kernel takes
    them), the number of _refine calls, the kernel's launches and problems
    counted, and whether the plain version ever ran on a CUDA tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    import progressivex_tpu_torch as px
    from bench_port import harness
    from progressivex_tpu_torch.core import graphs

    cell = harness.load_cell(CELL)
    request = harness.make_request(cell, SEED, 0)
    scene, = request.scenes
    seen = {"calls": 0, "plain_on_card": 0, "inputs": []}
    orig, orig_cuda, orig_plain = kpnp.refine, kpnp.refine_cuda, kpnp.refine_plain

    def refine(*args, **kw):
        seen["calls"] += 1
        return orig(*args, **kw)

    def refine_cuda(data, weights, init_desc, n_iters=6):
        seen["inputs"].append((data.clone(), weights.clone(), init_desc.clone()))
        return orig_cuda(data, weights, init_desc, n_iters)

    def refine_plain(data, *args, **kw):
        seen["plain_on_card"] += data.device.type == "cuda"
        return orig_plain(data, *args, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(kpnp, "refine", refine)
    mp.setattr(kpnp, "refine_cuda", refine_cuda)
    mp.setattr(kpnp, "refine_plain", refine_plain)
    for counts in (_build.LAUNCHES, _build.UNITS):
        mp.setitem(counts, "pnp_refine", 0)
    try:
        graphs.clear()
        with graphs.eager():
            px.find6DPoses(*cell.family.single_args(scene.data), **cell.config["protocol"],
                           random_seed=request.random_seed, device="cuda")
        torch.cuda.synchronize()
        seen["launches"] = _build.LAUNCHES["pnp_refine"]
        seen["problems"] = _build.UNITS["pnp_refine"]
    finally:
        mp.undo()
    return seen


def _compare(got, want):
    """Hold the kernel's (descs [..., 12], ok) to the plain version's."""
    (gd, gok), (wd, wok) = got, want
    assert gd.shape == wd.shape and gok.shape == wok.shape and gok.dtype == torch.bool
    assert torch.equal(gok, wok)
    assert torch.equal(torch.isfinite(gd), torch.isfinite(wd))
    bad = ~wok
    assert torch.equal(gd[bad].nan_to_num().view(torch.int32),
                       wd[bad].nan_to_num().view(torch.int32))
    g = gd[wok].reshape(-1, 3, 4).double()
    w = wd[wok].reshape(-1, 3, 4).double()
    if not len(g):
        return 0.0, 0.0
    r_err = float((g[..., :3] - w[..., :3]).abs().max())
    t_err = float(((g[..., 3] - w[..., 3]).norm(dim=-1)
                   / w[..., 3].norm(dim=-1).clamp(min=1e-30)).max())
    assert r_err <= R_ATOL and t_err <= T_RTOL, (r_err, t_err)
    return r_err, t_err


def _rotation(r, angle):
    axis = r.normal(size=3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _problem(rows, p, n, seed):
    """float32 data [rows, n, 5]: object points (mm) about 700 mm before a
    camera, observed through a pose with noise in normalized coordinates,
    a fifth of them outliers; weights [rows, p, n] falling with each
    point's residual at the pose, as a PEARL weight does, with zeros;
    starts [rows, p, 12] off the pose by up to 3 degrees and 10 mm."""
    r = np.random.default_rng(seed)
    data = np.empty((rows, n, 5))
    weights = np.empty((rows, p, n))
    inits = np.empty((rows, p, 12))
    for i in range(rows):
        R, t = _rotation(r, r.uniform(0, np.pi)), np.array([0.0, 0.0, 700.0])
        X = r.normal(scale=40.0, size=(n, 3))
        cam = X @ R.T + t
        xy = cam[:, :2] / cam[:, 2:] + r.normal(scale=1e-3, size=(n, 2))
        out = r.random(n) < 0.2
        xy[out] = r.uniform(-0.1, 0.1, size=(out.sum(), 2))
        data[i] = np.concatenate([xy, X], 1)
        r2 = ((xy - cam[:, :2] / cam[:, 2:]) ** 2).sum(1) / (4e-3) ** 2
        for k in range(p):
            weights[i, k] = np.maximum(1.0 - r2, 0.0) * (r.random(n) < 0.9)
            R0 = _rotation(r, r.uniform(0, np.radians(3))) @ R
            inits[i, k] = np.concatenate([R0, (t + r.normal(scale=5.0, size=3))[:, None]],
                                         1).reshape(12)
    return tuple(torch.from_numpy(x.astype(np.float32)) for x in (data, weights, inits))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [4, 8, 10])
def test_kernel_matches_plain_on_the_cells_refits(cuda, pose_fit, p):
    """Every refit of the cell's pose fit at P instances, as the fit gave
    it to the kernel ([3, P, 2304]), on both versions."""
    calls = [c for c in pose_fit["inputs"] if c[1].shape[1] == p]
    assert calls, sorted({c[1].shape[1] for c in pose_fit["inputs"]})
    for data, weights, inits in calls:
        assert data.shape == (3, 2304, 5)
        _compare(kpnp.refine_cuda(data, weights, inits),
                 kpnp.refine_plain(data, weights, inits))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 300, 2304, 7680, 9300])
def test_kernel_matches_plain_at_each_point_count(cuda, n):
    """Pad levels (128, 2304, 7680: the points in shared memory), a count
    that is none (300), and one past the shared-memory limit (9300: the
    points read from device memory)."""
    data, weights, inits = (x.to(cuda) for x in _problem(3, 4, n, n))
    got = kpnp.refine_cuda(data, weights, inits)
    _compare(got, kpnp.refine_plain(data, weights, inits))
    assert bool(got[1].all())


@pytest.mark.cuda
def test_invalid_refits_return_their_start(cuda):
    """All-zero weights, two positive weights, negative and NaN weights,
    a NaN start, an inf start: the start back and `ok` false, as in the
    plain version. Every point behind the camera under one start, and 50
    points of the row behind it under every start: refitted where the
    plain version refits."""
    data, weights, inits = _problem(2, 8, 2304, 1)
    weights[0, 0] = 0.0
    weights[0, 1, 2:] = 0.0
    weights[0, 2] = -weights[0, 2]
    weights[0, 3, 5] = float("nan")
    inits[0, 4, 2] = float("nan")
    inits[0, 5, 7] = float("inf")
    inits[0, 6, 11] = -700.0  # every point behind the camera
    pose = inits[0, 7].reshape(3, 4)
    jitter = torch.rand(50, 3, generator=torch.Generator().manual_seed(0))
    behind = torch.tensor([0.0, 0.0, -200.0]) + 50.0 * jitter - 25.0
    data[0, :50, 2:] = (behind - pose[:, 3]) @ pose[:, :3]  # R^T (c - t)
    data, weights, inits = data.to(cuda), weights.to(cuda), inits.to(cuda)
    got = kpnp.refine_cuda(data, weights, inits)
    want = kpnp.refine_plain(data, weights, inits)
    _compare(got, want)
    assert not bool(got[1][0, :6].any()) and bool(got[1][0, 6:].all())
    assert bool(got[1][1].all())
    assert torch.equal(got[0][0, :4], inits[0, :4])
    assert torch.equal(got[0][0, 6], inits[0, 6])


@pytest.mark.cuda
def test_a_row_alone_is_bit_for_bit_the_row_in_a_batch(cuda):
    data, weights, inits = (x.to(cuda) for x in _problem(3, 10, 2304, 2))
    all_rows = kpnp.refine_cuda(data, weights, inits)
    one = kpnp.refine_cuda(data[1:2].contiguous(), weights[1:2].contiguous(),
                           inits[1:2].contiguous())
    assert torch.equal(one[0][0].view(torch.int32), all_rows[0][1].view(torch.int32))
    assert torch.equal(one[1][0], all_rows[1][1])
    again = kpnp.refine_cuda(data, weights, inits)
    assert torch.equal(again[0].view(torch.int32), all_rows[0].view(torch.int32))


@pytest.mark.cuda
def test_routing_flattens_the_middle_axes(cuda, monkeypatch):
    """models/pnp._refine on CUDA tensors with two middle axes and with no
    row axis: one launch each, of the flattened problems, the shapes of
    the plain version's results."""
    from progressivex_tpu_torch.models import pnp as tpnp

    for counts in (_build.LAUNCHES, _build.UNITS):
        monkeypatch.setitem(counts, "pnp_refine", 0)
    data, weights, inits = (x.to(cuda) for x in _problem(2, 6, 384, 3))
    w4, i4 = weights.reshape(2, 2, 3, 384), inits.reshape(2, 2, 3, 12)
    got = tpnp._refine(data, w4, i4)
    _compare(got, kpnp.refine_plain(data, w4, i4))
    got = tpnp._refine(data[0], weights[0], inits[0])
    _compare(got, kpnp.refine_plain(data[0], weights[0], inits[0]))
    assert _build.LAUNCHES["pnp_refine"] == 2 and _build.UNITS["pnp_refine"] == 18


@pytest.mark.cuda
def test_what_the_kernel_does_not_take_raises(cuda):
    data, weights, inits = (x.to(cuda) for x in _problem(1, 4, 128, 4))
    for args in ((data.double(), weights, inits), (data[..., :4], weights, inits),
                 (data, weights[..., :100], inits)):
        with pytest.raises(ValueError):
            kpnp.refine_cuda(*args)
    with pytest.raises(ValueError):
        kpnp.refine(data.double(), weights.double(), inits.double())


@pytest.mark.cuda
def test_captured_launch_replays(cuda):
    """A launch captured in a CUDA graph replays the direct launch's bits,
    and the capture's tally is one launch of its problems."""
    data, weights, inits = (x.to(cuda) for x in _problem(3, 10, 2304, 5))
    direct = kpnp.refine(data, weights, inits)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), _build.recording():
        kpnp.refine(data, weights, inits)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with _build.recording() as tally, torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        out, ok = kpnp.refine(data, weights, inits)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    out.fill_(float("nan"))
    ok.fill_(False)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), direct[0].view(torch.int32))
    assert torch.equal(ok, direct[1])
    assert tally == [("pnp_refine", 30)]


@pytest.mark.cuda
def test_a_pose_fit_launches_once_a_call(cuda, pose_fit):
    """The cell's eager pose fit: one launch for every _refine call, its
    problems 3 rows x P each, and the plain version never on the card."""
    assert pose_fit["calls"] > 0 and pose_fit["plain_on_card"] == 0
    assert pose_fit["launches"] == pose_fit["calls"] == len(pose_fit["inputs"])
    assert pose_fit["problems"] == sum(w.shape[0] * w.shape[1]
                                       for _, w, _ in pose_fit["inputs"])
