"""The port's CUDA scoring kernels on the card (homography and
fundamental, the latter also at the essential path's shapes), against
their plain torch versions on the same CUDA tensors.

These tests need a CUDA device and nvcc. They import neither JAX nor the
JAX package, so that they also run where JAX is not installed:

  python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Elsewhere they skip. Tolerances: inlier counts exact; scores, dots and
norms rtol 1e-3 and atol 1e-2 (the kernel sums in a fixed order of lanes,
warps and cluster ranks, the plain version in torch's reduction order).
Two launches on the same inputs must agree bit for bit, and so must a row
scored alone and inside a batch of rows, and one row against the saved
outputs of the one-problem kernel that preceded the row axis
(tests/data/score_golden.npz, written by tools/score_golden.py).
"""

import os

import numpy as np
import pytest
import torch

from progressivex_tpu_torch.kernels import _build
from progressivex_tpu_torch.kernels import scoring as kscoring
from progressivex_tpu_torch.models import essential, fundamental, homography

TRUNC_SQ, EXPONENT = 25.0, 2.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _case(dev, b=96, n=300, seed=0, family=homography, m=4):
    r = np.random.default_rng(seed)
    data = torch.as_tensor(r.uniform(-50, 50, (n, 4)), dtype=torch.float32)
    idx = torch.as_tensor(r.integers(0, n, (b, m)))
    descs, _ = family._minimal_batched(data[idx])
    descs = descs.reshape(-1, 9)
    descs = descs[torch.isfinite(descs).all(1)][:b]
    compound = torch.as_tensor(r.uniform(0, 1, n), dtype=torch.float32)
    pmask = torch.as_tensor(r.uniform(size=n) > 0.15)
    return [t.to(dev).contiguous() for t in (data, descs, compound, pmask)]


def _check(got, want):
    for g, w, name in zip(got, want, ("scores", "inliers", "dots", "norms")):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        if name == "inliers":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-2, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("magsac_levels", [0, 3, 4])
@pytest.mark.parametrize("has_compound", [False, True])
def test_kernel_matches_plain(cuda, magsac_levels, has_compound):
    args = _case(cuda)
    before = _build.LAUNCHES["score_homography"]
    got = kscoring.score_homography(*args, TRUNC_SQ, EXPONENT, has_compound,
                                    magsac_levels)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["score_homography"] == before + 1
    want = kscoring.score_homography_plain(*args, TRUNC_SQ, EXPONENT,
                                           has_compound, magsac_levels)
    _check(got, want)


@pytest.mark.cuda
def test_kernel_padding_independence(cuda):
    data, descs, compound, pmask = _case(cuda, n=256)
    base = kscoring.score_homography(data, descs, compound, pmask, TRUNC_SQ,
                                     EXPONENT, True)
    bad = torch.where(pmask[:, None], data, 1e6)
    got = kscoring.score_homography(bad, descs, compound, pmask, TRUNC_SQ,
                                    EXPONENT, True)
    for g, b in zip(got, base):
        np.testing.assert_allclose(g.cpu().numpy(), b.cpu().numpy(), rtol=1e-5)


@pytest.mark.cuda
def test_kernel_rejects_bad_shapes(cuda):
    data, descs, compound, pmask = _case(cuda)
    with pytest.raises(ValueError, match="shapes"):
        kscoring.score_homography(data[:, :3], descs, compound, pmask,
                                  TRUNC_SQ, EXPONENT, True)
    with pytest.raises(ValueError, match="is on"):
        kscoring.score_homography(data, descs.cpu(), compound, pmask,
                                  TRUNC_SQ, EXPONENT, True)


@pytest.mark.cuda
@pytest.mark.parametrize("magsac_levels", [0, 3, 4])
@pytest.mark.parametrize("has_compound", [False, True])
def test_fundamental_kernel_matches_plain(cuda, magsac_levels, has_compound):
    args = _case(cuda, family=fundamental, m=7)
    before = _build.LAUNCHES["score_fundamental"]
    got = kscoring.score_fundamental(*args, TRUNC_SQ, EXPONENT, has_compound,
                                     magsac_levels)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["score_fundamental"] == before + 1
    want = kscoring.score_fundamental_plain(*args, TRUNC_SQ, EXPONENT,
                                            has_compound, magsac_levels)
    _check(got, want)


@pytest.mark.cuda
def test_fundamental_kernel_padding_independence(cuda):
    data, descs, compound, pmask = _case(cuda, n=256, family=fundamental, m=7)
    base = kscoring.score_fundamental_cuda(data, descs, compound, pmask, TRUNC_SQ,
                                           EXPONENT, True, 4)
    bad = torch.where(pmask[:, None], data, 1e6)
    got = kscoring.score_fundamental_cuda(bad, descs, compound, pmask, TRUNC_SQ,
                                          EXPONENT, True, 4)
    for g, b in zip(got, base):
        np.testing.assert_allclose(g.cpu().numpy(), b.cpu().numpy(), rtol=1e-5)


FAMILIES = {"homography": (homography, 4), "fundamental": (fundamental, 7)}


def _shape_case(dev, family, b, n, seed=0):
    """b finite minimal-solve descriptors of `family` on n random points;
    the last 13 points and about 15% of the rest are masked, so the valid
    count is a multiple of no tile size."""
    fam, m = FAMILIES[family]
    r = np.random.default_rng(seed)
    data = torch.as_tensor(r.uniform(-50, 50, (n, 4)), dtype=torch.float32)
    idx = torch.as_tensor(r.integers(0, n, (2 * b, m)))
    descs, _ = fam._minimal_batched(data[idx])
    descs = descs.reshape(-1, 9)
    descs = descs[torch.isfinite(descs).all(1)][:b]
    assert descs.shape[0] == b
    compound = torch.as_tensor(r.uniform(0, 1, n), dtype=torch.float32)
    pmask = torch.as_tensor(r.uniform(size=n) > 0.15) & (torch.arange(n) < n - 13)
    return [t.to(dev).contiguous() for t in (data, descs, compound, pmask)]


def _score(family):
    return getattr(kscoring, f"score_{family}_cuda"), \
        getattr(kscoring, f"score_{family}_plain")


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("b", [1, 4, 5, 256, 600, 1536, 2049])
@pytest.mark.parametrize("n", [128, 300, 384, 2304, 7680])
def test_kernel_shapes_match_plain(cuda, family, b, n):
    """Every tiling the wrapper picks (hypothesis tiles, cluster split,
    ring stages, ragged tails) against the plain version."""
    args = _shape_case(cuda, family, b, n)
    cuda_fn, plain_fn = _score(family)
    got = cuda_fn(*args, TRUNC_SQ, EXPONENT, True, 4)
    torch.cuda.synchronize()
    _check(got, plain_fn(*args, TRUNC_SQ, EXPONENT, True, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("b, n", [(256, 2304), (4, 2304)])
def test_kernel_all_masked(cuda, family, b, n):
    data, descs, compound, pmask = _shape_case(cuda, family, b, n)
    scores, inliers, dots, norms = _score(family)[0](
        data, descs, compound, torch.zeros_like(pmask), TRUNC_SQ, EXPONENT, True, 4)
    for t in (scores, dots, norms):
        assert torch.equal(t, torch.zeros_like(t))
    assert torch.equal(inliers, torch.zeros_like(inliers))


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("b, n", [(256, 2304), (4, 2304), (1536, 256)])
def test_kernel_nan_descriptor_is_isolated(cuda, family, b, n):
    """A NaN descriptor row leaves every other row's outputs unchanged."""
    data, descs, compound, pmask = _shape_case(cuda, family, b, n)
    cuda_fn = _score(family)[0]
    base = cuda_fn(data, descs, compound, pmask, TRUNC_SQ, EXPONENT, True, 4)
    bad = descs.clone()
    bad[1 % b] = float("nan")
    got = cuda_fn(data, bad, compound, pmask, TRUNC_SQ, EXPONENT, True, 4)
    keep = torch.arange(b, device=cuda) != 1 % b
    for g, w in zip(got, base):
        assert torch.equal(g[keep], w[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("b, n", [(256, 2304), (4, 2304), (1536, 256), (4, 7680)])
def test_kernel_is_deterministic(cuda, family, b, n):
    args = _shape_case(cuda, family, b, n)
    cuda_fn = _score(family)[0]
    first = cuda_fn(*args, TRUNC_SQ, EXPONENT, True, 4)
    second = cuda_fn(*args, TRUNC_SQ, EXPONENT, True, 4)
    for g, w in zip(first, second):
        assert torch.equal(g, w)


# Every tiling that kernels/scoring._tiling can pick: K hypotheses a block,
# S blocks a cluster, threads a block.
TILINGS = [(k, s, t) for k in (1, 2, 4) for s in range(1, 9) for t in (128, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("b, n", [(5, 2001), (600, 7680), (3, 100)])
def test_every_tiling_matches_plain(cuda, family, b, n):
    """Each (K, S, threads) through the C entry point against the plain
    version, all four outputs: a hypothesis tile past B (K = 4 at B = 5),
    many ring stages (S = 1 at N = 7680), ragged rank ends (N = 2001) and
    cluster ranks with no points (S = 8 at N = 100)."""
    data, descs, compound, pmask = _shape_case(cuda, family, b, n)
    name = f"score_{family}"
    kernel = _build.entry_point(name, kscoring._ARGS)
    want = _score(family)[1](data, descs, compound, pmask, TRUNC_SQ, EXPONENT,
                             True, 4)
    failed = []
    for tiling in TILINGS:
        got = _c_launch(kernel, data[None], descs[None], compound[None], pmask[None],
                        torch.full((1,), TRUNC_SQ, device=cuda),
                        torch.ones(1, dtype=torch.bool, device=cuda), 4, tiling)
        try:
            _check([g[0] for g in got], want)
        except AssertionError as e:
            failed.append(f"{tiling}: {e}")
    assert not failed, "\n".join(failed)


def _c_launch(kernel, data, descs, compound, pmask, trunc_sq, has, m, tiling,
              exponent=EXPONENT):
    """The C entry point over rows: data [R, N, 4], descs [R, B, 9],
    compound and pmask [R, N], trunc_sq and has [R], at `tiling`. Returns
    the four [R, B] outputs, NaN (or -1) where the kernel wrote nothing."""
    r, n = data.shape[:2]
    b = descs.shape[1]
    dev = data.device
    outs = [torch.full((r, b), float("nan"), device=dev) for _ in range(3)]
    inliers = torch.full((r, b), -1, dtype=torch.int32, device=dev)
    has = has.to(torch.bool).contiguous()
    trunc_sq = trunc_sq.to(torch.float32).contiguous()
    err = kernel(data.data_ptr(), compound.data_ptr(), pmask.data_ptr(),
                 descs.data_ptr(), r, b, n, trunc_sq.data_ptr(), has.data_ptr(),
                 exponent, m, *tiling, outs[0].data_ptr(), inliers.data_ptr(),
                 outs[1].data_ptr(), outs[2].data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0, f"{tiling}: CUDA error {err}"
    return outs[0], inliers, outs[1], outs[2]


def _rows_case(dev, family, rows, b, n, seed=0):
    """`rows` problems of `family` at [b, n] (each `_shape_case` with its
    own seed), stacked on a row axis, with a threshold a row and the
    compound penalty on in every other row."""
    cases = [_shape_case(dev, family, b, n, seed=seed + r) for r in range(rows)]
    stacked = [torch.stack(t).contiguous() for t in zip(*cases)]
    trunc_sq = torch.tensor([TRUNC_SQ * (1.0 + 0.25 * (r % 3)) for r in range(rows)],
                            device=dev)
    has = torch.arange(rows, device=dev) % 2 == 0
    return stacked, trunc_sq, has


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("rows", [1, 2, 16])
@pytest.mark.parametrize("b", [1, 4, 5, 256, 600, 1536, 2049])
@pytest.mark.parametrize("n", [128, 300, 384, 2304, 7680])
def test_rows_match_plain(cuda, family, rows, b, n):
    """The row-batched kernel (one launch over all rows, per-row
    thresholds, the compound penalty on in some rows and off in others)
    against the plain version over the same rows."""
    (data, descs, compound, pmask), trunc_sq, has = _rows_case(cuda, family, rows, b, n)
    cuda_fn, plain_fn = _score(family)
    name = f"score_{family}"
    before = _build.LAUNCHES[name]
    got = cuda_fn(data, descs, compound, pmask, trunc_sq, EXPONENT, has, 4)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    assert got[0].shape == (rows, b)
    for r in range(rows):  # one row at a time: the plain [R, B, N] field is large
        want = plain_fn(data[r], descs[r], compound[r], pmask[r], trunc_sq[r],
                        EXPONENT, has[r], 4)
        _check([g[r] for g in got], want)


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("b, n", [(256, 2304), (4, 2304), (256, 384), (1536, 256),
                                  (4, 256), (5, 2001), (600, 7680), (3, 100)])
def test_row_alone_equals_row_in_batch(cuda, family, b, n):
    """A row's four outputs, bit for bit, scored alone and as row 5 of 16
    rows, at every K the wrapper can pick for it (K follows R B), with the
    cluster size and thread count `_tiling` picks from the row's own
    (B, N)."""
    (data, descs, compound, pmask), trunc_sq, has = _rows_case(cuda, family, 16, b, n)
    kernel = _build.entry_point(f"score_{family}", kscoring._ARGS)
    n_sms = kscoring._sm_count(cuda)
    _, cluster, threads = kscoring._tiling(b, n, n_sms)
    for rows in (1, 16):
        assert kscoring._tiling(b, n, n_sms, rows)[1:] == (cluster, threads)
    sl = slice(5, 6)
    alone = _c_launch(kernel, data[sl], descs[sl], compound[sl], pmask[sl],
                      trunc_sq[sl], has[sl], 4, kscoring._tiling(b, n, n_sms))
    for k in (1, 2, 4):
        batch = _c_launch(kernel, data, descs, compound, pmask, trunc_sq, has, 4,
                          (k, cluster, threads))
        for g, w in zip(batch, alone):
            assert torch.equal(g[5], w[0]), f"K={k}"


GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "score_golden.npz")


@pytest.mark.cuda
def test_one_row_matches_the_kernel_before_rows(cuda):
    """R = 1 through the row entry point against the saved outputs of the
    one-problem kernel that preceded the row axis, on the same inputs and
    the same tilings: every case of tools/score_golden.py, bit for bit."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "score_golden", os.path.join(os.path.dirname(GOLDEN), "..", "..", "tools",
                                     "score_golden.py"))
    golden = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(golden)
    saved = np.load(GOLDEN)
    for c, (family, b, n, _) in enumerate(golden.CASES):
        t = [torch.as_tensor(saved[f"{c}/{k}"], device=cuda)[None]
             for k in ("data", "descs", "compound", "mask")]
        kernel = _build.entry_point(f"score_{family}", kscoring._ARGS)
        for m in (0, 4):
            for has in (False, True):
                got = _c_launch(
                    kernel, *t, torch.full((1,), golden.TRUNC_SQ[family], device=cuda),
                    torch.full((1,), has, device=cuda), m,
                    kscoring._tiling(b, n, kscoring._sm_count(cuda)),
                    exponent=golden.EXPONENT[family])
                for name, g in zip(("scores", "inliers", "dots", "norms"), got):
                    want = saved[f"{c}/m{m}/has{int(has)}/{name}"]
                    np.testing.assert_array_equal(
                        g[0].cpu().numpy(), want,
                        err_msg=f"case {c} {family} [{b}, {n}] m={m} has={has} {name}")


def _essential_rows(dev, rows, b=4090, n=512, n_valid=400, seed=0):
    """The essential path's shapes: `rows` rows (restarts, or lanes x
    restarts) of B = 409 five-point samples x 10 solutions on a
    calibrated two-motion scene of n_valid correspondences padded to n,
    at the threshold 1.5 / 800 (trunc_sq about 7.9e-6, residuals near
    1e-7). Returns ((data, descs, compound, pmask), trunc_sq, has)."""
    r = np.random.default_rng(seed)
    pts = []
    for motion in range(2):
        X = r.uniform(-1, 1, (n_valid // 4, 3)) + np.array([0.5 * motion, 0, 4.0])
        ax = r.normal(size=3) * 0.2
        K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
        R = np.eye(3) + K + 0.5 * K @ K
        Xc = X @ R.T + r.uniform(-0.3, 0.3, 3)
        pts.append(np.concatenate([X[:, :2] / X[:, 2:], Xc[:, :2] / Xc[:, 2:]], 1))
    pts.append(r.uniform(-0.4, 0.4, (n_valid // 2, 4)))
    data = torch.zeros(n, 4)
    data[:n_valid] = torch.as_tensor(np.concatenate(pts)[r.permutation(n_valid)],
                                     dtype=torch.float32)
    pmask = torch.arange(n) < n_valid
    idx = torch.as_tensor(r.integers(0, n_valid // 2, (b, 5)))
    descs, valid = essential._minimal_batched(data[idx])
    descs = torch.where(valid.reshape(-1)[:, None], descs.reshape(-1, 9),
                        descs.reshape(-1, 9)[0])
    descs = descs[torch.isfinite(descs).all(1)]
    descs = descs[torch.arange(b) % len(descs)]
    stacked = [t[None].repeat(rows, *([1] * t.ndim)).to(dev).contiguous() for t in (
        data, descs, torch.as_tensor(r.uniform(0, 1, n), dtype=torch.float32), pmask)]
    trunc_sq = torch.full((rows,), float((1.5 * 1.5 / 800.0) ** 2), device=dev)
    has = torch.arange(rows, device=dev) % 2 == 0
    return stacked, trunc_sq, has


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [3, 12])
@pytest.mark.parametrize("magsac_levels", [0, 4])
def test_fundamental_kernel_at_essential_shapes(cuda, rows, magsac_levels):
    """score_fundamental on E descriptors at [3 x 4090, 512] (one scene,
    three restarts) and [12 x 4090, 512] (four scenes): inliers exact,
    the rest within the F cases' tolerance."""
    (data, descs, compound, pmask), trunc_sq, has = _essential_rows(cuda, rows)
    got = kscoring.score_fundamental_cuda(data, descs, compound, pmask, trunc_sq, 2.0,
                                          has, magsac_levels)
    torch.cuda.synchronize()
    assert int(got[1].max()) > 50  # the scale holds inliers
    for r in (0, rows - 1):
        want = kscoring.score_fundamental_plain(data[r], descs[r], compound[r], pmask[r],
                                                trunc_sq[r], 2.0, has[r], magsac_levels)
        _check([g[r] for g in got], want)


@pytest.mark.cuda
def test_essential_nan_rows_are_harmless(cuda):
    """Rows of NaN and inf descriptors, as an invalid five-point solution
    can give: every other row's outputs are bit for bit those without
    them and match the plain version; the kernel's score of a bad row may
    be finite where the plain version's is NaN (fmaxf drops a NaN), so
    the engine's mask (the solver's valid flag, a finite score) decides,
    and it gives the plain version's verdict."""
    (data, descs, compound, pmask), trunc_sq, has = _essential_rows(cuda, 3)
    bad = torch.zeros(3, 4090, dtype=torch.bool, device=cuda)
    bad[0, [7, 100, 2000]] = True
    bad[1, -1] = True
    bad[2, :64] = True
    descs_bad = descs.clone()
    descs_bad[0, [7, 100]] = float("nan")
    descs_bad[0, 2000, 3] = float("inf")
    descs_bad[1, -1, 0] = float("-inf")
    descs_bad[2, :64, 4] = float("nan")
    args = (compound, pmask, trunc_sq, 2.0, has, 4)
    got = kscoring.score_fundamental_cuda(data, descs_bad, *args)
    clean = kscoring.score_fundamental_cuda(data, descs, *args)
    want = kscoring.score_fundamental_plain(data, descs_bad, *args)
    ok = ~bad
    for g, c in zip(got, clean):
        assert torch.equal(g[ok], c[ok])
    _check([g[ok] for g in got], [w[ok] for w in want])
    valid = ok  # a non-finite E is never valid (models/essential._minimal_batched)
    assert torch.equal(valid & torch.isfinite(got[0]), valid & torch.isfinite(want[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_launch_from_a_fresh_thread(cuda, family):
    """A new host thread starts on device 0 and the library's CUDA runtime
    launches on the thread's current device: the wrapper sets the
    tensors' device for the launch, on every card there is (a device mesh
    feeds each card from a thread of its own). Each launch is counted
    once, with its rows."""
    import threading

    name = f"score_{family}"
    for dev in [torch.device("cuda", i) for i in range(torch.cuda.device_count())]:
        args = [t.to(dev) for t in _case(cuda, family=FAMILIES[family][0],
                                         m=FAMILIES[family][1])]
        out, errors = [], []

        def launch():
            try:
                out.append(getattr(kscoring, f"{name}_cuda")(
                    *args, TRUNC_SQ, EXPONENT, True, 4))
                torch.cuda.synchronize(dev)
            except Exception as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        before = (_build.LAUNCHES[name], _build.UNITS[name])
        t = threading.Thread(target=launch)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive() and not errors, errors
        assert (_build.LAUNCHES[name], _build.UNITS[name]) == (before[0] + 1,
                                                                  before[1] + 1)
        assert all(o.device == dev for o in out[0])
        _check(out[0], getattr(kscoring, f"{name}_plain")(*args, TRUNC_SQ, EXPONENT,
                                                          True, 4))
