"""The port's smallest-eigenvector kernel (csrc/eigvec_psd.cu) on the card
against its plain torch version on the same CUDA tensors, its counts,
its capture in a CUDA graph, and its place in a fit.

These tests need a CUDA device and nvcc. They import neither JAX nor the
JAX package (tests/test_torch_linalg.py holds the plain version to the
JAX package's on the CPU):

  python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_eigvec_cuda.py

Elsewhere they skip. Tolerance: both results are unit vectors from the
same start vector and the same iteration, so they are compared entry by
entry, with no sign fixed, within ATOL. The kernel sums the trace and the
squared norms in index order, torch's reductions in theirs: the last bits
of those sums, and what six solves make of them, are the difference.
Non-finite entries must lie exactly where the plain version's do.
"""

import numpy as np
import pytest
import torch

from progressivex_tpu_torch.kernels import _build
from progressivex_tpu_torch.kernels import linalg as klinalg

ATOL = 2e-5

# The batch shapes the cells launch: a single H fit's refits
# [1, 20 | 4, 10], F's rank-2 step [4, 10, 3, 3], the pass cells' rows
# [32 | 128, 8]; PnP's DLT at n = 12.
SHAPES = [((1, 20), 9), ((4, 10), 9), ((4, 10), 3), ((32, 8), 9), ((128, 8), 9),
          ((4, 10), 12), ((7,), 12), ((), 3), ((1,), 9)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _grams(shape, n, seed):
    """Normal matrices X^T X of 3n rows, float32: half well conditioned,
    half with a near null vector (the last column a mix of the others up
    to 1e-4), one pixel-scale row each, as a DLT's rows give."""
    r = np.random.default_rng(seed)
    X = r.normal(size=(*shape, 3 * n, n))
    X[..., 0, :] *= 1e3
    near = r.random(shape) < 0.5
    mix = X[..., :-1] @ r.normal(size=n - 1) + 1e-4 * r.normal(size=(*shape, 3 * n))
    X[..., -1] = np.where(near[..., None], mix, X[..., -1])
    return torch.from_numpy(np.einsum("...ki,...kj->...ij", X, X).astype(np.float32))


def _compare(got, want):
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    err = (got - want).abs()[fin]
    return float(err.max()) if err.numel() else 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n", SHAPES)
def test_kernel_matches_plain(cuda, shape, n):
    M = _grams(shape, n, n + len(shape)).to(cuda)
    got = klinalg.smallest_eigvec_psd_cuda(M)
    want = klinalg.smallest_eigvec_psd_plain(M)
    assert got.shape == want.shape == (*shape, n) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert _compare(got, want) <= ATOL
    norms = torch.linalg.vector_norm(got.double(), dim=-1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n", klinalg.SIZES)
def test_degenerate_matrices(cuda, n):
    """Rank-deficient, zero-weight (a zero matrix), a zero row and column,
    a constant matrix, one inf, one -inf and one NaN entry: non-finite
    exactly where the plain version is, the rest within ATOL."""
    M = _grams((10,), n, 3 * n)
    r = np.random.default_rng(n)
    low = torch.from_numpy(r.normal(size=(n, 1)).astype(np.float32))
    M[0] = low @ low.T  # rank 1
    M[1] = 0.0
    M[2, :, 0] = 0.0
    M[2, 0, :] = 0.0
    M[3] = 1.0
    M[4, 1, 2] = float("inf")
    M[5, n - 1, n - 1] = -float("inf")
    M[6, 0, 1] = float("nan")
    M[7] = M[7] * 1e-30  # below the eps of the pivot guard
    M = M.to(cuda)
    got = klinalg.smallest_eigvec_psd_cuda(M)
    want = klinalg.smallest_eigvec_psd_plain(M)
    assert _compare(got, want) <= ATOL
    assert not torch.isfinite(got[4:7]).any()
    assert torch.isfinite(got[[0, 1, 2, 3, 7, 8, 9]]).all()


@pytest.mark.cuda
def test_counts_one_launch_and_the_matrices(cuda, monkeypatch):
    for counts in (_build.LAUNCHES, _build.UNITS):
        monkeypatch.setitem(counts, "eigvec_psd", 0)
    klinalg.smallest_eigvec_psd(_grams((4, 10), 9, 0).to(cuda))
    klinalg.smallest_eigvec_psd(_grams((3,), 3, 1).to(cuda), iters=2)
    assert _build.LAUNCHES["eigvec_psd"] == 2
    assert _build.UNITS["eigvec_psd"] == 43
    klinalg.smallest_eigvec_psd(_grams((3,), 3, 1))  # the CPU: no launch
    assert _build.LAUNCHES["eigvec_psd"] == 2


@pytest.mark.cuda
def test_what_the_kernel_does_not_take_raises(cuda):
    for M in (torch.eye(4, device=cuda)[None], torch.eye(9, device=cuda, dtype=torch.float64)[None],
              torch.eye(9, device=cuda).expand(2, 9, 9)):
        with pytest.raises(ValueError):
            klinalg.smallest_eigvec_psd(M)


@pytest.mark.cuda
def test_captured_launch_replays(cuda):
    """A launch captured in a CUDA graph replays the direct launch's bits,
    and the capture's tally is one launch of its matrices."""
    M = _grams((4, 10), 9, 5).to(cuda)
    direct = klinalg.smallest_eigvec_psd(M)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), _build.recording():
        klinalg.smallest_eigvec_psd(M)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with _build.recording() as tally, torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        out = klinalg.smallest_eigvec_psd(M)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    out.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), direct.view(torch.int32))
    assert tally == [("eigvec_psd", 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("problem,scene", [("H", "oldclassicswing"), ("F", "book")])
def test_a_fit_launches_once_a_call(cuda, monkeypatch, problem, scene):
    """An eager fit on the card: one launch for every call of the solver,
    and the plain version never runs on a CUDA tensor."""
    import progressivex_tpu_torch as px
    from progressivex_tpu_torch.core import graphs
    from progressivex_tpu_torch.eval.adelaide import scene_kwargs
    from progressivex_tpu_torch.io.data import load_corr_scene

    calls, plain_on_card = [0], [0]
    orig, orig_plain = klinalg.smallest_eigvec_psd, klinalg.smallest_eigvec_psd_plain

    def counted(M, iters=6):
        calls[0] += 1
        return orig(M, iters)

    def plain(M, iters=6):
        plain_on_card[0] += M.device.type == "cuda"
        return orig_plain(M, iters)

    monkeypatch.setattr(klinalg, "smallest_eigvec_psd", counted)
    monkeypatch.setattr(klinalg, "smallest_eigvec_psd_plain", plain)
    monkeypatch.setitem(_build.LAUNCHES, "eigvec_psd", 0)
    corrs = load_corr_scene(scene)[0]
    entry = px.findHomographies if problem == "H" else px.findTwoViewMotions
    graphs.clear()
    with graphs.eager():
        entry(corrs, **scene_kwargs(len(corrs), problem), random_seed=0)
    torch.cuda.synchronize()
    assert calls[0] > 0 and plain_on_card[0] == 0
    assert _build.LAUNCHES["eigvec_psd"] == calls[0]
