"""The port's threefry kernel (csrc/threefry.cu) on the card against its
plain int64 torch version on the same CUDA tensors, bit for bit, and the
draw of a fit's samples on the card against the same draw on the CPU.

These tests need a CUDA device and nvcc. They import neither JAX nor the
JAX package (tests/test_torch_prng.py holds the plain version to
jax.random on the CPU):

  python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_threefry_cuda.py

Elsewhere they skip. Tolerance: none, every word is equal.
"""

import numpy as np
import pytest
import torch

from progressivex_tpu_torch.kernels import _build
from progressivex_tpu_torch.kernels import threefry as kthreefry
from progressivex_tpu_torch.ops import prng, sampling


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("n_keys,count", [(1, 1), (3, 7), (10, 3), (384, 24576),
                                          (5, 70001)])
def test_kernel_matches_plain(cuda, n_keys, count, pair):
    r = np.random.default_rng(n_keys + count)
    keys = torch.as_tensor(r.integers(0, 2**32, (n_keys, 2)), device=cuda)
    before = _build.LAUNCHES["threefry"]
    got = kthreefry.threefry(keys, count, pair)
    assert _build.LAUNCHES["threefry"] == before + 1
    want = kthreefry.threefry_plain(keys, count, pair)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_offsets_match_plain(cuda):
    r = np.random.default_rng(1)
    keys = torch.as_tensor(r.integers(0, 2**32, (64, 2)), device=cuda)
    offsets = torch.as_tensor(r.integers(0, 2**32, 64), device=cuda)
    assert torch.equal(kthreefry.threefry(keys, 1, True, offsets),
                       kthreefry.threefry_plain(keys, 1, True, offsets))


@pytest.mark.cuda
@pytest.mark.parametrize("sampler_id", [0, 1, 2, 3])
def test_draw_on_the_card_equals_the_cpu(cuda, sampler_id):
    r = np.random.default_rng(sampler_id)
    n, k = 500, 48
    knn_idx = torch.as_tensor(r.integers(0, n, (2, n, k)))
    knn_mask = torch.as_tensor(r.random((2, n, k)) < 0.7)
    n_valid = torch.tensor([480, 300])
    keys = prng.split(torch.stack([prng.key(3), prng.key(-4)]), 6)
    want = sampling.sample_minimal(keys, sampler_id, 512, 7, n_valid, knn_idx, knn_mask)
    got = sampling.sample_minimal(keys.to(cuda), sampler_id, 512, 7, n_valid.to(cuda),
                                  knn_idx.to(cuda), knn_mask.to(cuda))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_captured_launch_replays(cuda):
    """A launch captured in a CUDA graph replays the direct launch's bits,
    and the capture's tally is one launch."""
    keys = prng.split(prng.key(5).to(cuda), 16)
    direct = kthreefry.threefry(keys, 1000, False)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), _build.recording():
        kthreefry.threefry(keys, 1000, False)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with _build.recording() as tally, torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        out = kthreefry.threefry(keys, 1000, False)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    out.fill_(0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, direct)
    assert tally == [("threefry", 16)]
