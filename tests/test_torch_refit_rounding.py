"""Why the port's fit can leave the JAX package's on the same samples: a
near-degenerate refit follows the rounding of its normal matrix.

The homography refit (models/homography._nonminimal, the same algorithm in
both packages) takes the smallest eigenvector of a 9x9 weighted normal
matrix by shifted inverse iteration in float32. On points spread over a
plane the two smallest eigenvalues lie far apart, and any order of the
matrix's sum over the points gives the same descriptor. On points near one
line the matrix has two near-null directions, and the order of the sum
alone turns the descriptor, in the port as in the JAX package. The
lockstep replay of unihouse (tools/hyp_lockstep.py, PERF.md §6)
traced the first difference between the two packages on the same
samples, seed by seed, to such refits in LO and PEARL: rounding, with no
step that computes another function.

32 correspondences of one homography (0.5 px noise), seed 0; "plane":
spread over a 1000 px square, "line": along one line (0.3 px off it). The
sum order changes by a permutation of the points. Tolerances: unit-scaled
descriptors (tests/test_torch_engine.py's scaling) within 1e-4 on the
plane (measured 3e-6), apart by more than 5e-3 on the line (measured
0.019 in the port, 0.033 in the JAX package).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivex_tpu.models.homography import _nonminimal as jax_nonminimal

from progressivex_tpu_torch.models.homography import (_dlt_rows, _nonminimal,
                                                       _scene_conditioners)

H_TRUE = np.array([[1.05, 0.02, 12.0], [0.01, 0.98, -7.0], [1e-5, 2e-5, 1.0]])
N = 32
SAME_ORDER_ATOL = 1e-4
TURNED_MIN = 5e-3


def _corrs(layout):
    r = np.random.default_rng(0)
    if layout == "plane":
        p = r.uniform(0, 1000, (N, 2))
    else:
        t = r.uniform(0, 1000, N)
        p = np.c_[t, 0.4 * t + 100] + r.normal(scale=0.3, size=(N, 2))
    q = np.c_[p, np.ones(N)] @ H_TRUE.T
    q = q[:, :2] / q[:, 2:] + r.normal(scale=0.5, size=(N, 2))
    return np.c_[p, q].astype(np.float32), r.permutation(N)


def _unit(d):
    d = np.asarray(d, np.float64).reshape(9)
    d = d / np.linalg.norm(d)
    return d * np.sign(d[np.abs(d).argmax()])


def _refit(package, data):
    w = np.ones(len(data), np.float32)
    if package == "jax":
        return np.asarray(jax_nonminimal(jnp.array(data), jnp.array(w))[0])
    return _nonminimal(torch.from_numpy(data), torch.from_numpy(w))[0].numpy()


def _small_eigenvalues(data):
    """The two smallest eigenvalues of the conditioned normal matrix over
    its largest, in float64."""
    n1, n2, _, _ = _scene_conditioners(torch.from_numpy(data).double())
    r0, r1 = _dlt_rows(n1[:, 0], n1[:, 1], n2[:, 0], n2[:, 1])
    ev = np.linalg.eigvalsh((r0.T @ r0 + r1.T @ r1).numpy())
    return ev[0] / ev[-1], ev[1] / ev[-1]


@pytest.fixture(autouse=True, scope="module")
def _jax_on_cpu():
    jax.config.update("jax_platforms", "cpu")


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("layout", ["plane", "line"])
def test_refit_and_the_order_of_its_sum(package, layout):
    data, perm = _corrs(layout)
    gap = np.abs(_unit(_refit(package, data)) - _unit(_refit(package, data[perm]))).max()
    first, second = _small_eigenvalues(data)
    if layout == "plane":
        assert second > 1e3 * first and second > 1e-4, (first, second)
        assert gap <= SAME_ORDER_ATOL, gap
    else:
        # two near-null directions: the sum's rounding picks the mix
        assert second < 1e-5, (first, second)
        assert gap > TURNED_MIN, gap


def test_packages_agree_on_a_plane():
    data, _ = _corrs("plane")
    gap = np.abs(_unit(_refit("port", data)) - _unit(_refit("jax", data))).max()
    assert gap <= SAME_ORDER_ATOL, gap
