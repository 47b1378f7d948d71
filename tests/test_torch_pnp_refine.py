"""The dispatch of models/pnp._refine (kernels/pnp.py) on the CPU: a CPU
tensor takes the plain version, bit for bit the refit as it ran before
the kernel (`_before`, kept here as it was), and the checks that guard
the CUDA kernel refuse what it does not take without a device (meta
tensors). tests/test_torch_pnp_refine_cuda.py holds the kernel to the
plain version on the card; tests/test_torch_pnp.py the plain version to
the JAX package's."""

import numpy as np
import pytest
import torch

from progressivex_tpu_torch.kernels import _build
from progressivex_tpu_torch.kernels import pnp as kpnp
from progressivex_tpu_torch.models import pnp as tpnp
from progressivex_tpu_torch.models.base import row_view
from progressivex_tpu_torch.ops.linalg import matmul_small, row_sum


def _before(data, weights, init_desc, n_iters=6):
    Pm = init_desc.reshape(*init_desc.shape[:-1], 3, 4)
    R, t = Pm[..., :3], Pm[..., 3]
    Xw = row_view(data[..., 2:5], data, weights, 2)
    obs = row_view(data[..., :2], data, weights, 2)
    w = torch.clamp(weights, min=0.0)
    eye6 = 1e-8 * torch.eye(6, dtype=data.dtype, device=data.device)
    for _ in range(n_iters):
        q = (Xw[..., :, None, :] * R[..., None, :, :]).sum(-1) + t[..., None, :]
        z = q[..., 2]
        front = z > 1e-6
        invz = 1.0 / torch.where(front, z, 1.0)
        r = q[..., :2] * invz[..., None] - obs
        zero = torch.zeros_like(z)
        Jq = torch.stack([
            torch.stack([invz, zero, -q[..., 0] * invz * invz], -1),
            torch.stack([zero, invz, -q[..., 1] * invz * invz], -1)], -2)
        J = torch.cat([matmul_small(Jq, -tpnp._skew(q - t[..., None, :])), Jq], -1)
        Jw = J * (w * front)[..., None, None]
        H = row_sum((Jw[..., :, :, None] * J[..., :, None, :]).sum(-3), -3) + eye6
        g = row_sum((Jw * r[..., None]).sum(-2), -2)
        d = torch.linalg.solve_ex(H, -g[..., None])[0][..., 0]
        R = matmul_small(tpnp._so3_exp(d[..., :3]), R)
        t = t + d[..., 3:]
    desc = tpnp._pose_desc(R, t)
    ok = torch.isfinite(desc).all(-1) & ((w > 0).sum(-1) >= 3)
    return torch.where(ok[..., None], desc, init_desc), ok


def _rotation(r, angle):
    axis = r.normal(size=3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _problem(rows, p, n, seed, dtype=np.float32):
    """data [rows, n, 5]: world points about 1 m in front of a camera,
    observed through a pose with noise, a fifth of them outliers; weights
    [rows, p, n] in [0, 1] with zeros; starts [rows, p, 12] off the pose
    by a few degrees and centimetres, one of them behind the camera."""
    r = np.random.default_rng(seed)
    data = np.empty((rows, n, 5))
    inits = np.empty((rows, p, 12))
    for i in range(rows):
        R, t = _rotation(r, r.uniform(0, np.pi)), np.array([0.0, 0.0, 1.0])
        X = r.normal(scale=0.1, size=(n, 3))
        cam = (R @ X.T).T + t
        xy = cam[:, :2] / cam[:, 2:] + r.normal(scale=1e-3, size=(n, 2))
        out = r.random(n) < 0.2
        xy[out] = r.uniform(-0.3, 0.3, size=(out.sum(), 2))
        data[i] = np.concatenate([xy, X], 1)
        for k in range(p):
            R0 = _rotation(r, r.uniform(0, 0.1)) @ R
            t0 = t + r.normal(scale=0.03, size=3)
            inits[i, k] = np.concatenate([R0, t0[:, None]], 1).reshape(12)
    inits[0, -1, 11] = -1.0  # the last start of row 0 puts the points behind
    weights = r.random((rows, p, n)) * (r.random((rows, p, n)) < 0.8)
    return (torch.from_numpy(data.astype(dtype)), torch.from_numpy(weights.astype(dtype)),
            torch.from_numpy(inits.astype(dtype)))


def _bits_equal(a, b):
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("row_axis", [True, False])
@pytest.mark.parametrize("p", [1, 4, 10])
def test_cpu_takes_the_plain_path_bit_for_bit(dtype, row_axis, p):
    data, weights, inits = _problem(3, p, 300, p, dtype)
    weights[0, 0, 2:] = 0.0  # fewer than 3 positive weights: the start back
    if not row_axis:
        data, weights, inits = data[1], weights[1], inits[1]
    before = dict(_build.LAUNCHES)
    want_d, want_ok = _before(data, weights, inits)
    for fn in (kpnp.refine_plain, tpnp._refine, tpnp.PNP.refine_solver):
        got_d, got_ok = fn(data, weights, inits)
        assert got_d.shape == inits.shape and got_ok.shape == inits.shape[:-1]
        assert _bits_equal(got_d, want_d) and torch.equal(got_ok, want_ok)
    assert _build.LAUNCHES == before  # the plain version is no launch
    assert bool(want_ok.any())
    if row_axis:
        assert not bool(want_ok[0, 0])
        assert _bits_equal(want_d[0, 0], inits[0, 0])


def test_cpu_two_middle_axes_and_fewer_steps_bit_for_bit():
    data, weights, inits = _problem(2, 6, 200, 7)
    w4, i4 = weights.reshape(2, 2, 3, 200), inits.reshape(2, 2, 3, 12)
    for n_iters in (6, 2):
        got = tpnp._refine(data, w4, i4, n_iters)
        want = _before(data, w4, i4, n_iters)
        assert _bits_equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_cpu_non_finite_start_returns_it():
    data, weights, inits = _problem(1, 4, 128, 3)
    inits[0, 1, 0] = float("nan")
    inits[0, 2, 5] = float("inf")
    got_d, got_ok = tpnp._refine(data, weights, inits)
    want_d, want_ok = _before(data, weights, inits)
    assert torch.equal(got_ok, want_ok)
    assert not bool(got_ok[0, 1]) and not bool(got_ok[0, 2])
    assert torch.equal(got_d.isnan(), want_d.isnan())
    assert _bits_equal(got_d.nan_to_num(), want_d.nan_to_num())


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("args,why", [
    ((_meta(3, 256, 5, dtype=torch.float64), _meta(3, 4, 256), _meta(3, 4, 12)), "float32"),
    ((_meta(3, 256, 5), _meta(3, 4, 256, dtype=torch.float64), _meta(3, 4, 12)), "float32"),
    ((_meta(3, 256, 5), _meta(3, 4, 256), _meta(3, 4, 12, dtype=torch.bfloat16)),
     "float32"),
    ((_meta(3, 256, 4), _meta(3, 4, 256), _meta(3, 4, 12)), r"\[R, N, 5\]"),
    ((_meta(256, 5), _meta(4, 256), _meta(4, 12)), "rank 3"),
    ((_meta(3, 256, 5), _meta(3, 2, 2, 256), _meta(3, 4, 12)), "rank 3"),
    ((_meta(3, 256, 5), _meta(3, 4, 128), _meta(3, 4, 12)), r"\[3, P, 256\]"),
    ((_meta(3, 256, 5), _meta(2, 4, 256), _meta(3, 4, 12)), r"\[3, P, 256\]"),
    ((_meta(3, 256, 5), _meta(3, 4, 256), _meta(3, 4, 9)), r"\[3, 4, 12\]"),
    ((_meta(3, 256, 5), _meta(3, 4, 256), _meta(3, 5, 12)), r"\[3, 4, 12\]"),
])
def test_check_refuses_what_the_kernel_does_not_take(args, why):
    with pytest.raises(ValueError, match=why):
        kpnp._check(*args)


def test_check_takes_the_engine_shapes_and_refuses_strided_tensors():
    for p in (4, 8, 10):
        for n in (128, 2304, 7680):
            kpnp._check(_meta(3, n, 5), _meta(3, p, n), _meta(3, p, 12))
    with pytest.raises(ValueError, match="contiguous data"):
        kpnp._check(_meta(3, 5, 256).transpose(-1, -2), _meta(3, 4, 256), _meta(3, 4, 12))
    with pytest.raises(ValueError, match="contiguous weights"):
        kpnp._check(_meta(3, 256, 5), _meta(3, 1, 256).expand(3, 4, 256), _meta(3, 4, 12))
    with pytest.raises(ValueError, match="contiguous init_desc"):
        kpnp._check(_meta(3, 256, 5), _meta(3, 4, 256), _meta(3, 12, 4).transpose(-1, -2))


def test_other_devices_raise():
    with pytest.raises(ValueError, match="no pnp_refine kernel"):
        kpnp.refine(_meta(3, 256, 5), _meta(3, 4, 256), _meta(3, 4, 12))
