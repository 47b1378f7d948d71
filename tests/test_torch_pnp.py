"""Parity of the port's 6D-pose family (models/pnp and the ops/linalg
functions it needs: `quartic_roots_real`, `polish_poly_roots`, `kabsch`)
with the JAX package's, on the same seeded numpy inputs; the port's copy
of `_fuse_pose_duplicates` on the cases of tests/test_pose_fusion.py; and
the T-LESS loader.

Tolerances: roots rtol 1e-4 on well-separated real roots with the
validity flags exact; rotations atol 1e-4 and translations rtol 1e-4
where the problem is well conditioned (distinct singular values, points
spread in depth); residuals rtol 1e-4. Kabsch's U and V are not compared:
R = V diag(1, 1, sign det) U^T is the same when a pair of singular vectors
flips sign together, and a rank-2 (three-point) problem leaves the third
pair free, so the rotation is what is held.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivex_tpu import api as japi
from progressivex_tpu.io.data import load_tless_scene as jload_tless
from progressivex_tpu.models import get_family as jfamily
from progressivex_tpu.models import pnp as jpnp
from progressivex_tpu.ops import linalg as jl

from progressivex_tpu_torch import api
from progressivex_tpu_torch.io.data import load_tless_scene
from progressivex_tpu_torch.io.metrics import pose_errors
from progressivex_tpu_torch.models import get_family
from progressivex_tpu_torch.models import pnp as tpnp
from progressivex_tpu_torch.ops import linalg as tl


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rotation(w):
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _pnp_scene(n, seed=0, noise=0.0):
    """tests/test_solvers.make_pnp_scene: a pose 4 units in front of the
    camera and n world points in the unit cube. Returns (data [n, 5]
    float32, R, t)."""
    r = np.random.default_rng(seed)
    Rm = _rotation(r.normal(size=3) * 0.3)
    t = np.array([0.1, -0.2, 4.0])
    X = r.uniform(-1, 1, size=(n, 3))
    q = X @ Rm.T + t
    xy = q[:, :2] / q[:, 2:3] + r.normal(scale=noise, size=(n, 2))
    return np.concatenate([xy, X], 1).astype(np.float32), Rm, t


def _pose(R, t):
    return np.concatenate([R, np.asarray(t)[:, None]], 1).reshape(12).astype(np.float32)


def test_quartic_roots_match_jax():
    r = np.random.default_rng(0)
    # Four well-separated real roots, then quartics with complex pairs.
    roots = np.sort(r.uniform(-4, 4, (64, 4)), 1) + np.arange(4) * 1.5
    c4 = np.stack([np.poly(rt)[1:] for rt in roots]).astype(np.float32)
    c2 = np.stack([np.polymul(np.poly([a, b]), [1.0, 0.0, 1.0 + s])[1:]
                   for a, b, s in r.uniform(-3, 3, (64, 3))]).astype(np.float32)
    c_none = np.stack([np.polymul([1.0, 0.0, 1.0 + s], [1.0, a, 2.0 + s])[1:]
                       for a, s in r.uniform(0, 1, (16, 2))]).astype(np.float32)
    coeffs = np.concatenate([c4, c2, c_none])
    want_r, want_v = jax.vmap(jl.quartic_roots_real)(jnp.array(coeffs))
    got_r, got_v = tl.quartic_roots_real(_t(coeffs))
    want_r, want_v = np.asarray(want_r), np.asarray(want_v)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    assert got_v.numpy()[:64].all() and not got_v.numpy()[128:].any()
    ok = want_v
    np.testing.assert_allclose(got_r.numpy()[ok], want_r[ok], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.sort(got_r.numpy()[:64], 1), roots, rtol=1e-3, atol=1e-3)
    # Invalid entries hold the first valid root.
    first = np.argmax(want_v[64:128], 1)
    filled = np.where(want_v[64:128], got_r.numpy()[64:128],
                      got_r.numpy()[64:128][np.arange(64), first][:, None])
    np.testing.assert_array_equal(got_r.numpy()[64:128], filled)


def test_polish_poly_roots_matches_jax():
    r = np.random.default_rng(1)
    coeffs = np.concatenate([np.ones((32, 1)), r.normal(size=(32, 4))], 1).astype(np.float32)
    x0 = r.normal(size=(32, 4)).astype(np.float32)
    want = jax.vmap(jl.polish_poly_roots)(jnp.array(coeffs), jnp.array(x0))
    got = tl.polish_poly_roots(_t(coeffs), _t(x0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_kabsch_matches_jax_and_sanitizes():
    r = np.random.default_rng(2)
    Rg = np.stack([_rotation(r.normal(size=3)) for _ in range(32)])
    src = r.normal(size=(32, 10, 3)) * np.array([3.0, 2.0, 1.0])  # distinct singular values
    dst = np.einsum("bij,bnj->bni", Rg, src) + r.normal(size=(32, 1, 3))
    dst += r.normal(scale=1e-3, size=dst.shape)
    w = r.uniform(0.5, 1.0, (32, 10))
    src, dst, w = (a.astype(np.float32) for a in (src, dst, w))
    jR, jt, jv = jax.vmap(jl.kabsch)(jnp.array(src), jnp.array(dst), jnp.array(w))
    tR, tt, tv = tl.kabsch(_t(src), _t(dst), _t(w))
    assert tv.numpy().all() and np.asarray(jv).all()
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tR.numpy(), Rg, atol=1e-3)
    # Rank 2: three points, the rotation still determined.
    tR3, tt3, tv3 = tl.kabsch(_t(src[:, :3]), _t(dst[:, :3]), torch.ones(32, 3))
    jR3, _, _ = jax.vmap(jl.kabsch)(jnp.array(src[:, :3]), jnp.array(dst[:, :3]),
                                    jnp.ones((32, 3)))
    assert tv3.numpy().all()
    np.testing.assert_allclose(tR3.numpy(), np.asarray(jR3), atol=1e-3)
    np.testing.assert_allclose(tR3.numpy(), Rg, atol=1e-2)
    # A non-finite problem is invalid, and the SVD does not see it.
    bad = src.copy()
    bad[0, 0, 0] = np.nan
    _, _, v = tl.kabsch(_t(bad), _t(dst), _t(w))
    assert not v[0] and v[1:].all()


def test_p3p_recovers_pose_and_matches_jax():
    """tests/test_solvers.py::test_p3p_recovers_pose on the port, then the
    port's four solutions against the JAX solver's on well-spread samples
    of the same scene."""
    data, Rm, t = _pnp_scene(50, seed=15)
    tf = get_family("pnp")
    descs, valid = tf.minimal_solver_batched(_t(data[None, :3]))
    assert descs.shape == (1, 4, 12) and bool(valid.any())
    r2 = tf.squared_residual(_t(data), descs[0])
    med = torch.where(valid[0], r2.median(-1).values, torch.inf)
    assert float(med.min()) < 1e-4

    r = np.random.default_rng(3)
    samples = data[r.integers(0, 50, (256, 3))]
    jd, jv = jax.vmap(jfamily("pnp").minimal_solver)(jnp.array(samples))
    td, tv = tf.minimal_solver_batched(_t(samples))
    jd, jv = np.asarray(jd), np.asarray(jv)
    ok = jv & tv.numpy()
    # Validity agrees but for borderline roots (a root's sign or a
    # quartic's discriminant within float32 rounding of zero).
    assert np.mean(jv == tv.numpy()) >= 0.99 and ok.sum() > 200
    poses_t = td.numpy()[ok].reshape(-1, 3, 4)
    poses_j = jd[ok].reshape(-1, 3, 4)
    # On the well-conditioned solutions (a JAX rotation with det 1 to
    # 1e-3; P3P on a near-collinear triple is ill-posed in float32) the
    # poses agree.
    cond = np.abs(np.linalg.det(poses_j[:, :, :3]) - 1.0) < 1e-3
    close = np.abs(poses_t - poses_j).max((1, 2)) < 1e-3
    assert np.mean(close[cond]) >= 0.95


def test_dlt_matches_jax():
    """tests/test_solvers.py::test_pnp_nonminimal_weighted on the port, and
    its pose against the JAX DLT's; a zero-weight problem is invalid."""
    data, Rm, t = _pnp_scene(60, seed=16, noise=1e-3)
    junk = np.random.default_rng(17).uniform(-1, 1, (20, 5)).astype(np.float32)
    full = np.concatenate([data, junk])
    w = np.stack([np.r_[np.ones(60), np.zeros(20)],
                  np.r_[np.random.default_rng(4).uniform(0.5, 1, 60), np.zeros(20)],
                  np.zeros(80)]).astype(np.float32)
    jd, jv = jax.vmap(jfamily("pnp").nonminimal_solver, in_axes=(None, 0))(
        jnp.array(full), jnp.array(w))
    td, tv = get_family("pnp").nonminimal_solver(_t(full), _t(w))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.numpy().tolist() == [True, True, False]
    P = td.numpy()[0].reshape(3, 4)
    assert np.abs(P[:, :3] - Rm).max() < 2e-2 and np.abs(P[:, 3] - t).max() < 5e-2
    np.testing.assert_allclose(td.numpy()[:2], np.asarray(jd)[:2], rtol=1e-3, atol=1e-3)


def test_refine_and_so3_exp_match_jax():
    data, Rm, t = _pnp_scene(80, seed=18, noise=2e-3)
    r = np.random.default_rng(5)
    inits = np.stack([_pose(Rm @ _rotation(r.normal(size=3) * 0.05),
                            t + r.normal(scale=0.05, size=3)) for _ in range(4)])
    w = r.uniform(0.0, 1.0, (4, 80)).astype(np.float32)
    w[3] = 0.0
    w[3, :2] = 1.0  # fewer than three points: keeps its start
    jd, jv = jax.vmap(jpnp._refine, in_axes=(None, 0, 0))(
        jnp.array(data), jnp.array(w), jnp.array(inits))
    td, tv = tpnp._refine(_t(data), _t(w), _t(inits))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(td.numpy()[3], inits[3])
    for P in td.numpy()[:3].reshape(-1, 3, 4):
        assert np.abs(P[:, :3] - Rm).max() < 5e-3
    wv = r.normal(size=(16, 3)).astype(np.float32)
    wv[0] = 0.0
    np.testing.assert_allclose(tpnp._so3_exp(_t(wv)).numpy(),
                               np.asarray(jax.vmap(jpnp._so3_exp)(jnp.array(wv))),
                               rtol=1e-5, atol=1e-6)


def test_residual_matches_jax_and_rejects_points_behind():
    data, Rm, t = _pnp_scene(40, seed=14)
    behind = _pose(Rm, -t)  # every point behind the camera
    descs = np.stack([_pose(Rm, t), behind,
                      _pose(_rotation(np.array([0.1, 0.2, 0.3])), t + 0.3)])
    want = jax.vmap(jfamily("pnp").squared_residual, in_axes=(None, 0))(
        jnp.array(data), jnp.array(descs))
    got = get_family("pnp").squared_residual(_t(data), _t(descs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-9)
    assert float(got[0].max()) < 1e-5
    assert (got[1].numpy() == 1e18).all()


def _fusion_scene(Rs, ts, n_per=40):
    """tests/test_pose_fusion._scene."""
    r = np.random.default_rng(0)
    xyz, norm_xy, labels = [], [], []
    for i, (R, t) in enumerate(zip(Rs, ts)):
        X = r.uniform(-0.5, 0.5, (n_per, 3))
        Xc = X @ R.T + t
        xyz.append(X)
        norm_xy.append(Xc[:, :2] / Xc[:, 2:3])
        labels += [i] * n_per
    descs = np.stack([np.concatenate([R, t[:, None]], 1).reshape(12) for R, t in zip(Rs, ts)])
    return descs, np.array(labels), np.concatenate(norm_xy), np.concatenate(xyz)


def _rot_z(deg):
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def test_fuse_pose_duplicates_matches_jax():
    """The three cases of tests/test_pose_fusion.py: duplicates fuse,
    distinct poses stay apart, and no transitive chaining."""
    t0 = np.array([0.0, 0.0, 4.0])
    cases = [
        ([_rot_z(0.0), _rot_z(8.0)], [t0, np.array([0.0, 0.01, 4.0])], None, 1),
        ([_rot_z(0.0), _rot_z(90.0)], [t0, np.array([1.0, 0.0, 4.0])], None, 2),
        ([_rot_z(-25.0), _rot_z(0.0), _rot_z(25.0)], [t0, t0, t0],
         np.concatenate([[0] * 30, [1] * 10, [1] * 40, [2] * 30, [0] * 10]), 2),
    ]
    for Rs, ts, labels, k in cases:
        descs, lab, norm_xy, xyz = _fusion_scene(Rs, ts)
        lab = lab if labels is None else labels
        got = api._fuse_pose_duplicates(descs, lab, norm_xy, xyz, 0.01)
        want = japi._fuse_pose_duplicates(descs, lab, norm_xy, xyz, 0.01)
        assert got[0].shape[0] == want[0].shape[0] == k
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_load_tless_scene_and_pose_errors():
    xy, xyz, K, gt = load_tless_scene()
    assert xy.shape == (1886, 2) and xyz.shape == (1886, 3)
    assert K.shape == (3, 3) and K[0, 0] > 1000 and gt.shape == (2, 3, 4)
    for got, want in zip((xy, xyz, K, gt), jload_tless()):
        np.testing.assert_array_equal(got, want)
    errs = pose_errors([gt[1], gt[0]], gt)
    np.testing.assert_allclose(errs, [(0.0, 0.0), (0.0, 0.0)], atol=1e-4)
    assert pose_errors([], gt) == [(np.inf, np.inf)] * 2


def _scorer_case(rows=2, n=300, b=48, seed=5):
    """`rows` noisy pose scenes of `_pnp_scene` (padded rows masked out)
    and b P3P poses of random three-point samples a row, with a compound
    preference and the compound penalty on in row 0 only; residuals of the
    good poses straddle the threshold (noise 0.01, tau_t^2 4e-4)."""
    r = np.random.default_rng(seed)
    data = np.stack([_pnp_scene(n, seed=seed + i, noise=0.01)[0] for i in range(rows)])
    idx = r.integers(0, n, (rows, b // 4, 3))
    descs = np.stack([np.asarray(tpnp._minimal_batched(_t(d[i]))[0]).reshape(-1, 12)
                      for d, i in zip(data, idx)])
    compound = r.uniform(0, 1, (rows, n)).astype(np.float32)
    pmask = r.uniform(size=(rows, n)) > 0.1
    trunc_sq = np.full(rows, 4e-4, np.float32)
    has = np.arange(rows) == 0
    return data, descs, compound, pmask, trunc_sq, has


@pytest.mark.parametrize("magsac_levels", [0, 4])
@pytest.mark.parametrize("row_axis", [True, False])
def test_scorer_on_cpu_is_the_residual_scorer(magsac_levels, row_axis):
    """The family's scorer (kernels/scoring.score_pnp) on CPU tensors is
    the plain `residual_scorer` over `_squared_residual` that scored poses
    before the kernel, bit for bit, with and without the row axis: the
    parity tests of the pose fit hold the same code as before."""
    from progressivex_tpu_torch.ops.scoring import residual_scorer

    case = _scorer_case()
    if not row_axis:
        case = [c[0] for c in case]
    data, descs, compound, pmask, trunc_sq, has = (_t(c) for c in case)
    got = get_family("pnp").scorer(data, descs, compound, pmask, trunc_sq, 2.0, has,
                                   magsac_levels)
    want = residual_scorer(tpnp._squared_residual)(data, descs, compound, pmask,
                                                   trunc_sq, 2.0, has, magsac_levels)
    assert int(want[1].max()) > 10 and int(want[1].min()) < int(want[1].max())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("magsac_levels", [0, 4])
def test_scores_match_jax(magsac_levels):
    """The pose scorer against the JAX engine's: `compound_penalized_scores`
    over the vmapped JAX residual, row by row. Inlier counts exact; scores,
    dots and norms rtol 1e-3, atol 1e-2 (tests/test_torch_scoring.py's
    tolerance, for float32 sums taken in another order)."""
    from progressivex_tpu.ops import scoring as jscoring

    data, descs, compound, pmask, trunc_sq, has = _scorer_case()
    got = get_family("pnp").scorer(_t(data), _t(descs), _t(compound), _t(pmask),
                                   _t(trunc_sq), 2.0, _t(has), magsac_levels)
    for r in range(data.shape[0]):
        r2 = jax.vmap(jfamily("pnp").squared_residual, in_axes=(None, 0))(
            jnp.array(data[r]), jnp.array(descs[r]))
        want = jscoring.compound_penalized_scores(
            r2, jnp.array(compound[r]), jnp.array(pmask[r]), float(trunc_sq[r]), 2.0,
            bool(has[r]), magsac_levels=magsac_levels)
        for g, w, name in zip(got, want, ("scores", "inliers", "dots", "norms")):
            g, w = g[r].numpy(), np.asarray(w)
            if name == "inliers":
                np.testing.assert_array_equal(g, w, err_msg=name)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-2, err_msg=name)
