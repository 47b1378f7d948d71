"""The port's public surface: `findHomographies` on the CPU against the
JAX package, device resolution, `convert`, import isolation from JAX,
and the size of the tracked tree.

Tolerance of the end-to-end check: ME within 0.03 of the JAX package's
on the same scene and seed. The port draws its own samples from a
torch.Generator, so its run is another random run of the same
algorithm, not a replay.
"""

import ast
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from progressivex_tpu.core.config import EngineConfig as JConfig
from progressivex_tpu.core.config import make_params as jmake_params

from progressivex_tpu_torch import convert
from progressivex_tpu_torch._device import resolve_device
from progressivex_tpu_torch.core.config import EngineConfig, make_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREE_LIMIT_BYTES = 8 * 1000 * 1000


def test_find_homographies_cpu_oldclassicswing_me():
    """The bundled AdelaideRMF-H scene under the H protocol: the port on
    the CPU against the JAX package on the CPU, both at seed 0."""
    from progressivex_tpu import findHomographies as jfind
    from progressivex_tpu.eval.adelaide import H_PROTOCOL as J_H_PROTOCOL
    from progressivex_tpu.io.data import load_corr_scene as jload
    from progressivex_tpu.io.metrics import misclassification as jme

    from progressivex_tpu_torch import findHomographies
    from progressivex_tpu_torch.eval.adelaide import H_PROTOCOL, scene_kwargs
    from progressivex_tpu_torch.io.data import load_corr_scene
    from progressivex_tpu_torch.io.metrics import misclassification

    corrs, gt = load_corr_scene("oldclassicswing")
    jcorrs, jgt = jload("oldclassicswing")
    np.testing.assert_array_equal(corrs, jcorrs)
    np.testing.assert_array_equal(gt, jgt)
    assert H_PROTOCOL == J_H_PROTOCOL
    kw = scene_kwargs(len(gt))
    assert "split_pass" not in kw  # 379 points pad to 384 < 512

    H, labels, stats = findHomographies(corrs, **kw, random_seed=0, device="cpu",
                                        with_statistics=True)
    me = misclassification(labels, gt)
    _, jlabels = jfind(corrs, **kw, random_seed=0)
    j_me = jme(jlabels, jgt)
    assert H.shape == (3 * stats.model_number, 3) and np.isfinite(H).all()
    assert labels.shape == gt.shape
    assert len(stats.iterations) == stats.rounds_run > 0
    assert abs(me - j_me) <= 0.03, (me, j_me)
    assert me == pytest.approx(misclassification(labels, gt))


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    from progressivex_tpu_torch import findHomographies

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    corrs = np.random.default_rng(0).uniform(0, 100, (40, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        findHomographies(corrs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.fit_state(np.zeros((2, 9)), np.zeros(2, bool), np.zeros(4),
                          np.zeros(4), device=None)


def test_convert_carries_config_and_params():
    jcfg = JConfig(family="homography", n_hypotheses=96, max_rounds=3,
                   magsac_levels=4, split_pass=1)
    cfg = convert.engine_config(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(EngineConfig(family="homography")) == \
        dataclasses.asdict(JConfig(family="homography"))
    jp = jmake_params(threshold=3.0, confidence=0.9, min_inliers=20, n_valid=77)
    p = convert.runtime_params(jp._asdict())
    for name, value in jp._asdict().items():
        got = getattr(p, name)
        assert got == np.asarray(value) and got.dtype == np.asarray(value).dtype, name
    assert make_params()._fields == jp._fields
    with pytest.raises(ValueError, match="lacks"):
        convert.engine_config({"family": "homography", "no_such_field": 1})
    state = convert.fit_state(np.ones((2, 9)), [True, False], [0, 2, 1],
                              np.zeros(3), device="cpu")
    assert state["descs"].dtype == torch.float32
    assert state["labels"].dtype == torch.int64
    assert state["active"].tolist() == [True, False]


def _port_files():
    pkg = os.path.join(REPO, "progressivex_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tools", "profile_torch_fit.py"),
             os.path.join(REPO, "tools", "score_golden.py")]
    for root, _, names in os.walk(pkg):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_nothing_of_jax():
    forbidden = ("jax", "jaxlib", "progressivex_tpu")
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in forbidden, f"{path}: imports {name}"
    code = ("import sys, progressivex_tpu_torch, progressivex_tpu_torch.eval.adelaide, "
            "progressivex_tpu_torch.convert, progressivex_tpu_torch.kernels._build, "
            "progressivex_tpu_torch.models.fundamental, progressivex_tpu_torch.api_batch, "
            "progressivex_tpu_torch.cli, progressivex_tpu_torch.eval.extras; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'progressivex_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_tracked_tree_is_small_and_holds_no_compile_cache():
    if shutil.which("git") is None or not os.path.isdir(os.path.join(REPO, ".git")):
        pytest.skip("needs git and a checkout")
    files = subprocess.run(["git", "ls-files", "-z"], cwd=REPO, capture_output=True,
                           check=True, timeout=120).stdout.decode().split("\0")
    files = [f for f in files if f]
    assert not [f for f in files if f.startswith(".jax_cache/")]
    total = sum(os.path.getsize(os.path.join(REPO, f)) for f in files
                if os.path.isfile(os.path.join(REPO, f)))
    assert total < TREE_LIMIT_BYTES, total
    assert not [f for f in files if f.endswith((".so", ".o"))]
