"""The port's `findTwoViewMotions` on the CPU against the JAX package's,
and its protocol, input checks and device default.

Tolerance of the end-to-end check: ME within 0.03 of the JAX package's on
the same scene and seed. The port draws the JAX package's samples for
the seed (ops/prng.py), so the two runs part only where float32
rounding does. This file is apart from tests/test_torch_fundamental.py so
that the two JAX F compiles run on different test workers.
"""

import numpy as np
import pytest
import torch


def test_find_two_view_motions_cpu_book_me():
    """The bundled AdelaideRMF-F scene book under the F protocol: the port
    on the CPU against the JAX package on the CPU, both at seed 0."""
    from progressivex_tpu import findTwoViewMotions as jfind
    from progressivex_tpu.eval.adelaide import F_PROTOCOL as J_F_PROTOCOL
    from progressivex_tpu.io.data import ADELAIDE_F_SCENES as J_F_SCENES
    from progressivex_tpu.io.metrics import misclassification as jme

    from progressivex_tpu_torch import findTwoViewMotions
    from progressivex_tpu_torch.eval.adelaide import F_PROTOCOL, scene_kwargs
    from progressivex_tpu_torch.io.data import ADELAIDE_F_SCENES, load_corr_scene
    from progressivex_tpu_torch.io.metrics import misclassification

    assert F_PROTOCOL == J_F_PROTOCOL
    assert ADELAIDE_F_SCENES == J_F_SCENES
    corrs, gt = load_corr_scene("book")
    kw = scene_kwargs(len(gt), "F")
    assert kw == F_PROTOCOL

    F, labels, stats = findTwoViewMotions(corrs, **kw, random_seed=0, device="cpu",
                                          with_statistics=True)
    me = misclassification(labels, gt)
    _, jlabels = jfind(corrs, **kw, random_seed=0)
    j_me = jme(jlabels, gt)
    assert F.shape == (3 * stats.model_number, 3) and np.isfinite(F).all()
    assert labels.shape == gt.shape
    assert len(stats.restart_energies) == F_PROTOCOL["n_restarts"]
    assert 0 <= stats.restart < F_PROTOCOL["n_restarts"]
    assert 0 < stats.rounds_run <= F_PROTOCOL["max_rounds"]
    assert abs(me - j_me) <= 0.03, (me, j_me)


def test_find_two_view_motions_checks_input_and_device(monkeypatch):
    from progressivex_tpu_torch import findTwoViewMotions

    corrs = np.random.default_rng(0).uniform(0, 100, (40, 4))
    with pytest.raises(ValueError, match="n>=7"):
        findTwoViewMotions(corrs[:6], device="cpu")
    with pytest.raises(ValueError, match="dims"):
        findTwoViewMotions(corrs[:, :3], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        findTwoViewMotions(corrs)


def test_hypothesis_budget_and_scene_kwargs():
    """F proposals take 512 seven-point samples (3 roots each) per round,
    the JAX package's cap; H keeps its split-pass gate."""
    from progressivex_tpu.api import _hyp_budget as j_budget

    from progressivex_tpu_torch.api import _hyp_budget
    from progressivex_tpu_torch.eval.adelaide import scene_kwargs

    assert _hyp_budget(10000, 3, "fundamental") == j_budget(10000, 3, "fundamental") == 512
    assert _hyp_budget(1000, 1, "homography") == j_budget(1000, 1, "homography") == 256
    assert "split_pass" not in scene_kwargs(379, "H")
    assert scene_kwargs(2084, "H")["split_pass"] == 1
    assert "split_pass_min_npad" not in scene_kwargs(2084, "H")
