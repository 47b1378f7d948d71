"""The port's demos (`progressivex_tpu_torch/examples`), on the CPU.

The vanishing-point demo runs end to end with device="cpu" on the JAX
demo's scene: three vanishing points, each within 5% of its ground-truth
position, and the labeling within the JAX package's misclassification on
the same scene + 0.03 (the same samples, parted by rounding). Every demo is a
counterpart of one in examples/ and takes a `device` argument.
"""

import importlib
import importlib.util
import inspect
import os

import numpy as np
import pytest

from progressivex_tpu_torch.io.metrics import misclassification

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMOS = ("demo_multi_homography", "demo_multi_two_view_motion", "demo_multi_lines",
         "demo_multi_vanishing_point", "demo_multi_pose6d", "demo_real_images")
ME_SLACK = 0.03


def _jax_demo(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", DEMOS)
def test_demo_has_a_jax_counterpart_and_a_device(name):
    mod = importlib.import_module(f"progressivex_tpu_torch.examples.{name}")
    assert os.path.isfile(os.path.join(REPO, "examples", f"{name}.py"))
    params = inspect.signature(mod.main).parameters
    assert "device" in params and params["device"].default is None


def test_vanishing_point_demo_on_cpu(capsys):
    from progressivex_tpu_torch.examples import demo_multi_vanishing_point as demo

    jdemo = _jax_demo("demo_multi_vanishing_point")
    lines, gt, vps_gt = demo.make_scene()
    j_lines, j_gt, _ = jdemo.make_scene()
    np.testing.assert_array_equal(lines, j_lines)
    np.testing.assert_array_equal(gt, j_gt)

    vps, labeling, gt_out = demo.main(device="cpu")
    np.testing.assert_array_equal(gt_out, gt)
    assert vps.shape == (3, 3)
    pos = vps[:, :2] / vps[:, 2:3]
    for v in vps_gt:
        err = np.linalg.norm(pos - v, axis=1).min() / np.linalg.norm(v)
        assert err < 0.05, (v, pos)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from progressivex_tpu import findVanishingPoints as jfind

    _, j_labels = jfind(lines, threshold=1.5, conf=0.5, spatial_coherence_weight=0.0,
                        neighborhood_ball_radius=200.0, maximum_tanimoto_similarity=0.4,
                        max_iters=1000, minimum_point_number=15, maximum_model_number=5,
                        sampler_id=0, scoring_exponent=2)
    assert misclassification(labeling, gt) <= misclassification(j_labels, gt) + ME_SLACK
    assert "3 vanishing points" in capsys.readouterr().out
