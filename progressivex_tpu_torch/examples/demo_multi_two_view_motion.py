"""Multi two-view-motion demo on the bundled AdelaideRMF-F scenes, on the
card — the port's counterpart of examples/demo_multi_two_view_motion.py
(the reference's `examples/example_multi_two_view_motion.ipynb`). Runs the
notebook protocol on book / breadcube / cubetoy and reports each scene's
misclassification against its ground-truth labeling.

  python -m progressivex_tpu_torch.examples.demo_multi_two_view_motion [device]
"""

import sys
import time

from progressivex_tpu_torch import findTwoViewMotions
from progressivex_tpu_torch.io.data import ADELAIDE_F_SCENES, load_corr_scene
from progressivex_tpu_torch.io.metrics import misclassification


def main(device=None):
    for scene in ADELAIDE_F_SCENES:
        corrs, gt = load_corr_scene(scene)
        t0 = time.perf_counter()
        F, labeling = findTwoViewMotions(
            corrs,
            threshold=0.75, conf=0.5, spatial_coherence_weight=0.5,
            neighborhood_ball_radius=50.0, maximum_tanimoto_similarity=0.4,
            max_iters=10000, minimum_point_number=7, maximum_model_number=4,
            sampler_id=2, scoring_exponent=1.0, device=device,
        )
        dt = time.perf_counter() - t0
        k = F.shape[0] // 3
        me = misclassification(labeling, gt)
        print(f"{scene}: {len(gt)} corrs -> {k} motions in {dt:.3f}s, "
              f"misclassification {me:.3f}")


if __name__ == "__main__":
    main(*sys.argv[1:])
