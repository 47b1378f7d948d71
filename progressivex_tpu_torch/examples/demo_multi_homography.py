"""Multi-homography demo on a bundled AdelaideRMF-H scene, on the card —
the port's counterpart of examples/demo_multi_homography.py (the
reference's `examples/example_multi_homography.ipynb`, protocol from
`dataset_comparison/adelaideH.ipynb` cell 3).

  python -m progressivex_tpu_torch.examples.demo_multi_homography [scene] [device]
"""

import sys
import time

import numpy as np

from progressivex_tpu_torch import findHomographies
from progressivex_tpu_torch.io.data import load_corr_scene
from progressivex_tpu_torch.io.metrics import misclassification


def main(scene="oldclassicswing", device=None):
    corrs, gt = load_corr_scene(scene)
    t0 = time.perf_counter()
    homographies, labeling = findHomographies(
        corrs, 0, 0, 0, 0,
        threshold=4.0, conf=0.5, spatial_coherence_weight=0.05,
        neighborhood_ball_radius=200.0, maximum_tanimoto_similarity=0.4,
        max_iters=1000, minimum_point_number=10, maximum_model_number=6,
        sampler_id=3, scoring_exponent=2, do_logging=True, device=device,
    )
    dt = time.perf_counter() - t0
    k = homographies.shape[0] // 3
    print(f"{scene}: {k} homographies in {dt:.3f}s "
          f"(ME vs GT: {misclassification(labeling, gt):.3f})")
    for i in range(k):
        print(f"H[{i}] =\n{np.round(homographies[3 * i:3 * i + 3], 4)}")


if __name__ == "__main__":
    main(*sys.argv[1:])
