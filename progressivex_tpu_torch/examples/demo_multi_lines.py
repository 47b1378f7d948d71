"""Multi 2D-line demo on a synthetic edge-point scene, on the card — the
port's counterpart of examples/demo_multi_lines.py (the reference's
`examples/example_multi_lines.ipynb` workload: a wireframe of known lines
plus clutter).

  python -m progressivex_tpu_torch.examples.demo_multi_lines [n_lines per_line outliers seed device]
"""

import sys
import time

import numpy as np

from progressivex_tpu_torch import findLines
from progressivex_tpu_torch.io.metrics import misclassification


def main(n_lines=7, per_line=400, outliers=400, seed=0, device=None):
    r = np.random.default_rng(int(seed))
    pts, gt = [], []
    for li in range(int(n_lines)):
        p0 = r.uniform(0, 500, 2)
        ang = r.uniform(0, np.pi)
        d = np.array([np.cos(ang), np.sin(ang)])
        t = r.uniform(0, 400, int(per_line))
        p = p0 + t[:, None] * d + r.normal(scale=0.7, size=(int(per_line), 2))
        pts.append(p)
        gt += [li + 1] * int(per_line)
    pts.append(r.uniform(0, 600, (int(outliers), 2)))
    gt += [0] * int(outliers)
    data = np.concatenate(pts)
    perm = r.permutation(len(data))
    data, gt = data[perm], np.array(gt)[perm]

    t0 = time.perf_counter()
    lines, labeling = findLines(
        data, threshold=2.0, conf=0.5, minimum_point_number=50,
        sampler_id=0, maximum_model_number=12, do_logging=True, device=device,
    )
    dt = time.perf_counter() - t0
    print(f"{lines.shape[0]} lines from {len(data)} points in {dt:.3f}s "
          f"(ME vs GT: {misclassification(labeling, gt):.3f})")
    print(np.round(lines, 4))


if __name__ == "__main__":
    main(*sys.argv[1:])
