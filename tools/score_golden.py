#!/usr/bin/env python3
"""Scores fixed inputs with a checkout's CUDA scoring kernels and saves the
inputs and the four outputs, so that another version of the kernels can be
held to them bit for bit (tests/test_torch_kernels_cuda.py).

  python3 tools/score_golden.py --root <checkout> --out <file.npz>

The inputs are made here with numpy from fixed seeds, at the shapes the H
and F paths launch (H [256 | 4, 2304] and [256, 384], F [1536 | 4, 256]).
Each case is scored through `<checkout>/progressivex_tpu_torch/kernels/
scoring.score_<family>_cuda` in its one-problem form (data [N, 4],
descs [B, 9], scalar threshold and flag), at magsac_levels 0 and 4 and
with the compound penalty on and off. Needs a CUDA device and nvcc.
"""

import argparse
import os
import sys

import numpy as np

# (family, B, N, valid points): the path shapes.
CASES = (("homography", 256, 2304, 2084), ("homography", 4, 2304, 2084),
         ("homography", 256, 384, 379), ("fundamental", 1536, 256, 249),
         ("fundamental", 4, 256, 249))
TRUNC_SQ = {"homography": 36.0, "fundamental": 1.265625}
EXPONENT = {"homography": 2.0, "fundamental": 1.0}


def case_inputs(family, b, n, n_valid, seed):
    """data [n, 4], descs [b, 9], compound [n], mask [n] (numpy), made from
    `seed`: points in a 1000 px square, descriptors near the identity
    (homography) or a rank-2 matrix plus noise (fundamental), about 15% of
    the valid points and all padding masked."""
    r = np.random.default_rng(seed)
    data = r.uniform(0, 1000, (n, 4)).astype(np.float32)
    data[:, 2:] = data[:, :2] + r.normal(0, 3.0, (n, 2))
    data[n_valid:] = 0.0
    if family == "homography":
        h = np.eye(3)[None] + r.normal(0, [[1e-3, 1e-3, 2.0], [1e-3, 1e-3, 2.0],
                                           [1e-6, 1e-6, 0.0]], (b, 3, 3))
    else:
        t = r.normal(0, 1, (b, 3))
        skew = np.zeros((b, 3, 3))
        skew[:, 0, 1], skew[:, 0, 2], skew[:, 1, 2] = -t[:, 2], t[:, 1], -t[:, 0]
        skew = skew - skew.transpose(0, 2, 1)
        h = skew + r.normal(0, 0.01, (b, 3, 3))
        h = h / np.linalg.norm(h.reshape(b, 9), axis=1)[:, None, None]
    descs = h.reshape(b, 9).astype(np.float32)
    compound = r.uniform(0, 1, n).astype(np.float32)
    mask = (np.arange(n) < n_valid) & (r.uniform(size=n) > 0.15)
    return data, descs, compound, mask


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", required=True, help="checkout whose kernels to run")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from progressivex_tpu_torch.kernels import scoring

    dev = torch.device("cuda")
    saved = {}
    for c, (family, b, n, n_valid) in enumerate(CASES):
        inputs = case_inputs(family, b, n, n_valid, seed=c)
        for name, a in zip(("data", "descs", "compound", "mask"), inputs):
            saved[f"{c}/{name}"] = a
        t = [torch.as_tensor(a, device=dev) for a in inputs]
        fn = getattr(scoring, f"score_{family}_cuda")
        for m in (0, 4):
            for has in (False, True):
                out = fn(*t, TRUNC_SQ[family], EXPONENT[family], has, m)
                for name, o in zip(("scores", "inliers", "dots", "norms"), out):
                    saved[f"{c}/m{m}/has{int(has)}/{name}"] = o.cpu().numpy()
    np.savez_compressed(args.out, **saved)
    print(f"wrote {len(saved)} arrays of {len(CASES)} cases to {args.out}")


if __name__ == "__main__":
    main()
