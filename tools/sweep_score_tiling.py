#!/usr/bin/env python3
"""Times the scoring kernels of the PyTorch/CUDA port over their tilings on
one NVIDIA GPU: every (K hypotheses a block, S blocks a cluster, threads a
block) at the shapes the ported paths launch, each checked against the
plain version (inliers exact) before it is timed by CUDA-graph replay. It
shows where kernels/scoring._tiling's choice stands among the others.

  python3 tools/sweep_score_tiling.py [--out sweep_score_tiling.json]

Prints the card (nvidia-smi), the launch floor and, for each shape, the
five fastest tilings and the chosen one; --out gets every row.
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the kernel-case helpers)

# (kernel, scene, B values, tau_t^2 (None: the path's own), exponent)
SHAPES = (
    ("score_homography", "oldclassicswing", (256, 4), 36.0, 2.0),
    ("score_homography", "unihouse", (256, 4), 36.0, 2.0),
    ("score_homography", chip_smoke.SYNTHETIC, (256, 4), 36.0, 2.0),
    ("score_fundamental", "cubetoy", (1536, 4), None, 1.0),
    ("score_pnp", "tless", (1600, 4), None, 2.0),
)
TILINGS = [(k, s, t) for k in (1, 2, 4) for s in (1, 2, 4, 8) for t in (128, 256)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("sweep_score_tiling.py: no CUDA device", file=sys.stderr)
        return 2
    from progressivex_tpu_torch.core.config import truncated_sq_threshold
    from progressivex_tpu_torch.kernels import _build
    from progressivex_tpu_torch.kernels import scoring as ks
    from progressivex_tpu_torch.models import get_family

    smi = chip_smoke._smi()
    print(smi, flush=True)
    _build.build_all()
    dev = torch.device("cuda")
    n_sms = ks._sm_count(dev)
    floor = torch.zeros(1, device=dev)
    floor_ms = chip_smoke._device_ms(floor.zero_)
    print(f"launch floor ms {floor_ms:.6f}, SMs {n_sms}", flush=True)
    rng = np.random.default_rng(0)
    rows = []
    for name, scene, sizes, trunc_sq, exponent in SHAPES:
        if trunc_sq is None:  # F's 0.75 px; the pose fit's 4 px over the focal length
            trunc_sq = float(truncated_sq_threshold(
                chip_smoke._tless_threshold() if name == "score_pnp" else 0.75))
        family = get_family(name.removeprefix("score_"))
        kernel = _build.entry_point(name, ks._ARGS)
        data, pmask, compound, n = chip_smoke._scene_tensors(torch, dev, scene, rng)
        n_pad = data.shape[0]
        descs = chip_smoke._minimal_descs(torch, family, data, n, max(sizes), rng)
        for b in sizes:
            d = descs[:b].contiguous()
            want = getattr(ks, f"{name}_plain")(data, d, compound, pmask, trunc_sq,
                                               exponent, True, 4)
            outs = [torch.empty(b, device=dev) for _ in range(3)]
            inl = torch.empty(b, dtype=torch.int32, device=dev)
            tau = torch.full((1,), trunc_sq, device=dev)
            has = torch.ones(1, dtype=torch.bool, device=dev)
            chosen = ks._tiling(b, n_pad, n_sms)
            shape_rows = []
            for tiling in TILINGS:
                def launch(tiling=tiling):
                    err = kernel(data.data_ptr(), compound.data_ptr(), pmask.data_ptr(),
                                 d.data_ptr(), 1, b, n_pad, tau.data_ptr(),
                                 has.data_ptr(), exponent, 4,
                                 *tiling, outs[0].data_ptr(), inl.data_ptr(),
                                 outs[1].data_ptr(), outs[2].data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name} {tiling}: CUDA error {err}")

                launch()
                torch.cuda.synchronize()
                if not torch.equal(inl, want[1]) or not torch.allclose(
                        outs[0], want[0], rtol=1e-3, atol=1e-2):
                    raise AssertionError(f"{name} {tiling} at [{b}, {n_pad}] "
                                         "disagrees with the plain version")
                row = {"kernel": name, "scene": scene, "shape": [b, n_pad],
                       "tiling": list(tiling), "chosen": tiling == chosen,
                       "ms": chip_smoke._device_ms(launch)}
                shape_rows.append(row)
            shape_rows.sort(key=lambda r: r["ms"])
            print(f"{name} [{b}, {n_pad}] ({scene}): chosen {list(chosen)} "
                  f"{next(r['ms'] for r in shape_rows if r['chosen']):.6f} ms; fastest "
                  + ", ".join(f"{r['tiling']} {r['ms']:.6f}" for r in shape_rows[:5]),
                  flush=True)
            rows += shape_rows
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": smi, "launch_floor_ms": floor_ms, "rows": rows}, f,
                      indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
