#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (progressivex_tpu_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each of which raises on failure:
  1. prints the card (nvidia-smi) and builds the CUDA kernels from csrc/,
     one nvcc per source, all at once;
  2. holds each kernel (score_homography, score_fundamental) against its
     plain torch version on the card at its path's shapes, and times both;
  3. drives the two ported paths on their bundled scenes, each with the
     launch counts set to 0 just before it and read just after:
     findHomographies under the AdelaideRMF-H protocol and
     findTwoViewMotions under the AdelaideRMF-F protocol; checks each
     scene's misclassification against the JAX package's and that the
     path's kernel ran;
  4. fits one scene of each path on the card and on the CPU and compares
     them.
It ends with the total seconds, a {"kernels": [...]} line, the nvidia-smi
line and, last, {"ok": true, "device": {...}}. It needs a CUDA device and the package
beside it, and exits non-zero without either. It imports no JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# The JAX package's misclassification errors on the CPU, seed 0, from
#   JAX_PLATFORMS=cpu PROGX_COMPILE_CACHE=0 python -c "import jax;
#     jax.config.update('jax_platforms', 'cpu');
#     from progressivex_tpu.eval import adelaide;
#     adelaide.download_adelaide = lambda *a, **k: None;
#     print(adelaide.evaluate_scenes('H', seed=0))"
# (bundled scenes; the download is switched off so the run stays offline).
JAX_CPU_ME = {
    "oldclassicswing": 0.0026385224274406704,
    "unionhouse": 0.0060240963855421326,
    "unihouse": 0.06094049904030707,
}
# The same for the F protocol, from the same command with
# evaluate_scenes('F', seed=0).
JAX_CPU_ME_F = {
    "book": 0.0106952,
    "breadcube": 0.0123967,
    "cubetoy": 0.0281124,
}
ME_SLACK = 0.03
LABEL_DISAGREEMENT_MAX = 0.01

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 FLOP/s
# outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12


def _fail(msg):
    print(f"chip_smoke.py: {msg}", file=sys.stderr)
    sys.exit(2)


def _smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _events_ms(run, reps, trials=5):
    """CUDA events around run(), divided by reps; median of trials."""
    import torch

    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def _host_ms(fn, reps=100):
    """Time of one fn() called back to back from Python: what the engine
    pays per call, host launch overhead included."""
    import torch

    fn()
    torch.cuda.synchronize()
    return _events_ms(lambda: [fn() for _ in range(reps)], reps)


def _device_ms(fn, reps=20):
    """Device time of one fn(): reps calls captured in a CUDA graph and
    replayed, so that host launch overhead drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, reps)


# Operations of each family's residual per (hypothesis, valid point).
# Homography, 20: projection 12 (6 mul, 6 add), the |pz| test 1, transfer
# error 7 (2 div, 2 sub, 2 mul, 1 add). Fundamental, 34: F x1 12, F^T x2
# 8, num 4, den 7, square, max and divide 3.
RESIDUAL_OPS = {"homography": 20, "fundamental": 34}


def _score_bound(b, n_valid, n_pts, magsac_levels, family):
    """Least time of one scoring pass on an H100: operations over the f32
    peak against bytes over the HBM rate. Operations per (hypothesis,
    valid point): the residual's (RESIDUAL_OPS), x = r2 / tau_t^2 1,
    pref 2 (sub, max), five sums 9 (raw: add; shared: min, add; inliers:
    compare, add; dot: mul, add; norm: mul, add); with m MAGSAC levels,
    4 m + 1 more (div, sub, max, add per level, one scale by 1/m). Masked
    points are skipped, so only valid points count. Bytes: 24 per point
    (float4 of coordinates, compound and mask), 36 per descriptor and 16
    of outputs per hypothesis."""
    flops_pair = RESIDUAL_OPS[family] + 12 + (4 * magsac_levels + 1 if magsac_levels else 0)
    flops = b * n_valid * flops_pair
    nbytes = n_pts * 24 + b * (36 + 16)
    t_ops = flops / PEAK_F32_FLOP_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _scene_tensors(torch, dev, scene, rng):
    """A bundled scene padded as the API pads it: (data [N, 4], point
    mask [N], a random compound preference [N], valid count)."""
    from progressivex_tpu_torch.api import _pad_to
    from progressivex_tpu_torch.io.data import load_corr_scene

    corrs, _ = load_corr_scene(scene)
    n, n_pad = len(corrs), _pad_to(len(corrs))
    data = torch.zeros(n_pad, 4, dtype=torch.float32, device=dev)
    data[:n] = torch.as_tensor(corrs, dtype=torch.float32, device=dev)
    pmask = torch.arange(n_pad, device=dev) < n
    compound = torch.as_tensor(rng.uniform(0, 1, n_pad), dtype=torch.float32,
                               device=dev) * pmask
    return data, pmask, compound, n


def _minimal_descs(torch, family, data, n, count, rng):
    """`count` finite descriptors of valid minimal solves on random
    samples of the scene's first n points, drawn 4096 samples at a time
    (about one seven-point sample in seven survives the oriented check on
    the F scenes)."""
    found = []
    for _ in range(64):
        idx = torch.as_tensor(rng.integers(0, n, (4096, family.sample_size)),
                              device=data.device)
        descs, valid = family.minimal_solver_batched(data[idx])
        descs = descs.reshape(-1, 9)[valid.reshape(-1)]
        found.append(descs[torch.isfinite(descs).all(1)])
        if sum(len(f) for f in found) >= count:
            return torch.cat(found)[:count].contiguous()
    raise AssertionError("too few valid minimal solves")


def _kernel_cases(torch, dev, name, scenes, sizes, trunc_sq, exponent, rng):
    """The kernel `name` against its plain version, and timed, at every
    (scene, B in sizes, magsac_levels, compound on/off)."""
    from progressivex_tpu_torch.kernels import scoring as ks
    from progressivex_tpu_torch.models import get_family

    family = get_family(name.removeprefix("score_"))
    cuda_fn = getattr(ks, f"{name}_cuda")
    plain_fn = getattr(ks, f"{name}_plain")
    kernel = ks._kernel(name)
    cases, worst_abs = [], 0.0
    for scene in scenes:
        data, pmask, compound, n = _scene_tensors(torch, dev, scene, rng)
        n_pad = data.shape[0]
        descs = _minimal_descs(torch, family, data, n, max(sizes), rng)
        for b in sizes:
            d = descs[:b].contiguous()
            for m in (0, 4):
                for has in (False, True):
                    args = (data, d, compound, pmask, trunc_sq, exponent, has, m)
                    got = cuda_fn(*args)
                    want = plain_fn(*args)
                    torch.cuda.synchronize()
                    if not torch.equal(got[1], want[1]):
                        raise AssertionError(f"{name}: inliers differ at B={b} "
                                             f"N={n_pad} m={m}")
                    err = 0.0
                    for g, w_, what in zip(got, want, ("scores", "inliers", "dots", "norms")):
                        if what == "inliers":
                            continue
                        if not torch.allclose(g, w_, rtol=1e-3, atol=1e-2):
                            raise AssertionError(
                                f"{name}: {what} differ at B={b} N={n_pad} m={m} "
                                f"has={has}: max abs {float((g - w_).abs().max())}")
                        err = max(err, float((g - w_).abs().max()))
                    worst_abs = max(worst_abs, err)
                    pts, pm = data.contiguous(), pmask.to(torch.float32)
                    outs = [torch.empty(b, device=dev) for _ in range(3)]
                    inl = torch.empty(b, dtype=torch.int32, device=dev)

                    def launch():
                        kernel(pts.data_ptr(), compound.data_ptr(), pm.data_ptr(),
                           d.data_ptr(), b, n_pad, trunc_sq, exponent, int(has), m,
                           outs[0].data_ptr(), inl.data_ptr(), outs[1].data_ptr(),
                           outs[2].data_ptr(), torch.cuda.current_stream().cuda_stream)

                    bound, bound_by = _score_bound(b, n, n_pad, m, family.name)
                    case = {
                        "kernel": name, "scene": scene, "shape": [b, n_pad],
                        "n_valid": n, "magsac_levels": m, "has_compound": has,
                        "ms": _device_ms(launch),
                        "plain_ms": _device_ms(lambda: plain_fn(*args)),
                        "wrapper_ms": _host_ms(lambda: cuda_fn(*args)),
                        "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err,
                    }
                    print("kernel case", json.dumps(case), flush=True)
                    cases.append(case)

    # Padding independence (tests/test_pallas_scoring.py:67-77): masked
    # rows corrupted to 1e6 change nothing.
    r = np.random.default_rng(0)
    data = torch.as_tensor(r.uniform(-50, 50, (256, 4)), dtype=torch.float32, device=dev)
    descs = _minimal_descs(torch, family, data, 256, 96, r)
    compound = torch.as_tensor(r.uniform(0, 1, 256), dtype=torch.float32, device=dev)
    pmask = torch.as_tensor(r.uniform(size=256) > 0.15, device=dev)
    base = cuda_fn(data, descs, compound, pmask, 25.0, 2.0, True)
    bad = torch.where(pmask[:, None], data, 1e6)
    got = cuda_fn(bad, descs, compound, pmask, 25.0, 2.0, True)
    for g, b_ in zip(got, base):
        if not torch.allclose(g.double(), b_.double(), rtol=1e-5):
            raise AssertionError(f"{name}: padding rows changed the kernel's result")
    print(f"kernel {name} padding independence ok", flush=True)
    return cases, worst_abs


def phase_kernel(torch, dev):
    """Each kernel against its plain version at its path's shapes: H at
    [256 | 4, 384 | 2304] (proposal sub-batch | LO candidates), F at
    [1536 | 4, 256] (512 seven-point samples x 3 roots | LO candidates)."""
    from progressivex_tpu_torch.core.config import truncated_sq_threshold

    rng = np.random.default_rng(0)
    out = {"score_homography": _kernel_cases(
        torch, dev, "score_homography", ("oldclassicswing", "unihouse"), (256, 4),
        36.0, 2.0, rng)}
    out["score_fundamental"] = _kernel_cases(
        torch, dev, "score_fundamental", ("cubetoy",), (1536, 4),
        float(truncated_sq_threshold(0.75)), 1.0, rng)
    return out


PATHS = {
    # problem: (entry point, kernel, scenes, JAX CPU ME)
    "H": ("findHomographies", "score_homography",
          ("oldclassicswing", "unionhouse", "unihouse"), JAX_CPU_ME),
    "F": ("findTwoViewMotions", "score_fundamental",
          ("book", "breadcube", "cubetoy"), JAX_CPU_ME_F),
}


def _fit(problem, corrs, **kw):
    import progressivex_tpu_torch
    from progressivex_tpu_torch.eval.adelaide import scene_kwargs

    fn = getattr(progressivex_tpu_torch, PATHS[problem][0])
    return fn(corrs, **scene_kwargs(len(corrs), problem), random_seed=0,
              with_statistics=True, **kw)


def phase_main_path(torch, problem):
    """One ported path under its AdelaideRMF protocol on its bundled
    scenes, after one untimed warm-up fit on its first scene, the launch
    counts set to 0 just before each timed scene and read after."""
    from progressivex_tpu_torch.io.data import load_corr_scene
    from progressivex_tpu_torch.io.metrics import misclassification
    from progressivex_tpu_torch.kernels.scoring import LAUNCHES

    _, kernel, scenes, jax_me = PATHS[problem]
    _fit(problem, load_corr_scene(scenes[0])[0])  # warm-up
    torch.cuda.synchronize()
    results = {}
    for scene in scenes:
        corrs, gt = load_corr_scene(scene)
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        t0 = time.perf_counter()
        models, labels, stats = _fit(problem, corrs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        me = float(misclassification(labels, gt))
        res = {"problem": problem, "scene": scene, "points": len(gt), "me": me,
               "jax_cpu_me": jax_me[scene], "wall_s": wall,
               "n_models": models.shape[0] // 3, "launches": launches[kernel],
               "other_launches": {k: v for k, v in launches.items() if k != kernel},
               "restart": stats.restart, "restart_energies": stats.restart_energies}
        print("main path", json.dumps(res), flush=True)
        if launches[kernel] <= 0:
            raise AssertionError(f"{scene}: {kernel} never launched")
        if not (models.shape[1] == 3 and models.shape[0] % 3 == 0
                and labels.shape == gt.shape):
            raise AssertionError(f"{scene}: output shapes {models.shape}, {labels.shape}")
        if not np.isfinite(models).all():
            raise AssertionError(f"{scene}: non-finite models")
        if me > jax_me[scene] + ME_SLACK:
            raise AssertionError(f"{scene}: ME {me} above the JAX package's "
                                 f"{jax_me[scene]} + {ME_SLACK}")
        results[scene] = dict(res, labels=labels)
    return results


def phase_card_vs_cpu(results, problem, scene):
    """The same scene through the port on the CPU, against the card."""
    from progressivex_tpu_torch.io.data import load_corr_scene
    from progressivex_tpu_torch.io.metrics import misclassification

    corrs, gt = load_corr_scene(scene)
    models, labels, stats = _fit(problem, corrs, device="cpu")
    cuda = results[scene]
    disagreement = float(np.mean(labels != cuda["labels"]))
    res = {"problem": problem, "scene": scene, "n_models_cuda": cuda["n_models"],
           "n_models_cpu": models.shape[0] // 3, "restart_cuda": cuda["restart"],
           "restart_cpu": stats.restart, "label_disagreement": disagreement,
           "me_cuda": cuda["me"], "me_cpu": float(misclassification(labels, gt))}
    print("card vs cpu", json.dumps(res), flush=True)
    if res["n_models_cpu"] != res["n_models_cuda"]:
        raise AssertionError(f"n_models differ: card {res['n_models_cuda']}, "
                             f"CPU {res['n_models_cpu']}")
    if res["restart_cpu"] != res["restart_cuda"]:
        raise AssertionError(f"winning restarts differ: card {res['restart_cuda']}, "
                             f"CPU {res['restart_cpu']}")
    if disagreement > LABEL_DISAGREEMENT_MAX:
        raise AssertionError(f"labels disagree on {disagreement:.4f} of points")


def _kernel_line(name, cases, worst_abs, results, main_shape, pallas_lines):
    main_case = next(c for c in cases if c["shape"] == main_shape
                     and c["magsac_levels"] == 4 and c["has_compound"])
    return {
        "name": name, "route": "cuda",
        "source": f"progressivex_tpu_torch/csrc/{name}.cu",
        "replaces": "progressivex_tpu/ops/pallas_scoring.py:155",
        "pallas_body": pallas_lines,
        "launches": sum(r["launches"] for r in results.values()),
        "max_abs_err": worst_abs,
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": None,
        "shape": main_case["shape"], "wrapper_ms": main_case["wrapper_ms"],
    }


def main():
    try:
        import torch
    except ImportError:
        _fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        _fail("no CUDA device is available; this script runs the port on a GPU")
    try:
        import progressivex_tpu_torch  # noqa: F401
        from progressivex_tpu_torch.kernels import _build
    except ImportError as e:
        _fail(f"the progressivex_tpu_torch package must sit beside this script ({e})")

    t_start = time.perf_counter()
    smi = _smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build seconds {time.perf_counter() - t0:.3f}", flush=True)
    for name, log in logs.items():
        print(f"nvcc {name}:\n{log.strip()}", flush=True)
    dev = torch.device("cuda")

    kernel_cases = phase_kernel(torch, dev)
    results = {p: phase_main_path(torch, p) for p in ("H", "F")}
    phase_card_vs_cpu(results["H"], "H", "oldclassicswing")
    phase_card_vs_cpu(results["F"], "F", "book")

    kernels = [
        _kernel_line("score_homography", *kernel_cases["score_homography"],
                     results["H"], [256, 2304],
                     "_score_kernel :91-126 + _homography_r2 :70-85"),
        _kernel_line("score_fundamental", *kernel_cases["score_fundamental"],
                     results["F"], [1536, 256],
                     "_score_kernel :91-126 + _sampson_r2 :51-67"),
    ]
    print(f"total seconds {time.perf_counter() - t_start:.3f}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
