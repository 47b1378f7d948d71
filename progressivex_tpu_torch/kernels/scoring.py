"""Fused proposal scoring: the CUDA kernels of the homography and
fundamental families and their plain torch versions.

The kernels (csrc/score_homography.cu, csrc/score_fundamental.cu, one body
in csrc/score_common.cuh) replace the Pallas TPU kernel
progressivex_tpu/ops/pallas_scoring.py:91-126 (`_score_kernel`, reached
through `fused_scores`) with its two residual functions, `_homography_r2`
and `_sampson_r2`. Each computes `ops/scoring.compound_penalized_scores`
over its family's `_squared_residual` without materializing the [B, N]
residual field. A block scores a tile of K hypotheses against its share of
the points, staged in shared memory; at small B a thread block cluster of
S blocks splits each tile's points. `_tiling` picks K, S and the block
size from B and N so that the grid covers the card's SMs where B allows.
On an H100 the pass is bound by latency and the launch more than by its
operations (32 per (hypothesis, valid point) pair for H, 46 for F, 17 more
with four MAGSAC levels): PERF.md has its times beside its bounds.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. `LAUNCHES` counts kernel launches, incremented at
the one place a launch happens.
"""

from __future__ import annotations

import ctypes
import functools

import torch

LAUNCHES = {"score_homography": 0, "score_fundamental": 0}


def score_homography_plain(data, descs, compound_pref, point_mask, trunc_sq,
                           exponent, has_compound, magsac_levels=0):
    """The function the homography kernel computes, in plain torch."""
    from progressivex_tpu_torch.models.homography import _squared_residual
    from progressivex_tpu_torch.ops.scoring import compound_penalized_scores

    return compound_penalized_scores(
        _squared_residual(data, descs), compound_pref, point_mask, trunc_sq,
        exponent, has_compound, magsac_levels)


def score_fundamental_plain(data, descs, compound_pref, point_mask, trunc_sq,
                            exponent, has_compound, magsac_levels=0):
    """The function the fundamental kernel computes, in plain torch."""
    from progressivex_tpu_torch.models.fundamental import _squared_residual
    from progressivex_tpu_torch.ops.scoring import compound_penalized_scores

    return compound_penalized_scores(
        _squared_residual(data, descs), compound_pref, point_mask, trunc_sq,
        exponent, has_compound, magsac_levels)


def _kernel(name: str):
    """The launch function <name> exported by csrc/<name>.cu, with its
    argument types declared."""
    from progressivex_tpu_torch.kernels import _build

    fn = getattr(_build.load(name), name)
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, vp, vp, ci, ci, cf, cf, ci, ci, ci, ci, ci,
                       vp, vp, vp, vp, vp]
        fn.restype = ci
    return fn


def _tiling(b: int, n: int, n_sms: int):
    """(k_tile, cluster, threads) of a launch over b hypotheses and n
    points on a card with n_sms SMs (tools/sweep_score_tiling.py times the
    alternatives). K, the hypotheses a block scores, is the larger of 4 and
    2 that still leaves two blocks per SM, else 1: more hypotheses a thread
    leave too few blocks to balance the SMs. Where the ceil(b / K)
    hypothesis tiles leave SMs idle, each tile's points are split over a
    cluster of up to 8 blocks of at least 256 points each. A block has 256
    threads if that still gives each thread two points, else 128."""
    k = next((k for k in (4, 2) if -(-b // k) >= 2 * n_sms), 1)
    tiles = -(-b // k)
    cluster = max(1, min(8, -(-n_sms // tiles), n // 256))
    return k, cluster, 256 if -(-n // cluster) >= 512 else 128


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _aligned(t):
    """t, or a copy of it that starts on a 16-byte boundary (the kernel's
    bulk copies need one)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name, data, descs, compound_pref, point_mask, trunc_sq, exponent,
            has_compound, magsac_levels):
    """Check the CUDA inputs, launch csrc/<name>.cu's kernel, count it.
    data [N, 4] f32, descs [B, 9] f32, compound_pref [N] f32, point_mask
    [N] bool. Returns (scores f32, inliers int32, dots f32, norms f32),
    each [B]."""
    dev = data.device
    for arg, t in (("data", data), ("descs", descs),
                   ("compound_pref", compound_pref), ("point_mask", point_mask)):
        if t.device != dev:
            raise ValueError(f"{arg} is on {t.device}, data on {dev}")
    n, b = data.shape[0], descs.shape[0]
    if data.shape != (n, 4) or descs.shape != (b, 9) or \
            compound_pref.shape != (n,) or point_mask.shape != (n,):
        raise ValueError(f"shapes data {tuple(data.shape)}, descs "
                         f"{tuple(descs.shape)}, compound "
                         f"{tuple(compound_pref.shape)}, mask "
                         f"{tuple(point_mask.shape)}")
    pts = _aligned(data.to(torch.float32).contiguous())
    descs = descs.to(torch.float32).contiguous()
    comp = _aligned(compound_pref.to(torch.float32).contiguous())
    pm = _aligned(point_mask.to(torch.bool).contiguous())  # read as bytes
    scores = torch.empty(b, dtype=torch.float32, device=dev)
    dots = torch.empty(b, dtype=torch.float32, device=dev)
    norms = torch.empty(b, dtype=torch.float32, device=dev)
    inliers = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return scores, inliers, dots, norms
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel(name)(
        pts.data_ptr(), comp.data_ptr(), pm.data_ptr(), descs.data_ptr(), b, n,
        float(trunc_sq), float(exponent), int(bool(has_compound)),
        int(magsac_levels), *_tiling(b, n, _sm_count(dev)), scores.data_ptr(),
        inliers.data_ptr(), dots.data_ptr(), norms.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return scores, inliers, dots, norms


def score_homography_cuda(data, descs, compound_pref, point_mask, trunc_sq,
                          exponent, has_compound, magsac_levels=0):
    """Launch the homography kernel on CUDA tensors (see `_launch`)."""
    return _launch("score_homography", data, descs, compound_pref, point_mask,
                   trunc_sq, exponent, has_compound, magsac_levels)


def score_fundamental_cuda(data, descs, compound_pref, point_mask, trunc_sq,
                           exponent, has_compound, magsac_levels=0):
    """Launch the fundamental kernel on CUDA tensors (see `_launch`)."""
    return _launch("score_fundamental", data, descs, compound_pref, point_mask,
                   trunc_sq, exponent, has_compound, magsac_levels)


def _dispatch(plain, cuda, data, *args):
    if data.device.type == "cpu":
        return plain(data, *args)
    if data.device.type != "cuda":
        raise ValueError(f"no scoring kernel for device {data.device}")
    return cuda(data, *args)


def score_homography(data, descs, compound_pref, point_mask, trunc_sq,
                     exponent, has_compound, magsac_levels=0):
    """(scores, inliers, dots, norms) [B] of homography hypotheses: the
    plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    return _dispatch(score_homography_plain, score_homography_cuda, data, descs,
                     compound_pref, point_mask, trunc_sq, exponent,
                     has_compound, magsac_levels)


def score_fundamental(data, descs, compound_pref, point_mask, trunc_sq,
                      exponent, has_compound, magsac_levels=0):
    """(scores, inliers, dots, norms) [B] of fundamental-matrix hypotheses:
    the plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    return _dispatch(score_fundamental_plain, score_fundamental_cuda, data,
                     descs, compound_pref, point_mask, trunc_sq, exponent,
                     has_compound, magsac_levels)
