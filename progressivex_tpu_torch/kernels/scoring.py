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

Rows: every function takes a leading row axis, data [R, N, 4], descs
[R, B, 9], compound_pref and point_mask [R, N], trunc_sq and has_compound
[R], and returns [R, B] outputs; one launch scores all rows (the vmapped
`fused_scores`). Called without the row axis (data [N, 4], descs [B, 9],
scalars), they return [B] outputs, as one row.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. A launch goes to the device of its tensors, whatever
the calling thread's current device. `LAUNCHES` counts kernel launches and
`ROWS` the rows they scored, both incremented under a lock at the one
place a launch happens, so that the counts are exact when several host
threads launch (a device mesh, parallel/sharding).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from progressivex_tpu_torch._device import device_guard

LAUNCHES = {"score_homography": 0, "score_fundamental": 0}
ROWS = {"score_homography": 0, "score_fundamental": 0}
_COUNT_LOCK = threading.Lock()


def _count(name: str, rows: int):
    """One launch of `name` over `rows` rows, counted."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        ROWS[name] += rows


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
        fn.restype = ci  # before argtypes, which another thread tests
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp, vp, cf, ci, ci, ci, ci,
                       vp, vp, vp, vp, vp]
    return fn


def _tiling(b: int, n: int, n_sms: int, rows: int = 1):
    """(k_tile, cluster, threads) of a launch over `rows` rows of b
    hypotheses and n points on a card with n_sms SMs
    (tools/sweep_score_tiling.py times the alternatives). K, the hypotheses
    a block scores, is the larger of 4 and 2 that still leaves two blocks
    per SM over all rows, else 1: more hypotheses a thread leave too few
    blocks to balance the SMs. The cluster split and the block size follow
    the row's own (b, n), never `rows`, so that a row's sums are taken in
    the same order alone and in a batch: where one row's ceil(b / K)
    hypothesis tiles (K picked for the row alone) leave SMs idle, each
    tile's points are split over a cluster of up to 8 blocks of at least
    256 points each. A block has 256 threads if that still gives each
    thread two points, else 128."""
    def k_for(tiles_of):
        return next((k for k in (4, 2) if tiles_of(k) >= 2 * n_sms), 1)

    k_row = k_for(lambda k: -(-b // k))
    cluster = max(1, min(8, -(-n_sms // -(-b // k_row)), n // 256))
    k = k_for(lambda k: rows * -(-b // k))
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
    """Check the CUDA inputs, launch csrc/<name>.cu's kernel over all rows,
    count it. data [R, N, 4] f32, descs [R, B, 9] f32, compound_pref [R, N]
    f32, point_mask [R, N] bool, trunc_sq [R] f32 and has_compound [R]
    bool. Returns (scores f32, inliers int32, dots f32, norms f32), each
    [R, B]."""
    dev = data.device
    for arg, t in (("data", data), ("descs", descs),
                   ("compound_pref", compound_pref), ("point_mask", point_mask),
                   ("trunc_sq", trunc_sq), ("has_compound", has_compound)):
        if t.device != dev:
            raise ValueError(f"{arg} is on {t.device}, data on {dev}")
    r, n, b = data.shape[0], data.shape[1], descs.shape[1]
    if data.shape != (r, n, 4) or descs.shape != (r, b, 9) or \
            compound_pref.shape != (r, n) or point_mask.shape != (r, n) or \
            trunc_sq.shape != (r,) or has_compound.shape != (r,):
        raise ValueError(f"shapes data {tuple(data.shape)}, descs "
                         f"{tuple(descs.shape)}, compound "
                         f"{tuple(compound_pref.shape)}, mask "
                         f"{tuple(point_mask.shape)}, trunc_sq "
                         f"{tuple(trunc_sq.shape)}, has_compound "
                         f"{tuple(has_compound.shape)}")
    pts = _aligned(data.to(torch.float32).contiguous())
    descs = descs.to(torch.float32).contiguous()
    comp = _aligned(compound_pref.to(torch.float32).contiguous())
    pm = _aligned(point_mask.to(torch.bool).contiguous())  # read as bytes
    tau = trunc_sq.to(torch.float32).contiguous()
    has = has_compound.to(torch.bool).contiguous()  # read as bytes
    scores = torch.empty(r, b, dtype=torch.float32, device=dev)
    dots = torch.empty(r, b, dtype=torch.float32, device=dev)
    norms = torch.empty(r, b, dtype=torch.float32, device=dev)
    inliers = torch.empty(r, b, dtype=torch.int32, device=dev)
    if b == 0 or r == 0:
        return scores, inliers, dots, norms
    stream = torch.cuda.current_stream(dev).cuda_stream
    # The library's CUDA runtime launches on the thread's current device,
    # so the guard makes that the tensors' device. The annotation ties the
    # launch to the engine's phase scopes in a profile (io/profiling.py);
    # it launches nothing.
    with device_guard(dev), torch.profiler.record_function(name):
        err = _kernel(name)(
            pts.data_ptr(), comp.data_ptr(), pm.data_ptr(), descs.data_ptr(), r, b, n,
            tau.data_ptr(), has.data_ptr(), float(exponent), int(magsac_levels),
            *_tiling(b, n, _sm_count(dev), r), scores.data_ptr(), inliers.data_ptr(),
            dots.data_ptr(), norms.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    _count(name, r)
    return scores, inliers, dots, norms


def _rows_launch(name, data, descs, compound_pref, point_mask, trunc_sq,
                 exponent, has_compound, magsac_levels):
    """`_launch` for row-batched inputs, or for one problem without the row
    axis (scalar trunc_sq and has_compound), whose outputs are then [B]."""
    if data.ndim == 3:
        return _launch(name, data, descs, compound_pref, point_mask, trunc_sq,
                       exponent, has_compound, magsac_levels)
    dev = data.device
    one = _launch(name, data[None], descs[None], compound_pref[None],
                  point_mask[None],
                  torch.as_tensor(trunc_sq, dtype=torch.float32, device=dev).reshape(1),
                  exponent,
                  torch.as_tensor(has_compound, dtype=torch.bool, device=dev).reshape(1),
                  magsac_levels)
    return tuple(t[0] for t in one)


def score_homography_cuda(data, descs, compound_pref, point_mask, trunc_sq,
                          exponent, has_compound, magsac_levels=0):
    """Launch the homography kernel on CUDA tensors (see `_rows_launch`)."""
    return _rows_launch("score_homography", data, descs, compound_pref,
                        point_mask, trunc_sq, exponent, has_compound, magsac_levels)


def score_fundamental_cuda(data, descs, compound_pref, point_mask, trunc_sq,
                           exponent, has_compound, magsac_levels=0):
    """Launch the fundamental kernel on CUDA tensors (see `_rows_launch`)."""
    return _rows_launch("score_fundamental", data, descs, compound_pref,
                        point_mask, trunc_sq, exponent, has_compound, magsac_levels)


def _dispatch(plain, cuda, data, *args):
    if data.device.type == "cpu":
        return plain(data, *args)
    if data.device.type != "cuda":
        raise ValueError(f"no scoring kernel for device {data.device}")
    return cuda(data, *args)


def score_homography(data, descs, compound_pref, point_mask, trunc_sq,
                     exponent, has_compound, magsac_levels=0):
    """(scores, inliers, dots, norms) [R, B] (or [B] without the row axis)
    of homography hypotheses: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    return _dispatch(score_homography_plain, score_homography_cuda, data, descs,
                     compound_pref, point_mask, trunc_sq, exponent,
                     has_compound, magsac_levels)


def score_fundamental(data, descs, compound_pref, point_mask, trunc_sq,
                      exponent, has_compound, magsac_levels=0):
    """(scores, inliers, dots, norms) [R, B] (or [B] without the row axis)
    of fundamental-matrix hypotheses: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors."""
    return _dispatch(score_fundamental_plain, score_fundamental_cuda, data,
                     descs, compound_pref, point_mask, trunc_sq, exponent,
                     has_compound, magsac_levels)
