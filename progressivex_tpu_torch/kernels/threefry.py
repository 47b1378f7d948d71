"""The threefry2x32 block over a batch of keys: the CUDA kernel
(csrc/threefry.cu) and its plain torch version.

The JAX package draws its minimal samples with jax.random inside its
compiled fit (progressivex_tpu/core/engine.py:836-885), where XLA lowers
every split, fold_in and bits call to this hash; ops/prng.py builds
jax.random's key algebra on `threefry` here.

`threefry(keys [K, 2] int64, count, pair, offsets=None)` hashes, for
every key k, the counters offsets[k] + i (i in 0..count-1; offsets 0 if
None) split into a high and a low uint32 word, and returns y0 ^ y1 as
[K, count] int32 (the uint32 bit patterns; `pair=False`, random_bits)
or (y0, y1) as [K, count, 2] int64 uint32 values (`pair=True`, split
and fold_in).

Dispatch and launch (kernels/_build.py): a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. The launch goes to
the keys' device, on its current stream, and counts in `_build.LAUNCHES`
and `_build.UNITS` (the keys it hashed).
"""

from __future__ import annotations

import ctypes

import torch

from progressivex_tpu_torch.kernels import _build

_M32 = 0xFFFFFFFF
# keys, offsets, K, count, pair, out
_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_void_p)


def _check(keys, count, offsets):
    if keys.ndim != 2 or keys.shape[1] != 2 or keys.dtype != torch.int64:
        raise ValueError(f"keys of shape {tuple(keys.shape)} and type {keys.dtype}: "
                         "expected [K, 2] int64")
    if count < 0:
        raise ValueError(f"count {count}")
    if offsets is not None and (offsets.shape != (keys.shape[0],)
                                or offsets.dtype != torch.int64
                                or offsets.device != keys.device):
        raise ValueError(f"offsets of shape {tuple(offsets.shape)}, type "
                         f"{offsets.dtype} on {offsets.device} for {keys.shape[0]} "
                         f"keys on {keys.device}")


def threefry_plain(keys, count: int, pair: bool, offsets=None):
    """The function the kernel computes, in plain int64 torch."""
    from progressivex_tpu_torch.ops.prng import threefry2x32

    _check(keys, count, offsets)
    c = torch.arange(count, dtype=torch.int64, device=keys.device)[None, :]
    if offsets is not None:
        c = c + offsets[:, None]
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], c >> 32, c & _M32)
    if pair:
        return torch.stack([y0, y1], -1)
    bits = y0 ^ y1
    return torch.where(bits > 0x7FFFFFFF, bits - (1 << 32), bits).to(torch.int32)


def threefry_cuda(keys, count: int, pair: bool, offsets=None):
    """Launch csrc/threefry.cu's kernel on CUDA tensors."""
    _check(keys, count, offsets)
    dev = keys.device
    k = keys.contiguous()
    off = None if offsets is None else offsets.contiguous()
    n = keys.shape[0]
    out = torch.empty(n, count, *((2,) if pair else ()), dtype=torch.int32, device=dev)
    if out.numel():
        _build.launch("threefry", dev, n, _ARGS, k.data_ptr(),
                      None if off is None else off.data_ptr(), n, count, int(pair),
                      out.data_ptr())
    return out.to(torch.int64) & _M32 if pair else out


def threefry(keys, count: int, pair: bool, offsets=None):
    """The plain version for CPU keys, the CUDA kernel for CUDA keys."""
    return _build.dispatch("threefry", keys.device, threefry_plain, threefry_cuda)(
        keys, count, pair, offsets)
