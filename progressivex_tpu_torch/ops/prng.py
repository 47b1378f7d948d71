"""The JAX package's random keys and numbers in torch: jax.random's
threefry2x32 key algebra (jax/_src/prng.py, jax/_src/random.py, JAX 0.9
with its defaults: `jax_threefry_partitionable` on, 32-bit types), so
that a seed draws the JAX package's numbers bit for bit, on any device.

A key is a [..., 2] int64 tensor holding two uint32 words (the JAX key's
`key_data`). Every function takes a leading batch of keys, as a vmap of
the JAX function over them would: `split(keys [*L, 2], n)` gives
[*L, n, 2], `random_bits(keys [*L, 2], shape)` gives [*L, *shape], and
so on. The hash itself, the threefry2x32 block over a key's counters, is
kernels/threefry.py: the CUDA kernel for a CUDA tensor, the plain int64
version here (`threefry2x32`) for a CPU tensor.

  key(seed)             PRNGKey(seed): (0, seed mod 2^32), since JAX
                        casts an int seed to int32 with 64-bit types off
  split(keys, n)        the hash of counters 0..n-1, both words
  fold_in(keys, data)   the hash of counter `data`, both words
  random_bits(keys, s)  bits1 ^ bits2 over counters 0..prod(s)-1, as
                        int32 holding the uint32 words
  randint, uniform, gumbel   jax.random's, from those bits

randint wraps every uint32 product and sum, as XLA does: its multiplier
(2^16 mod span)^2 wraps to 0 once span > 2^16. gumbel computes
-log(-log(u)) in float32 with torch's log, which differs from XLA's by
one ulp on some entries; the samplers read only its order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block (20 rounds) of keys (k0, k1) over counters
    (x0, x1): int64 tensors of uint32 values that broadcast together.
    Returns the two output words (y0, y1), int64."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed) as a [2] int64 tensor on `device`."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64, device=device)


def _flat(keys):
    keys = torch.as_tensor(keys)
    if keys.shape[-1:] != (2,):
        raise ValueError(f"keys of shape {tuple(keys.shape)}: the last axis holds two words")
    return keys.reshape(-1, 2).to(torch.int64), keys.shape[:-1]


def _on(keys, x):
    """x, an int or an integer tensor, as an int64 tensor on the keys'
    device; an int is written by a fill kernel, not copied from the host
    (a CUDA graph may be capturing)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=keys.device, dtype=torch.int64)
    return torch.full((), int(x), dtype=torch.int64, device=keys.device)


def split(keys, n: int) -> torch.Tensor:
    """jax.random.split of every key: [*L, 2] -> [*L, n, 2]."""
    from progressivex_tpu_torch.kernels.threefry import threefry

    flat, lead = _flat(keys)
    return threefry(flat, int(n), pair=True).reshape(*lead, int(n), 2)


def fold_in(keys, data) -> torch.Tensor:
    """jax.random.fold_in of every key with `data` (an int, or int
    values that broadcast against the keys' leading shape, each taken
    mod 2^32): [*L, 2] -> [*L', 2], L' the broadcast shape."""
    from progressivex_tpu_torch.kernels.threefry import threefry

    keys = torch.as_tensor(keys)
    data = _on(keys, data)
    lead = torch.broadcast_shapes(keys.shape[:-1], data.shape)
    flat = keys.expand(*lead, 2).reshape(-1, 2).to(torch.int64)
    offsets = (data.expand(lead).reshape(-1) & _M32).contiguous()
    return threefry(flat, 1, pair=True, offsets=offsets).reshape(*lead, 2)


def random_bits(keys, shape) -> torch.Tensor:
    """jax.random.bits (32-bit) of every key: [*L, 2] -> [*L, *shape]
    int32, each the bit pattern of the uint32 word."""
    from progressivex_tpu_torch.kernels.threefry import threefry

    shape = tuple(int(s) for s in shape)
    flat, lead = _flat(keys)
    return threefry(flat, math.prod(shape), pair=False).reshape(*lead, *shape)


def _u32(bits):
    """int32 words -> their uint32 values, int64."""
    return bits.to(torch.int64) & _M32


def randint(keys, shape, lo, hi) -> torch.Tensor:
    """jax.random.randint(key, shape, lo, hi) (int32 semantics) of every
    key: [*L, 2] -> [*L, *shape] int64. `lo` is an int; `hi` an int or a
    tensor that broadcasts against L (one bound a key)."""
    keys = torch.as_tensor(keys)
    shape = tuple(int(s) for s in shape)
    lead = keys.shape[:-1]
    pair = random_bits(split(keys, 2), shape)  # [*L, 2, *shape]
    higher, lower = _u32(pair.select(len(lead), 0)), _u32(pair.select(len(lead), 1))
    hi = _on(keys, hi).expand(lead)
    hi = hi.reshape(*lead, *([1] * len(shape)))
    span = torch.where(hi <= lo, 1, (hi - lo) & _M32)
    mult = (1 << 16) % span
    mult = ((mult * mult) & _M32) % span
    offset = (((higher % span) * mult & _M32) + lower % span) & _M32
    return lo + offset % span


def _floats(bits):
    """jax.random.uniform's mantissa trick: float32 values in [0, 1)."""
    one = 0x3F800000
    return ((bits >> 9) & 0x7FFFFF | one).view(torch.float32) - 1.0


def uniform(keys, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform (float32) of every key: [*L, 2] -> [*L, *shape]."""
    f = _floats(random_bits(keys, shape))
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp(f * float(hi - lo) + float(lo), min=float(lo))


def gumbel(keys, shape) -> torch.Tensor:
    """jax.random.gumbel (float32, its default "low" mode) of every key:
    [*L, 2] -> [*L, *shape]."""
    tiny = float(np.finfo(np.float32).tiny)
    return -torch.log(-torch.log(uniform(keys, shape, tiny, 1.0)))
