"""ops/prng.py, the port's copy of jax.random's threefry key algebra,
against jax.random on the CPU (the plain int64 version of the threefry
kernel, kernels/threefry.threefry_plain).

key, split, fold_in, random_bits, randint and uniform must equal
jax.random's exactly, on 20 seeds (0, negative seeds and seeds at and
above 2^32 among them), for shapes of one element, odd sizes and 2-D and
3-D shapes, and randint for spans 1, 5, 180, 2084, 7680 and 70000 (the
last wraps randint's uint32 multiplier (2^16 mod span)^2 to 0).

gumbel computes -log(-log(u)) on the same u, with torch's float32 log
in place of XLA's; the two logs differ by an ulp on some inputs. Its
tolerance: |port - jax| <= 2 ulp(jax) + 2^-23, one ulp of each log (the
inner log's ulp carried through the outer log is at most 2^-23, since
|d(log x)| = |dx| / x <= 2^-23 for a one-ulp dx) and the final
rounding. The samplers read only the stable descending order of gumbel
values within a row, which must be identical.

Each JAX call is small: the whole file takes seconds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivex_tpu_torch.kernels import _build
from progressivex_tpu_torch.kernels import threefry as kthreefry
from progressivex_tpu_torch.ops import prng

SEEDS = [0, 1, 2, 7, 42, 99, 123, 1000, 4096, 65535, 123456789, 2**31 - 1, 2**31,
         2**32 - 1, 2**32, 2**32 + 5, 2**40 + 3, -1, -5, -(2**31)]
SHAPES = [(1,), (7,), (3, 5), (2, 3, 4)]
SPANS = [1, 5, 180, 2084, 7680, 70000]


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    k = _jkey(seed)
    kt = prng.key(seed)
    assert kt.dtype == torch.int64 and kt.shape == (2,)
    np.testing.assert_array_equal(kt.numpy(), _data(k))
    for n in (1, 2, 3, 10):
        np.testing.assert_array_equal(prng.split(kt, n).numpy(), _data(jax.random.split(k, n)))
    for d in (0, 1, 0x5B, 256, 2**32 - 1):
        np.testing.assert_array_equal(prng.fold_in(kt, d).numpy(),
                                      _data(jax.random.fold_in(k, d)))


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_randint(seed):
    k, kt = _jkey(seed), prng.key(seed)
    for shape in SHAPES:
        bits = prng.random_bits(kt, shape)
        assert bits.dtype == torch.int32 and bits.shape == shape
        np.testing.assert_array_equal(bits.numpy().view(np.uint32),
                                      np.asarray(jax.random.bits(k, shape)))
        np.testing.assert_array_equal(prng.uniform(kt, shape).numpy(),
                                      np.asarray(jax.random.uniform(k, shape)))
        for span in SPANS:
            np.testing.assert_array_equal(
                prng.randint(kt, shape, 0, span).numpy(),
                np.asarray(jax.random.randint(k, shape, 0, span)), err_msg=f"span {span}")


def _stable_desc(x):
    return np.argsort(-x, axis=-1, kind="stable")


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_tolerance_and_same_order(seed):
    k, kt = _jkey(seed), prng.key(seed)
    for shape in SHAPES + [(64, 48)]:
        want = np.asarray(jax.random.gumbel(k, shape))
        got = prng.gumbel(kt, shape).numpy()
        assert got.dtype == np.float32 and got.shape == shape
        tol = 2 * np.spacing(np.abs(want)) + 2.0**-23
        assert np.all(np.abs(got.astype(np.float64) - want) <= tol)
        np.testing.assert_array_equal(_stable_desc(got), _stable_desc(want))


def test_batched_keys_equal_a_vmap():
    """Every function over a batch of keys equals jax.vmap of jax.random's,
    with randint's bound one a key."""
    ks = jax.random.split(_jkey(3), 6)
    kt = torch.as_tensor(_data(ks))
    hi = np.array([5, 100, 70000, 1, 0, 3000])
    np.testing.assert_array_equal(
        prng.randint(kt, (4, 3), 0, torch.as_tensor(hi)).numpy(),
        np.asarray(jax.vmap(lambda k, h: jax.random.randint(k, (4, 3), 0, h))(
            ks, jnp.asarray(hi))))
    np.testing.assert_array_equal(prng.split(kt, 4).numpy(),
                                  _data(jax.vmap(lambda k: jax.random.split(k, 4))(ks)))
    np.testing.assert_array_equal(
        prng.fold_in(kt, torch.arange(6)).numpy(),
        _data(jax.vmap(jax.random.fold_in)(ks, jnp.arange(6))))
    np.testing.assert_array_equal(
        prng.uniform(kt.reshape(2, 3, 2), (5,)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (5,)))(ks)).reshape(2, 3, 5))


def test_threefry_plain_counters_and_checks():
    """The plain block's counters: offsets shift them (fold_in is the
    pair at counter `data`), pair mode gives both words of split."""
    keys = torch.stack([prng.key(s) for s in (0, 9, -3)])
    pairs = kthreefry.threefry(keys, 5, pair=True)
    assert pairs.shape == (3, 5, 2) and pairs.dtype == torch.int64
    shifted = kthreefry.threefry(keys, 1, pair=True, offsets=torch.tensor([2, 4, 0]))
    np.testing.assert_array_equal(shifted[:, 0].numpy(),
                                  pairs[torch.arange(3), torch.tensor([2, 4, 0])].numpy())
    bits = kthreefry.threefry(keys, 5, pair=False)
    np.testing.assert_array_equal(bits.numpy().view(np.uint32).astype(np.int64),
                                  (pairs[..., 0] ^ pairs[..., 1]).numpy())
    with pytest.raises(ValueError, match="expected \\[K, 2\\] int64"):
        kthreefry.threefry(keys.to(torch.int32), 5, pair=False)
    with pytest.raises(ValueError, match="offsets"):
        kthreefry.threefry(keys, 1, pair=True, offsets=torch.tensor([1, 2]))
    before = dict(_build.LAUNCHES)
    kthreefry.threefry(keys, 5, pair=False)
    assert _build.LAUNCHES == before  # the plain version is no launch
