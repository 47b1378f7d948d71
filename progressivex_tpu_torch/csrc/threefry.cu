// The threefry2x32 block of jax.random (jax/_src/prng.py,
// `_threefry2x32_lowering` over `iota_2x32_shape`'s counters), one thread
// a counter, for a batch of keys.
//
// In the JAX package the minimal samples of a fit are drawn inside its
// compiled device program (progressivex_tpu/core/engine.py:836-885,
// `_fit_prepared`, under named_scope("progx_sampling")): XLA lowers each
// jax.random.split, fold_in, bits, randint, uniform and gumbel there to
// this hash. This kernel is the hash for progressivex_tpu_torch/ops/prng.py,
// whose plain int64 torch version (`threefry2x32`) is its CPU path and its
// reference; kernels/threefry.py binds both.
//
// Key k (two uint32 words, stored as int64) hashes counters
// c = offset[k] + i for i in 0..count-1 (offset 0 without the offsets
// array), c split into its high word x0 and low word x1, the partitionable
// counters of JAX's default. The output is either y0 ^ y1, one uint32 a
// counter (random_bits), or (y0, y1), two a counter (split, fold_in), at
// out[k * count + i].
//
// What bounds it on an H100: each counter costs about 120 integer
// operations (20 rounds of add, rotate, xor and five key injections) and
// writes 4 or 8 bytes, so operations and the store rate are close; a
// thread keeps its state in registers and reads its key's 16 bytes
// (cached: neighbouring threads share the key). The pass F P-NAPSAC
// gumbel field, 9.4 M counters, is the largest launch of a fit.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

__global__ void __launch_bounds__(256)
threefry_kernel(const int64_t* __restrict__ keys, const int64_t* __restrict__ offsets,
                int64_t n_keys, int64_t count, int pair, uint32_t* __restrict__ out) {
  const int64_t total = n_keys * count;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t k = t / count;
    const int64_t i = t - k * count;
    const uint32_t ks0 = static_cast<uint32_t>(keys[2 * k]);
    const uint32_t ks1 = static_cast<uint32_t>(keys[2 * k + 1]);
    const uint32_t ks2 = ks0 ^ ks1 ^ 0x1BD11BDAu;
    const uint64_t c = static_cast<uint64_t>(i)
        + (offsets ? static_cast<uint64_t>(offsets[k]) : 0ull);
    uint32_t x0 = static_cast<uint32_t>(c >> 32) + ks0;
    uint32_t x1 = static_cast<uint32_t>(c) + ks1;
    four_rounds<13, 15, 26, 6>(x0, x1);
    x0 += ks1; x1 += ks2 + 1u;
    four_rounds<17, 29, 16, 24>(x0, x1);
    x0 += ks2; x1 += ks0 + 2u;
    four_rounds<13, 15, 26, 6>(x0, x1);
    x0 += ks0; x1 += ks1 + 3u;
    four_rounds<17, 29, 16, 24>(x0, x1);
    x0 += ks1; x1 += ks2 + 4u;
    four_rounds<13, 15, 26, 6>(x0, x1);
    x0 += ks2; x1 += ks0 + 5u;
    if (pair) {
      reinterpret_cast<uint2*>(out)[t] = make_uint2(x0, x1);
    } else {
      out[t] = x0 ^ x1;
    }
  }
}

}  // namespace

// keys: [n_keys, 2] int64 (uint32 values); offsets: [n_keys] int64 or
// NULL; out: n_keys * count uint32 (twice that with pair), 8-byte
// aligned. Launches on `stream` and returns cudaGetLastError().
extern "C" int threefry(const void* keys, const void* offsets, long long n_keys,
                        long long count, int pair, void* out, void* stream) {
  const int64_t total = static_cast<int64_t>(n_keys) * count;
  if (total <= 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // the rest in grid-stride steps
  threefry_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<const int64_t*>(offsets),
      n_keys, count, pair, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
