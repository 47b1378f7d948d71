// The eigenvector of the smallest eigenvalue of small symmetric PSD
// matrices by shifted inverse iteration, one warp a matrix: the CUDA form
// of progressivex_tpu_torch/ops/linalg.py's `smallest_eigvec_psd`, whose
// plain torch version (kernels/linalg.py) runs `iters` unrolled
// Gauss-Jordan solves of about 15 PyTorch operations a pivot step.
//
// It replaces no Pallas kernel: the JAX package leaves this solver
// (progressivex_tpu/ops/linalg.py:405, `smallest_eigvec_psd`) to XLA's
// lowering inside its compiled fit. Every weighted refit of the port
// calls it: the homography and fundamental `_nonminimal` and the
// essential fit at n = 9, the fundamental rank-2 step, the essential
// projection and the vanishing point at n = 3, the PnP DLT at n = 12,
// on batches of 1 to about a thousand matrices.
//
// What bounds it on an H100: latency. A matrix is a few thousand
// operations in a chain of dependent pivot steps (n steps in each of six
// solves, 54 at n = 9), so neither bytes nor operations come near the
// card's rates; the plain version pays a launch for each of its ~1,460
// operations a call. This kernel is one launch a call and eliminates
// each matrix once: the pivot order, the divisors and the row factors of
// Ms = M + shift * I do not depend on the right-hand side, so they are
// recorded in the elimination and replayed on v in each iteration, which
// are the plain version's own operations on that column.
//
// Layout: one warp a matrix. Lane j < n holds column j of Ms in
// registers (lanes past n shadow column 0 and write nothing). At pivot
// step i, lane i's column reaches every lane by __shfl_sync; each lane
// picks the pivot, the divisor and the factors itself, the same values in
// every lane, and updates its own column. Every lane then replays the
// iterations from its own records; lane 0 writes the result.
//
// Rounding: every elementwise step is the plain version's, one IEEE
// operation each (built with -fmad=false): the shift M + shift * I, the
// pivot rule (argmax of |A[:, i]| - used * 1e18, NaN first, ties to the
// lowest row), the one-hot products that select the pivot row (a 0 * inf
// among them is the plain version's NaN, so a non-finite matrix spreads
// as it does there), pivot_row / piv behind the |piv| > 1e-12 guard,
// A - f * row as a multiply then a subtract, the blend
// A * (1 - p) + p * row, and the permutation product P @ A. The two sums
// of n terms, the trace and the squared norm, are taken in index order,
// which may differ from torch's reduction order in the last bit: that is
// the kernel's one tolerance against the plain version.

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-12f;
constexpr float kBig = 1e18f;
constexpr int kWarps = 4;  // matrices a block

// torch.clamp(x, min=lo): a NaN passes through.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float onehot(int k, int p) { return k == p ? 1.0f : 0.0f; }

template <int N>
__global__ void __launch_bounds__(32 * kWarps)
eigvec_psd_kernel(const float* __restrict__ m, long long batch, int iters,
                  float* __restrict__ out) {
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (b >= batch) return;  // the whole warp
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const int col = lane < N ? lane : 0;
  const float* mb = m + b * (N * N);

  // Ms = M + shift * I with shift = clamp(1e-6 * trace / n, min=1e-12).
  float tr = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) tr = tr + mb[k * N + k];
  tr = tr / static_cast<float>(N);
  const float shift = clamp_min(1e-6f * tr, kEps);
  float a[N];
#pragma unroll
  for (int k = 0; k < N; ++k) a[k] = mb[k * N + col] + shift * onehot(k, col);

  // The elimination of Ms, recording each step's pivot row, divisor and
  // factors.
  float used[N], fac[N][N], div[N];
  int prow[N];
#pragma unroll
  for (int k = 0; k < N; ++k) used[k] = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float ci[N];
#pragma unroll
    for (int k = 0; k < N; ++k) ci[k] = __shfl_sync(full, a[k], i);
    int p = 0;
    float best = fabsf(ci[0]) - used[0] * kBig;
#pragma unroll
    for (int k = 1; k < N; ++k) {
      const float c = fabsf(ci[k]) - used[k] * kBig;
      if (!isnan(best) && (isnan(c) || c > best)) {
        best = c;
        p = k;
      }
    }
    float row = 0.0f;  // this lane's entry of the pivot row
#pragma unroll
    for (int k = 0; k < N; ++k) row = row + onehot(k, p) * a[k];
    float d = __shfl_sync(full, row, i);
    d = fabsf(d) > kEps ? d : kEps;
    row = row / d;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float q = onehot(k, p);
      const float f = ci[k] * (1.0f - q);
      const float t = a[k] - f * row;
      a[k] = t * (1.0f - q) + q * row;
      used[k] = used[k] + q;
      fac[i][k] = f;
    }
    prow[i] = p;
    div[i] = d;
  }

  // v = (1, ..., n) / |(1, ..., n)|, then `iters` solves Ms x = v, each
  // the recorded steps replayed on the right-hand side, x over its norm.
  float v[N];
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) ss = ss + static_cast<float>((k + 1) * (k + 1));
  const float n0 = sqrtf(ss);
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = static_cast<float>(k + 1) / n0;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float row = 0.0f;
#pragma unroll
      for (int k = 0; k < N; ++k) row = row + onehot(k, prow[i]) * v[k];
      row = row / div[i];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float q = onehot(k, prow[i]);
        const float t = v[k] - fac[i][k] * row;
        v[k] = t * (1.0f - q) + q * row;
      }
    }
    float x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      x[i] = 0.0f;
#pragma unroll
      for (int k = 0; k < N; ++k) x[i] = x[i] + onehot(k, prow[i]) * v[k];
    }
    ss = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) ss = ss + x[i] * x[i];
    const float nrm = clamp_min(sqrtf(ss), kEps);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = x[i] / nrm;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) out[b * N + k] = v[k];
  }
}

template <int N>
int launch(const float* m, long long batch, int iters, float* out, cudaStream_t stream) {
  const long long blocks = (batch + kWarps - 1) / kWarps;
  eigvec_psd_kernel<N><<<static_cast<unsigned>(blocks), 32 * kWarps, 0, stream>>>(
      m, batch, iters, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// m: [batch, n, n] float32, contiguous; out: [batch, n] float32. n is 3,
// 9 or 12 (cudaErrorInvalidValue otherwise). Launches on `stream`,
// allocates nothing and returns cudaGetLastError().
extern "C" int eigvec_psd(const void* m, long long batch, int n, int iters, void* out,
                          void* stream) {
  if (batch <= 0) return 0;
  const auto* in = static_cast<const float*>(m);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 3: return launch<3>(in, batch, iters, o, s);
    case 9: return launch<9>(in, batch, iters, o, s);
    case 12: return launch<12>(in, batch, iters, o, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
