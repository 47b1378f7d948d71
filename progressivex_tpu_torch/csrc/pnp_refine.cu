// The PnP family's warm-started refit: six weighted Gauss-Newton steps on
// the reprojection error of every (row, instance) problem of a call, in
// one launch. The CUDA form of kernels/pnp.py's `refine_plain`, which
// models/pnp._refine (the family's `refine_solver`) runs on the CPU.
//
// It replaces no Pallas kernel: the JAX package leaves this refit to XLA
// (the `lax.scan` of progressivex_tpu/models/pnp.py:187-241) inside its
// compiled fit. A pose fit calls it about a hundred times (the LO of the
// proposals, the PEARL rounds, the merges and the final polishes), on
// 3 rows x P = 4 to 10 instances over 2,304 padded points, and the plain
// version is about 98 small PyTorch operations a step, the largest of
// them the [.., N, 2, 6, 6] outer product and `row_sum`'s padded tree.
//
// What bounds it on an H100: latency. A call is 12 to 30 problems of
// about 160 operations a point and step (2 x 10^6 to 7 x 10^7 in all,
// a microsecond at the f32 peak) and reads 24 bytes a point, but its six
// steps are a chain: each is a sum over the points, a 6x6 solve and an
// update that the next step's points need. So the design keeps a
// problem in one block from its first load to its last store:
//  - one block a problem (grid R x P, P problems a row); the row's points
//    (x, y, X, Y, Z) and the problem's weights are copied once into
//    shared memory and read there by all six steps (24 bytes a point:
//    55 KB at 2,304 points, 184 KB at the 7,680 pad level; above
//    kMaxSharedPoints they are read from device memory, through L2);
//  - each thread takes the points i = tid, tid + 256, ... and keeps the
//    21 entries of H's upper triangle and g's 6 in registers;
//  - the block's sums meet in a fixed order: warp shuffles (offsets 16 to
//    1), then the eight warps in index order in warp 0, so two launches
//    on the same inputs give the same bits, and a problem's bits do not
//    depend on the others of its launch;
//  - lane 0 of warp 0 solves the 6x6 system by LU with partial pivoting,
//    applies R <- exp(d_omega) R and t <- t + d_t and writes the pose to
//    shared memory for the next step; nothing goes to device memory
//    between steps.
//
// Rounding: every point's terms are the plain version's operations, one
// IEEE operation each (built with -fmad=false): q = R X + t, the
// `front` test z > 1e-6, the residual in normalized coordinates, J =
// [Jq (-[q - t]x) | Jq] without the plain version's products by exact
// zeros, Jw = J (w front), and Jw_a J_b summed over the two residual
// rows. A product by zero is NaN in the plain version where its other
// factor is not finite, and such a NaN reaches H and every result, so
// the kernel adds 0 x (each factor) to the point's weight factor: a
// refit is non-finite where the plain version's is. The sums over the
// points run in another order than `row_sum`'s tree, the lower triangle
// of H mirrors the upper one (the plain version rounds Jw_b J_a
// separately) and the LU is not cuBLAS's: those are the kernel's
// tolerance against the plain version. Rodrigues' formula keeps its
// 1e-24 terms; the validity is the plain version's (a finite pose and at
// least 3 positive weights), and an invalid refit returns its start.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;  // H's upper triangle (21, row-major), then g (6)
constexpr int kMaxSharedPoints = 9216;  // 24 bytes a point: 221,184 bytes

// torch.clamp(x, min=lo): a NaN passes through.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// One point's terms of H (upper triangle) and g, added to acc.
__device__ __forceinline__ void add_point(const float* p, float weight, const float R[9],
                                          const float t[3], float acc[kSums]) {
  const float x = p[0], y = p[1], X = p[2], Y = p[3], Z = p[4];
  float q[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) q[i] = ((X * R[3 * i] + Y * R[3 * i + 1]) + Z * R[3 * i + 2]) + t[i];
  const bool front = q[2] > 1e-6f;
  const float invz = 1.0f / (front ? q[2] : 1.0f);
  const float r0 = q[0] * invz - x;
  const float r1 = q[1] * invz - y;
  const float a = (-q[0] * invz) * invz;  // d x / d q_z
  const float b = (-q[1] * invz) * invz;  // d y / d q_z
  const float p0 = q[0] - t[0], p1 = q[1] - t[1], p2 = q[2] - t[2];
  // J = [Jq (-[p]x) | Jq] with Jq = [[invz, 0, a], [0, invz, b]].
  const float J0[6] = {a * p1, invz * p2 + a * (-p0), invz * (-p1), invz, 0.0f, a};
  const float J1[6] = {invz * (-p2) + b * p1, b * (-p0), invz * p0, 0.0f, invz, b};
  // +-0 where p, a and b are finite, NaN where the plain version's
  // products by zero are.
  const float poison = (((0.0f * p0 + 0.0f * p1) + 0.0f * p2) + 0.0f * a) + 0.0f * b;
  const float s = clamp_min(weight, 0.0f) * (front ? 1.0f : 0.0f) + poison;
  float Jw0[6], Jw1[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    Jw0[k] = J0[k] * s;
    Jw1[k] = J1[k] * s;
  }
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += Jw0[i] * J0[j] + Jw1[i] * J1[j];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] += Jw0[i] * r0 + Jw1[i] * r1;
}

// One Gauss-Newton update from the summed H (upper triangle) and g:
// (H + 1e-8 I) d = -g by LU with partial pivoting, then R <- exp(d_omega) R
// (Rodrigues, matmul_small's order), t <- t + d_t. pose: [R | t] row-major.
__device__ __forceinline__ void update_pose(const float tot[kSums], float pose[12]) {
  float A[6][7];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      A[i][j] = tot[k];
      A[j][i] = tot[k];
      ++k;
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    A[i][i] = A[i][i] + 1e-8f;
    A[i][6] = -tot[21 + i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    int p = i;
    float best = fabsf(A[i][i]);
#pragma unroll
    for (int r = i + 1; r < 6; ++r) {
      const float v = fabsf(A[r][i]);
      if (v > best) {
        best = v;
        p = r;
      }
    }
#pragma unroll
    for (int r = i + 1; r < 6; ++r) {
      if (r == p) {
#pragma unroll
        for (int j = i; j < 7; ++j) {
          const float tmp = A[i][j];
          A[i][j] = A[r][j];
          A[r][j] = tmp;
        }
      }
    }
#pragma unroll
    for (int r = i + 1; r < 6; ++r) {
      const float f = A[r][i] / A[i][i];
#pragma unroll
      for (int j = i + 1; j < 7; ++j) A[r][j] = A[r][j] - f * A[i][j];
    }
  }
  float d[6];
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = A[i][6];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s = s - A[i][j] * d[j];
    d[i] = s / A[i][i];
  }

  const float w0 = d[0], w1 = d[1], w2 = d[2];
  const float th2 = (w0 * w0 + w1 * w1) + w2 * w2;
  const float th = sqrtf(th2 + 1e-24f);
  const float ca = sinf(th) / th;
  const float cb = (1.0f - cosf(th)) / (th2 + 1e-24f);
  const float W[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float E[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float w2ij = (W[i][0] * W[0][j] + W[i][1] * W[1][j]) + W[i][2] * W[2][j];
      E[i][j] = ((i == j ? 1.0f : 0.0f) + ca * W[i][j]) + cb * w2ij;
    }
  }
  float Rn[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Rn[3 * i + j] = (E[i][0] * pose[j] + E[i][1] * pose[4 + j]) + E[i][2] * pose[8 + j];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) pose[4 * i + j] = Rn[3 * i + j];
    pose[4 * i + 3] = pose[4 * i + 3] + d[3 + i];
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
pnp_refine_kernel(const float* __restrict__ data, const float* __restrict__ weights,
                  const float* __restrict__ init, int problems, int n, int iters,
                  float* __restrict__ out, uint8_t* __restrict__ ok) {
  extern __shared__ float smem[];  // kShared: the row's points [n, 5], then weights [n]
  __shared__ float red[kWarps][kSums];
  __shared__ float pose[12];
  __shared__ int positive;

  const long long b = blockIdx.x;
  const long long row = b / problems;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const unsigned full = 0xffffffffu;
  const float* drow = data + row * n * 5;
  const float* wrow = weights + b * n;
  const float* pts = kShared ? smem : drow;
  const float* wts = kShared ? smem + 5 * n : wrow;

  if (tid == 0) positive = 0;
  if (tid < 12) pose[tid] = init[b * 12 + tid];
  if (kShared) {
    for (int i = tid; i < 5 * n; i += kThreads) smem[i] = drow[i];
  }
  int count = 0;
  for (int i = tid; i < n; i += kThreads) {
    const float w = wrow[i];
    if (kShared) smem[5 * n + i] = w;
    count += w > 0.0f;
  }
  count = __reduce_add_sync(full, count);
  __syncthreads();
  if (lane == 0) atomicAdd(&positive, count);
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    float R[9], t[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) R[3 * i + j] = pose[4 * i + j];
      t[i] = pose[4 * i + 3];
    }
    float acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
    for (int i = tid; i < n; i += kThreads) add_point(pts + 5 * i, wts[i], R, t, acc);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
#pragma unroll
      for (int k = 0; k < kSums; ++k) acc[k] += __shfl_down_sync(full, acc[k], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kSums; ++k) red[warp][k] = acc[k];
    }
    __syncthreads();
    if (warp == 0) {
      float s = 0.0f;
      if (lane < kSums) {
        s = red[0][lane];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s += red[w][lane];
      }
      float tot[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) tot[k] = __shfl_sync(full, s, k);
      if (lane == 0) {
        float p[12];
#pragma unroll
        for (int k = 0; k < 12; ++k) p[k] = pose[k];
        update_pose(tot, p);
#pragma unroll
        for (int k = 0; k < 12; ++k) pose[k] = p[k];
      }
    }
    __syncthreads();
  }

  if (tid < 12) {
    bool good = positive >= 3;
#pragma unroll
    for (int k = 0; k < 12; ++k) good = good && isfinite(pose[k]);
    out[b * 12 + tid] = good ? pose[tid] : init[b * 12 + tid];
    if (tid == 0) ok[b] = good ? 1 : 0;
  }
}

}  // namespace

// data [rows, n, 5], weights [rows, problems, n], init [rows, problems, 12]
// float32, contiguous; out [rows, problems, 12] float32 and ok
// [rows, problems] bytes (0 or 1). Launches on `stream`, allocates
// nothing and returns cudaGetLastError() (or the error of raising the
// block's shared-memory limit).
extern "C" int pnp_refine(const void* data, const void* weights, const void* init,
                          long long rows, int problems, int n, int iters, void* out,
                          void* ok, void* stream) {
  const long long blocks = rows * problems;
  if (blocks <= 0) return 0;
  const auto* d = static_cast<const float*>(data);
  const auto* w = static_cast<const float*>(weights);
  const auto* i0 = static_cast<const float*>(init);
  auto* o = static_cast<float*>(out);
  auto* k = static_cast<uint8_t*>(ok);
  auto s = static_cast<cudaStream_t>(stream);
  if (n <= kMaxSharedPoints) {
    const int bytes = 24 * n;
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          pnp_refine_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    pnp_refine_kernel<true><<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(
        d, w, i0, problems, n, iters, o, k);
  } else {
    pnp_refine_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        d, w, i0, problems, n, iters, o, k);
  }
  return static_cast<int>(cudaGetLastError());
}
