// Fused compound-penalized scoring of hypotheses (sm_90a): the body that the
// per-family sources (score_homography.cu, score_fundamental.cu) share.
//
// Replaces the body of the Pallas TPU kernel
// progressivex_tpu/ops/pallas_scoring.py:91-126 (`_score_kernel`, launched by
// `fused_scores` at :155). Its two residual functions (`_homography_r2` and
// `_sampson_r2`) become the functors passed as `Residual`. For every
// (hypothesis b, point n) the kernel forms the squared residual r2,
// x = r2 / tau_t^2, the hard-tau preference pref = max(0, 1 - x) and the
// ranking preference (pref, or the MAGSAC ladder
// (1/m) sum_j max(0, 1 - x / (j/m)^2)), and reduces five sums over the
// points:
//   raw = sum rank_pref, shared = sum min(pref, compound),
//   inliers = #{r2 < tau_t^2 / 2.25}, dot = sum pref * compound,
//   norm = sum pref^2,
// all over unmasked points only. The epilogue writes
//   score = has_compound ? raw - max(shared, 0)^exponent : raw.
//
// What bounds it on an H100. The work is small: at the proposal shapes
// ([256, 2304] for H, [1536, 256] for F) a pass is 25-35 MFLOP, a few tenths
// of a microsecond at the f32 peak, and reads under 100 KB. In instructions
// a pair costs more than its operation count: up to four divisions, and an
// IEEE division (div.rn.f32) is a reciprocal, a Newton step, a correction
// and a range check with a slow-path branch, which also keeps the compiler
// from interleaving the divisions of several hypotheses. A launch costs
// about 1.5 us. So issue slots, dependency latency and the launch set the
// time, not bytes, and the design aims at keeping every SM issuing.
//
// Rows. One launch scores R independent problems (the rows of the engine's
// row axis: scenes, restarts): data [R, N, 4], compound and mask [R, N],
// descriptors [R, B, 9], tau_t^2 and has_compound per row, outputs [R, B].
// This is what `fused_scores` computes under `jax.vmap`, where the
// pallas_call gains a grid axis. A block belongs to one row, and a cluster
// too: the grid is R x ceil(B / K) x S blocks, row-major. K may follow R B,
// but the cluster size and the thread count follow the row's own (B, N)
// (kernels/scoring._tiling), and K does not change a sum's order (each
// hypothesis is summed over the same lanes, warps and ranks whatever K),
// so a row's outputs do not depend on R or on the other rows, bit for bit.
//
// Design.
//  - A block owns a tile of K (1, 2 or 4) hypotheses; each thread keeps their K
//    descriptors (9 K floats) and 5 K running sums in registers. The block's
//    threads split the block's point range, so every point read from shared
//    memory is scored against K hypotheses: K independent dependency chains
//    per thread. The wrapper (kernels/scoring._tiling) picks K, the cluster
//    size and the block size from B and N, so that the grid covers the SMs
//    in one wave where B allows.
//  - When B is small (the LO rescoring at B = 4) the point range of each
//    hypothesis tile is split over a thread block cluster of S <= 8 blocks;
//    the S partial sums meet in rank 0's block through distributed shared
//    memory, in rank order.
//  - Points reach shared memory by Hopper's bulk async copy
//    (cp.async.bulk, completion on an mbarrier), through a two-stage ring
//    of up to kMaxTile points a stage: a point is 21 bytes (float4 of
//    coordinates, the compound value, the mask byte), so a stage is at most
//    21 KB and the largest pad level does not depend on one allocation
//    fitting. Thread 0 issues the copies; the tail of a tile that is not a
//    multiple of 16 points (bulk copies move multiples of 16 bytes) is
//    loaded by plain loads. Consecutive threads read consecutive points, so
//    the shared-memory reads are free of bank conflicts.
//  - No branch on the mask: a masked point enters as x = 1 and compound 0,
//    which makes each of its terms +0, so rows of any value under a false
//    mask change nothing.
//  - r2 keeps its IEEE divisions, each residual is written in the
//    operation order of its plain torch version and the sources are built
//    with -fmad=false: r2, and with it the inlier count, matches the plain
//    version bit for bit.
//  - x = r2 / tau_t^2 is an IEEE division too. For m = 4 levels the
//    ladder's divisors (j/m)^2 are 1/16, 1/4, 9/16 and 1: x / (1/16) ==
//    x * 16, x / (1/4) == x * 4 and x / 1 == x bit for bit, so only j = 3
//    divides. m is a template parameter (0, 4 and a generic instance for
//    any other value).
//  - Deterministic sums: warp shuffles in a fixed pattern (halving the
//    values held at each step while K allows, so a warp's reduction at
//    K = 4 is 30 shuffles, not 100), then warps in a fixed order through
//    shared memory, then cluster ranks in a fixed order; no atomics. Two
//    launches on the same inputs give the same bits.
//  - No tensor cores: the projections are products of depth 3, and exact
//    f32 r2 is needed for exact inlier counts, which TF32 or bf16 operands
//    would break, so wgmma has nothing to do here.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace progx {

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 256;
constexpr int kMaxTile = 1024;  // points per ring stage
constexpr int kMaxCluster = 8;
constexpr int kPointBytes = 21;       // float4 + compound + mask byte
constexpr int kGenericLevels = -1;    // M of the instance for any other m

struct ScoreArgs {
  const float4* pts;       // [R, N]
  const float* compound;   // [R, N]
  const uint8_t* mask;     // [R, N]
  const float* descs;      // [R, B, 9]
  const float* trunc_sq;   // [R]
  const uint8_t* has_compound;  // [R]
  int n_hyp, n_pts;        // B and N of a row
  int hyp_tiles;           // ceil(B / K): hypothesis tiles a row
  int chunk;  // points per cluster rank, a multiple of 16
  int tile;   // points per ring stage, a multiple of 16
  float exponent;
  int magsac_levels;
  float* scores;           // [R, B], and the same for the three below
  int* inliers;
  float* dots;
  float* norms;
};

// One row's inputs, offset from the launch's.
struct RowPtrs {
  const float4* pts;
  const float* compound;
  const uint8_t* mask;
  bool bulk;  // compound and mask start on a 16-byte boundary
};

// Dynamic shared memory: the two ring stages, two mbarriers, the per-warp
// partial sums and the block's partial sums (read by cluster rank 0).
__host__ __device__ constexpr int smem_bytes(int tile, int k, int threads) {
  return 2 * kPointBytes * tile + 16 + 5 * 4 * k * (threads / 32 + 1);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for phase `parity` of `bar`; a copy that never lands traps (a
// launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0, spins = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && ++spins == (1u << 24)) __trap();
  } while (!done);
}

// Bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from global to this block's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Points of a stage whose compound and mask come by bulk copy: up to the
// last multiple of 16, or none where the row is not 16-byte aligned.
__device__ __forceinline__ int bulk_points(const RowPtrs& r, int c) {
  return r.bulk ? c & ~15 : 0;
}

// Thread 0: start the copy of points [start, start + c) into a ring stage.
// Compound and mask go by bulk copy for the first bulk_points(c) points;
// the consumer loads the rest.
__device__ __forceinline__ void issue_tile(const ScoreArgs& a, const RowPtrs& r,
                                           int start, int c, unsigned char* stage,
                                           uint64_t* bar) {
  const int c16 = bulk_points(r, c);
  mbar_arrive_expect_tx(bar, 16u * c + 5u * c16);
  bulk_load(stage, r.pts + start, 16u * c, bar);
  if (c16 > 0) {
    bulk_load(stage + 16 * a.tile, r.compound + start, 4u * c16, bar);
    bulk_load(stage + 20 * a.tile, r.mask + start, c16, bar);
  }
}

// The MAGSAC ladder (1/m) sum_j max(0, 1 - x / (j/m)^2) for any m > 0.
__device__ __forceinline__ float ladder(float x, int m) {
  const float inv_m = 1.0f / (float)m;
  float acc = 0.f;
  for (int j = 1; j <= m; ++j) {
    const float s = (float)j * inv_m;
    acc += fmaxf(1.0f - x / (s * s), 0.0f);
  }
  return acc * inv_m;
}

// Sums acc[K][5] over the warp's 32 lanes in a fixed pattern. First
// log2(K) halving steps: each lane keeps half of its hypotheses and adds
// its partner's values of that half, so the shuffles halve with every
// step. Then a butterfly over the lanes that remain. Returns the
// hypothesis whose five sums the lane then holds in acc[0]; lanes whose
// lowest 5 - log2(K) bits are 0 hold each hypothesis once.
template <int K>
__device__ __forceinline__ int warp_reduce(float (&acc)[K][5], int lane) {
  constexpr int kHalvings = K == 4 ? 2 : K == 2 ? 1 : 0;
  int k0 = 0;
#pragma unroll
  for (int step = 0; step < kHalvings; ++step) {
    const int h = K >> (step + 1), off = 16 >> step;
    const bool upper = lane & off;
#pragma unroll
    for (int k = 0; k < h; ++k) {
#pragma unroll
      for (int f = 0; f < 5; ++f) {
        // Both read as values: a conditional over the two elements would
        // select an address and put acc in local memory.
        const float lo = acc[k][f], hi = acc[k + h][f];
        acc[k][f] = (upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, upper ? lo : hi, off);
      }
    }
    k0 += upper ? h : 0;
  }
#pragma unroll
  for (int step = kHalvings; step < 5; ++step) {
#pragma unroll
    for (int f = 0; f < 5; ++f)
      acc[0][f] += __shfl_xor_sync(0xffffffffu, acc[0][f], 16 >> step);
  }
  return k0;
}

// Grid: R x ceil(B / K) x S blocks in clusters of S along x, row-major;
// block x belongs to row x / (ceil(B / K) S) and holds that row's
// hypotheses [K t, K t + K) for its tile t, and cluster rank r the points
// [r chunk, (r + 1) chunk).
template <class Residual, int K, int M>
__global__ void __launch_bounds__(kMaxThreads) score_kernel(const ScoreArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_threads = blockDim.x, n_warps = n_threads >> 5;
  const int row_blocks = a.hyp_tiles * n_ranks;
  const int row = static_cast<int>(blockIdx.x) / row_blocks;
  const int b0 = static_cast<int>(blockIdx.x) % row_blocks / n_ranks * K;
  const size_t pt0 = static_cast<size_t>(row) * a.n_pts;
  const size_t hyp0 = static_cast<size_t>(row) * a.n_hyp;
  RowPtrs r;
  r.pts = a.pts + pt0;
  r.compound = a.compound + pt0;
  r.mask = a.mask + pt0;
  r.bulk = ((reinterpret_cast<uintptr_t>(r.compound) |
             reinterpret_cast<uintptr_t>(r.mask)) & 15) == 0;
  const float trunc_sq = a.trunc_sq[row];
  const int tile = a.tile;
  const int p0 = min(a.n_pts, rank * a.chunk);
  const int p1 = min(a.n_pts, p0 + a.chunk);
  const int n_tiles = (p1 - p0 + tile - 1) / tile;

  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 2 * kPointBytes * tile);
  float* red = reinterpret_cast<float*>(bar + 2);  // [n_warps][K][5]
  float* part = red + n_warps * K * 5;             // [K][5]

  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < min(2, n_tiles); ++t)
      issue_tile(a, r, p0 + t * tile, min(tile, p1 - p0 - t * tile),
                 smem + t * kPointBytes * tile, &bar[t]);
  }

  // Descriptors (the last hypothesis stands in past B) while points land.
  // acc[k]: raw, shared, dot, norm and the inlier count (exact in f32).
  Residual res[K];
  float acc[K][5];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    res[k].load(a.descs + 9 * (hyp0 + min(b0 + k, a.n_hyp - 1)));
#pragma unroll
    for (int f = 0; f < 5; ++f) acc[k][f] = 0.f;
  }
  const float inl_thr = trunc_sq / 2.25f;
  __syncthreads();  // the mbarriers are initialised

  for (int t = 0; t < n_tiles; ++t) {
    unsigned char* stage = smem + (t & 1) * kPointBytes * tile;
    const float4* s_pts = reinterpret_cast<const float4*>(stage);
    float* s_comp = reinterpret_cast<float*>(stage + 16 * tile);
    uint8_t* s_mask = stage + 20 * tile;
    const int start = p0 + t * tile;
    const int c = min(tile, p1 - start);
    for (int j = bulk_points(r, c) + tid; j < c; j += n_threads) {
      s_comp[j] = r.compound[start + j];
      s_mask[j] = r.mask[start + j];
    }
    mbar_wait(&bar[t & 1], (t >> 1) & 1);
    __syncthreads();  // the tail is in place

    for (int i = tid; i < c; i += n_threads) {
      const float4 p = s_pts[i];
      const bool v = s_mask[i] != 0;
      // A masked point enters as x = 1 and compound 0, so that each of
      // its terms is +0: no branch, and rows of any value change nothing.
      const float cp = v ? s_comp[i] : 0.0f;
      float r2[K];
#pragma unroll
      for (int k = 0; k < K; ++k) r2[k] = res[k](p);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float x = v ? r2[k] / trunc_sq : 1.0f;
        const float pref = fmaxf(1.0f - x, 0.0f);
        float rank_pref = pref;
        if (M == 4) {  // the divisors (j/4)^2 are 1/16, 1/4, 9/16, 1
          rank_pref = fmaxf(1.0f - x * 16.0f, 0.0f);
          rank_pref += fmaxf(1.0f - x * 4.0f, 0.0f);
          rank_pref += fmaxf(1.0f - x / 0.5625f, 0.0f);
          rank_pref += pref;
          rank_pref *= 0.25f;
        } else if (M == kGenericLevels) {
          rank_pref = ladder(x, a.magsac_levels);
        }
        acc[k][0] += rank_pref;
        acc[k][1] += fminf(pref, cp);
        acc[k][2] += pref * cp;
        acc[k][3] += pref * pref;
        acc[k][4] += (v && r2[k] < inl_thr) ? 1.0f : 0.0f;
      }
    }
    __syncthreads();  // every thread is done with this stage
    if (tid == 0 && t + 2 < n_tiles) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue_tile(a, r, start + 2 * tile, min(tile, p1 - start - 2 * tile), stage,
                 &bar[t & 1]);
    }
  }

  // Lanes, then warps in order, then cluster ranks in order.
  const int k0 = warp_reduce(acc, lane);
  if ((lane & (32 / K - 1)) == 0) {
#pragma unroll
    for (int f = 0; f < 5; ++f) red[(warp * K + k0) * 5 + f] = acc[0][f];
  }
  __syncthreads();
  if (tid < K) {
    float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < kMaxThreads / 32; ++w) {
      if (w < n_warps) {
#pragma unroll
        for (int f = 0; f < 5; ++f) s[f] += red[(w * K + tid) * 5 + f];
      }
    }
#pragma unroll
    for (int f = 0; f < 5; ++f) part[tid * 5 + f] = s[f];
  }
  if (n_ranks > 1) cluster.sync();  // every rank's partial sums are written
  if (rank == 0 && tid < K && b0 + tid < a.n_hyp) {
    float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < n_ranks) {
        const float* pr = cluster.map_shared_rank(part, r);
#pragma unroll
        for (int f = 0; f < 5; ++f) s[f] += pr[tid * 5 + f];
      }
    }
    const size_t b = hyp0 + b0 + tid;
    const float shared = fmaxf(s[1], 0.0f);  // ^ exponent, as torch's pow takes 1 and 2
    const float penalty = a.exponent == 1.0f   ? shared
                          : a.exponent == 2.0f ? shared * shared
                                               : powf(shared, a.exponent);
    a.scores[b] = a.has_compound[row] ? s[0] - penalty : s[0];
    a.dots[b] = s[2];
    a.norms[b] = s[3];
    a.inliers[b] = static_cast<int>(s[4]);
  }
  if (n_ranks > 1) cluster.sync();  // no block leaves while rank 0 reads it
}

template <class Residual, int K, int M>
cudaError_t launch_instance(ScoreArgs a, int n_rows, int cluster, int threads,
                            cudaStream_t stream) {
  a.hyp_tiles = (a.n_hyp + K - 1) / K;
  const long long blocks = static_cast<long long>(n_rows) * a.hyp_tiles * cluster;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), 1, 1);
  cfg.blockDim = dim3(static_cast<unsigned>(threads), 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes(a.tile, K, threads));
  cfg.stream = stream;
  // A cluster only where the points are split: the attribute costs launch
  // time even at one block a cluster, and a launch without it runs each
  // block as a cluster of one.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, score_kernel<Residual, K, M>, a);
}

template <class Residual, int K>
cudaError_t launch_levels(const ScoreArgs& a, int n_rows, int cluster, int threads,
                          cudaStream_t stream) {
  if (a.magsac_levels <= 0)
    return launch_instance<Residual, K, 0>(a, n_rows, cluster, threads, stream);
  if (a.magsac_levels == 4)
    return launch_instance<Residual, K, 4>(a, n_rows, cluster, threads, stream);
  return launch_instance<Residual, K, kGenericLevels>(a, n_rows, cluster, threads, stream);
}

// Launches score_kernel<Residual, k_tile, .> on `stream` over n_rows rows of
// n_hyp hypotheses and n_pts points each, a cluster of `cluster` blocks per
// hypothesis tile, `threads` threads a block; returns the launch's error or
// else cudaGetLastError(). pts, compound and pmask (bool as bytes) must be
// 16-byte aligned; trunc_sq (f32) and has_compound (bytes) hold one value a
// row.
template <class Residual>
int launch_scores(const void* pts, const void* compound, const void* pmask,
                  const void* descs, int n_rows, int n_hyp, int n_pts,
                  const void* trunc_sq, const void* has_compound, float exponent,
                  int magsac_levels, int k_tile, int cluster, int threads,
                  void* scores, void* inliers, void* dots, void* norms,
                  void* stream) {
  if (n_rows < 1 || n_hyp < 1 || n_pts < 0 || cluster < 1 || cluster > kMaxCluster ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_rank = (n_pts + cluster - 1) / cluster;
  const int chunk = per_rank < 16 ? 16 : (per_rank + 15) & ~15;
  const ScoreArgs a = {
      static_cast<const float4*>(pts), static_cast<const float*>(compound),
      static_cast<const uint8_t*>(pmask), static_cast<const float*>(descs),
      static_cast<const float*>(trunc_sq), static_cast<const uint8_t*>(has_compound),
      n_hyp, n_pts, 0, chunk, chunk < kMaxTile ? chunk : kMaxTile, exponent,
      magsac_levels, static_cast<float*>(scores), static_cast<int*>(inliers),
      static_cast<float*>(dots), static_cast<float*>(norms)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (k_tile) {
    case 1: err = launch_levels<Residual, 1>(a, n_rows, cluster, threads, s); break;
    case 2: err = launch_levels<Residual, 2>(a, n_rows, cluster, threads, s); break;
    case 4: err = launch_levels<Residual, 4>(a, n_rows, cluster, threads, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace progx
