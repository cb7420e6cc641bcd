// Exact 1-nearest-neighbour search on Hopper (sm_90a), CUDA cores only.
//
// Replaces the Pallas TPU kernel of the JAX package,
// delta_graph_slam_tpu/ops/pallas_nn.py (_nn_kernel, nn_1_pallas, reached
// through nn_1_auto), and with it the XLA scan ops/knn.py:nn_1 that the
// main path runs: the fitness of every odometry and loop edge
// (pipeline/information_matrix.py), loop validation, the brute odometry
// status (models/scan_matching_odometry.py) and brute GICP correspondences
// (register/engine.py).
//
// What it computes, for every query i:
//   d2[i]  = min over valid targets j (j != i under exclude_self) of
//            max(|q_i|^2 - 2 q_i.t_j + |t_j|^2, 0)
//   idx[i] = the smallest j that reaches that minimum.
// An invalid query gets d2 = +inf and idx = 0; a query with no valid target
// keeps d2 = +inf and idx = 0, as ops/knn.py:nn_1 returns.
//
// What bounds it: every query meets every valid target. At the fitness
// shape (28,000 valid queries x 27,500 valid targets of 32768 x 32768
// slots) that is 7.7e8 pairs; at 8 FP32 operations a pair (|q - t|^2:
// three subtracts, three multiplies, two adds) 6.2 GFLOP, 0.092 ms at the
// H100's 67 TFLOP/s of FP32 outside the tensor cores, against ~1 MB of
// inputs (0.3 us at 3.35 TB/s): bound by the FP32 issue rate.
//
// Why not the tensor cores: at K = 3 a TF32 product keeps 10 mantissa bits,
// so coordinates near 25 m fall on a 1.6 cm grid and nearest neighbours
// move. 3xTF32 emulation restores the precision, but the compare and select
// of every pair still run on the CUDA cores; the FFMA form below is at
// least as fast and exact in float32.
//
// What the design does about the bound:
// 1. Fill the card. A block owns kQueries queries (kR per thread, in
//    registers) and one share of the targets: the target axis is split
//    `splits` ways (1..8, chosen by ops/nn_kernel.py:launch_geometry from
//    N, M and the SM count), so the grid holds q_tiles x splits blocks
//    where it held q_tiles. Split s takes the tiles s, s + splits, ...:
//    a valid prefix (a compacted cloud) spreads evenly over the splits, so
//    their blocks do equal work. The blocks of one query tile form a
//    thread-block cluster; rank 0 reads the others' partials from their
//    shared memory (distributed shared memory) and merges them. One
//    launch, no atomics, no scratch in device memory beyond the packed
//    targets.
// 2. Few instructions a pair. A pre-pass packs every target once a call as
//    float4 (-2x, -2y, -2z, |t|^2), with |t|^2 = +inf for a masked target.
//    The scan keeps only the running minimum of v = |t|^2 - 2 q.t: a pair
//    is three FFMAs and one FMNMX, and one broadcast shared-memory load
//    feeds kR pairs; |q|^2 is added once per query, at the end. Tracking
//    the index beside the minimum (a compare and a select a pair, both on
//    the ALU pipe with the FMNMX) ran markedly slower on the H100.
//    Instead the scan notes, once per chunk of kChunk targets, whether the
//    chunk lowered the minimum; the last chunk that did holds the first
//    index reaching it, and after the merge rank 0 recomputes that one
//    chunk's values (the same FMAs, the same bits) and takes the first
//    index equal to the minimum.
// 3. exclude_self is a template parameter: only that instantiation tests
//    j == i, and only on the tiles that overlap the block's own queries.
// 4. Masked tiles are skipped: one block-wide vote per staged tile
//    (__syncthreads_or on |t|^2 < inf). Compacted clouds are a valid
//    prefix, so trailing masked targets cost a load and a vote.
// 5. Staging: plain coalesced float4 loads of a kTile slice of the packed
//    targets (L2-resident, 16 B a target) into shared memory; the latency
//    of a tile load is hidden by the other blocks resident on the SM.
// 6. Batches: B independent problems of equal shapes (queries (B,n,3),
//    targets (B,m,3), masks per problem) are one launch, the problem index
//    on blockIdx.z; clusters stay (splits,1,1) within one problem. The
//    batched registration of parallel/ (the reference's vmap of nn_1) runs
//    its B correspondence searches this way. Problem 0 is the unbatched
//    call: the same pointers, the same bits.
//
// The tie rule: the first index among equal minima. Within a split, a
// chunk counts as lowering the minimum only when it does so strictly, so
// the last such chunk holds the first occurrence of the final minimum;
// between splits, whose chunks are disjoint, equal values go to the
// earlier chunk. The clamp at 0 makes a plateau: every target whose
// computed distance is <= 0 (one within the rounding of the query, ~1 cm
// at 36 m) ties at 0, and the rule takes the first of them, where the
// unclamped minimum would take the smallest v. A per-pair clamp
// (max(v, -|q|^2)) costs one more FMNMX a pair; instead a thread checks
// after each tile whether its minimum fell below -|q|^2, which needs such
// a target, and only then scans that tile again with the clamp from the
// state it had before the tile. The per-pair arithmetic does not depend
// on the launch geometry, so every geometry gives the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// ops/nn_kernel.py mirrors kThreads * kR, kTile and kMaxSplits.
constexpr int kThreads = 128;                       // threads per block
constexpr int kR = 4;                               // queries per thread
constexpr int kQueries = kThreads * kR;             // queries per block
constexpr int kTile = 512;                          // targets per staged tile
constexpr int kLoads = kTile / kThreads;            // float4 loads a thread a tile
constexpr int kChunk = 32;                          // targets of one unrolled run
constexpr int kMaxSplits = 8;                       // the portable cluster size
constexpr int kMinBlocks = 512 / kThreads;          // <= 128 registers a thread
static_assert(kTile % kThreads == 0, "a tile is a whole number of loads");
static_assert(kTile % kChunk == 0, "a tile is a whole number of chunks");

__global__ void pack_targets(const float* __restrict__ target,
                             const uint8_t* __restrict__ tmask, int m,
                             float4* __restrict__ packed) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  float4 p = make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
  if (tmask[j] != 0) {
    const float x = target[3 * j], y = target[3 * j + 1], z = target[3 * j + 2];
    p = make_float4(-2.f * x, -2.f * y, -2.f * z, x * x + y * y + z * z);
  }
  packed[j] = p;
}

// v = |t|^2 - 2 q.t of one packed target and one query. Every comparison
// of the kernel goes through this one function: a value recomputed later
// has the same bits as the value the scan kept.
__device__ __forceinline__ float pair_value(float4 t, float qx, float qy,
                                            float qz) {
  return fmaf(qx, t.x, fmaf(qy, t.y, fmaf(qz, t.z, t.w)));
}

// One staged tile against the thread's kR queries: the running minimum of
// v per query, and the start of the last chunk of kChunk targets that
// lowered it strictly (the chunk that holds the minimum's first index).
// kClamp floors v at -|q|^2 (the clamped rule, see the header); kSelf
// drops j == qi. Each chunk is fully unrolled: a pair is three FFMAs and
// one FMNMX, and one broadcast LDS.128 feeds kR pairs.
template <bool kSelf, bool kClamp>
__device__ __forceinline__ void scan_tile(
    const float4* __restrict__ tile, int base, const float (&qx)[kR],
    const float (&qy)[kR], const float (&qz)[kR], const float (&floor_v)[kR],
    const int (&qi)[kR], float (&best)[kR], int (&chunk)[kR]) {
#pragma unroll 1
  for (int c0 = 0; c0 < kTile; c0 += kChunk) {
    float before[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) before[r] = best[r];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const float4 t = tile[c0 + c];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        float v = pair_value(t, qx[r], qy[r], qz[r]);
        if (kClamp) v = fmaxf(v, floor_v[r]);
        if (kSelf && base + c0 + c == qi[r]) v = CUDART_INF_F;
        best[r] = fminf(v, best[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (best[r] < before[r]) chunk[r] = base + c0;
    }
  }
}

template <bool kSelf>
__device__ __forceinline__ void scan_tile_exact(
    const float4* __restrict__ tile, int base, const float (&qx)[kR],
    const float (&qy)[kR], const float (&qz)[kR], const float (&floor_v)[kR],
    const int (&qi)[kR], float (&best)[kR], int (&chunk)[kR]) {
  float best0[kR];
  int chunk0[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    best0[r] = best[r];
    chunk0[r] = chunk[r];
  }
  scan_tile<kSelf, false>(tile, base, qx, qy, qz, floor_v, qi, best, chunk);
  bool below = false;
#pragma unroll
  for (int r = 0; r < kR; ++r) below |= best[r] < floor_v[r];
  if (below) {  // a target within rounding of a query: take the clamped rule
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      best[r] = best0[r];
      chunk[r] = chunk0[r];
    }
    scan_tile<kSelf, true>(tile, base, qx, qy, qz, floor_v, qi, best, chunk);
  }
}

template <bool kExcludeSelf>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
nn1_kernel(const float* __restrict__ query, const uint8_t* __restrict__ qmask,
           int n, const float4* __restrict__ packed, int m,
           float* __restrict__ out_d2, int32_t* __restrict__ out_idx) {
  __shared__ float4 tile[kTile];
  __shared__ float part_v[kQueries];
  __shared__ int part_c[kQueries];

  // problem blockIdx.z of the batch: its rows of every array
  const size_t z = blockIdx.z;
  query += z * n * 3;
  qmask += z * n;
  packed += z * m;
  out_d2 += z * n;
  out_idx += z * n;

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  const int q0 = static_cast<int>(blockIdx.x / splits) * kQueries;
  const int t = threadIdx.x;

  float qx[kR], qy[kR], qz[kR], floor_v[kR], best[kR];
  int qi[kR], chunk[kR];
  bool active[kR];
  int any_active = 0;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = q0 + t + r * kThreads;
    qi[r] = i;
    active[r] = i < n && qmask[i] != 0;
    qx[r] = qy[r] = qz[r] = 0.f;
    if (i < n) {
      qx[r] = query[3 * i];
      qy[r] = query[3 * i + 1];
      qz[r] = query[3 * i + 2];
    }
    floor_v[r] = -(qx[r] * qx[r] + qy[r] * qy[r] + qz[r] * qz[r]);
    best[r] = CUDART_INF_F;
    chunk[r] = 0;
    any_active |= active[r];
  }

  // A query tile without a valid query: the same vote in every block of
  // the cluster, so all of them leave here and none waits at cluster.sync.
  if (!__syncthreads_or(any_active)) {
    if (split == 0) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (qi[r] < n) {
          out_d2[qi[r]] = CUDART_INF_F;
          out_idx[qi[r]] = 0;
        }
      }
    }
    return;
  }

  for (int base = split * kTile; base < m; base += splits * kTile) {
    __syncthreads();  // every thread is done with the previous tile
    int valid = 0;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int k = t + u * kThreads;
      float4 p = make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
      if (base + k < m) p = packed[base + k];
      valid |= p.w < CUDART_INF_F;
      tile[k] = p;
    }
    if (!__syncthreads_or(valid)) continue;  // every target masked
    if constexpr (kExcludeSelf) {
      if (base < q0 + kQueries && q0 < base + kTile) {
        scan_tile_exact<true>(tile, base, qx, qy, qz, floor_v, qi, best, chunk);
        continue;
      }
    }
    {
      scan_tile_exact<false>(tile, base, qx, qy, qz, floor_v, qi, best, chunk);
    }
  }

  if (splits > 1) {
    if (split != 0) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        part_v[t + r * kThreads] = best[r];
        part_c[t + r * kThreads] = chunk[r];
      }
    }
    cluster.sync();  // the partials are written and visible to rank 0
    if (split == 0) {
      for (int s = 1; s < splits; ++s) {
        const float* rv = cluster.map_shared_rank(part_v, s);
        const int* rc = cluster.map_shared_rank(part_c, s);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          // the splits' chunks are disjoint: between equal values the
          // earlier chunk holds the earlier index
          const float v = rv[t + r * kThreads];
          const int c = rc[t + r * kThreads];
          if (v < best[r] || (v == best[r] && c < chunk[r])) {
            best[r] = v;
            chunk[r] = c;
          }
        }
      }
    }
    cluster.sync();  // rank 0 is done reading the others' shared memory
  }

  if (split == 0) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (qi[r] >= n) continue;
      // the first index of the winning chunk whose value is the minimum
      // (the clamped comparison is exact for an unclamped minimum too),
      // eight loads in flight at a time
      int first = kChunk;
      if (active[r] && best[r] < CUDART_INF_F) {
#pragma unroll 8
        for (int c = kChunk - 1; c >= 0; --c) {
          const int j = chunk[r] + c;
          const float4 p = j < m ? packed[j] : make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
          float v = fmaxf(pair_value(p, qx[r], qy[r], qz[r]), floor_v[r]);
          if (kExcludeSelf && j == qi[r]) v = CUDART_INF_F;
          if (v == best[r]) first = c;
        }
      }
      const int best_j = first < kChunk ? chunk[r] + first : 0;
      out_d2[qi[r]] = active[r] ? fmaxf(best[r] - floor_v[r], 0.f) : CUDART_INF_F;
      out_idx[qi[r]] = active[r] ? best_j : 0;
    }
  }
}

}  // namespace

// Launches the pre-pass and the search on `stream` and returns a CUDA error
// code: non-zero when an argument is out of range or a launch was refused.
// `batch` problems lie back to back in every array (batch 1: one problem).
// The caller allocates the outputs and `packed` (batch * m float4), checks
// n > 0 and batch * m < 2^31, and picks splits
// (ops/nn_kernel.py:launch_geometry).
extern "C" int dgs_nn1(const float* query, const uint8_t* qmask, int n,
                       const float* target, const uint8_t* tmask, int m,
                       int batch, int exclude_self, int splits, void* packed,
                       float* out_d2, int32_t* out_idx, void* stream) {
  if (n <= 0 || m < 0 || batch < 1 || batch > 65535 || splits < 1 ||
      splits > kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* buf = static_cast<float4*>(packed);
  if (m > 0) {
    const int bm = batch * m;  // the problems' targets are one array
    pack_targets<<<(bm + 255) / 256, 256, 0, s>>>(target, tmask, bm, buf);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned q_tiles = (static_cast<unsigned>(n) + kQueries - 1) / kQueries;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(q_tiles * static_cast<unsigned>(splits), 1,
                     static_cast<unsigned>(batch));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float4* cbuf = buf;
  const cudaError_t err =
      exclude_self
          ? cudaLaunchKernelEx(&cfg, nn1_kernel<true>, query, qmask, n, cbuf, m,
                               out_d2, out_idx)
          : cudaLaunchKernelEx(&cfg, nn1_kernel<false>, query, qmask, n, cbuf,
                               m, out_d2, out_idx);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
