// Exact 1-nearest-neighbour search on Hopper (sm_90a), CUDA cores only.
//
// Replaces the Pallas TPU kernel of the JAX package,
// delta_graph_slam_tpu/ops/pallas_nn.py (_nn_kernel, nn_1_pallas, reached
// through nn_1_auto), and with it the XLA scan ops/knn.py:nn_1 that the
// main path runs: the fitness of every odometry edge
// (pipeline/information_matrix.py), the brute odometry status
// (models/scan_matching_odometry.py) and brute GICP correspondences
// (register/engine.py).
//
// What it computes, for every query i:
//   d2[i]  = min over valid targets j (j != i under exclude_self) of
//            max(|q_i|^2 - 2 q_i.t_j + |t_j|^2, 0)
//   idx[i] = the smallest j that reaches that minimum.
// An invalid query gets d2 = +inf and idx = 0; a query with no valid target
// keeps d2 = +inf and idx = 0, as ops/knn.py:nn_1 returns.
//
// What bounds it: with K = 3 a pair costs about 8 FP32 operations (three
// FMAs for the dot product, two for the distance, a max, a compare and the
// selects), and every target is reused by every query. At the fitness shape
// of 32768 x 32768 that is 1.07e9 pairs, about 8.6 GFLOP, against 0.8 MB of
// inputs: the kernel is bound by the FP32 issue rate of the CUDA cores, not
// by memory. Tensor cores do not pay at K = 3, and TF32 would round the
// coordinates.
//
// What the tiling does about it: each thread owns one query and keeps q,
// |q|^2 and its running (best d2, best index) in registers. A block of
// kThreads queries walks the targets in tiles of kTile staged in shared
// memory as float4 (x, y, z, |t|^2, with |t|^2 = +inf for a masked or
// out-of-range target). A target is read from device memory once per block
// and from shared memory as a broadcast, so the inner loop is arithmetic
// only. Targets are visited in increasing index under a strict '<', which
// keeps the smallest index among equal minima, as the Pallas kernel's first
// argmin per tile plus strict improvement across tiles does. The ragged
// edges of N and M are masked inside the kernel: every capacity works.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // queries per block
constexpr int kTile = 256;     // targets staged per shared-memory tile

__global__ void __launch_bounds__(kThreads)
nn1_kernel(const float* __restrict__ query, const uint8_t* __restrict__ qmask,
           int n, const float* __restrict__ target,
           const uint8_t* __restrict__ tmask, int m, int exclude_self,
           float* __restrict__ out_d2, int32_t* __restrict__ out_idx) {
  __shared__ float4 tile[kTile];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n && qmask[i] != 0;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (i < n) {
    qx = query[3 * i];
    qy = query[3 * i + 1];
    qz = query[3 * i + 2];
  }
  const float qq = qx * qx + qy * qy + qz * qz;
  float best = CUDART_INF_F;
  int best_j = 0;

  for (int base = 0; base < m; base += kTile) {
    float4 t = make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
    const int j = base + threadIdx.x;
    if (j < m && tmask[j] != 0) {
      t.x = target[3 * j];
      t.y = target[3 * j + 1];
      t.z = target[3 * j + 2];
      t.w = t.x * t.x + t.y * t.y + t.z * t.z;
    }
    __syncthreads();  // every thread is done with the previous tile
    tile[threadIdx.x] = t;
    __syncthreads();
    if (active) {
#pragma unroll 16
      for (int k = 0; k < kTile; ++k) {
        const float4 tk = tile[k];
        const float qt = qx * tk.x + qy * tk.y + qz * tk.z;
        float d2 = fmaxf(qq - 2.f * qt + tk.w, 0.f);
        if (exclude_self && base + k == i) d2 = CUDART_INF_F;
        if (d2 < best) {
          best = d2;
          best_j = base + k;
        }
      }
    }
  }
  if (i < n) {
    out_d2[i] = active ? best : CUDART_INF_F;
    out_idx[i] = active ? best_j : 0;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): non-zero when the
// launch was refused. The caller allocates the outputs and checks n > 0.
extern "C" int dgs_nn1(const float* query, const uint8_t* qmask, int n,
                       const float* target, const uint8_t* tmask, int m,
                       int exclude_self, float* out_d2, int32_t* out_idx,
                       void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  nn1_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      query, qmask, n, target, tmask, m, exclude_self, out_d2, out_idx);
  return static_cast<int>(cudaGetLastError());
}
