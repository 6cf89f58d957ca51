// The z-window patch select of MLSMap::getPatch, shared by the lookup
// kernels: among a cell's K patch slots, the valid one whose mean is
// nearest to the query height z with |mean - z| <= z_window; the lowest
// slot wins a tie.  A NaN distance is never a candidate.  This is the
// select of slam_eslam_tpu/mapping/map_pool.py::_block_get_patch and
// mls_grid.get_patch_packed_cells (argmin over inf-filled distances,
// first index on ties), bit for bit: it only compares.
//
// K is a compile-time slot count, so the arrays stay in registers; read
// an element at a run-time index with pick(), never with a[i].

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace slot_select {

// Index of the selected slot, or -1 when no slot is a candidate.
template <int K>
__device__ __forceinline__ int zwindow_select(const float (&mean)[K],
                                              const bool (&valid)[K], float z,
                                              float z_window) {
  int best = -1;
  float bestd = INFINITY;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const float d = fabsf(mean[s] - z);
    if (valid[s] && d <= z_window && d < bestd) {
      best = s;
      bestd = d;
    }
  }
  return best;
}

// a[s] for a run-time s, without spilling the array to local memory.
template <int K, typename T>
__device__ __forceinline__ T pick(const T (&a)[K], int s) {
  T out = a[0];
#pragma unroll
  for (int i = 1; i < K; ++i) {
    if (i == s) out = a[i];
  }
  return out;
}

__device__ __forceinline__ void load4(const float* __restrict__ p,
                                      float (&o)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ void load4(const int* __restrict__ p,
                                      int (&o)[4]) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

// The K consecutive values at p; at K == 4 one 16-byte load (p must be
// 16-byte aligned: a cell's slots start at a multiple of K elements).
template <int K, typename T>
__device__ __forceinline__ void load_slots(const T* __restrict__ p,
                                           T (&out)[K]) {
  if constexpr (K == 4) {
    load4(p, out);
  } else {
#pragma unroll
    for (int s = 0; s < K; ++s) out[s] = __ldg(p + s);
  }
}

}  // namespace slot_select
