// Select cells: the z-window patch select of the unfolded shared-grid
// lookup, one flat query at a time.
//
// Replaces the TPU kernels of slam_eslam_tpu/ops/pallas_gather.py that the
// unfolded lookup (windowed_grid_lookup without the contact fold) reaches:
// _fused_select_kernel_t (window_select_t, the default q_lanes layout),
// _fused_select_kernel_flat / _flat_direct (window_select_flat, q_flat),
// _fused_select_kernel (window_select, q_sublanes) and _gather_kernel
// (window_gather, fused=False, whose select then ran in XLA).  All four
// compute one function: per query, the cell (ix, iy), the z-window select
// over the cell's K slots (slot_select.cuh: valid = stdev >= 0, |mean - z|
// <= z_window, nearest wins, lowest slot on ties) and (found, mean,
// |stdev|), found also requiring the cell to lie inside the grid.
//
// The plain version is mls_grid.get_patch_packed_cells, and this kernel
// matches it bit for bit, misses included: a query outside the grid reads
// cell (0, 0), and a query without a candidate reports slot 0 of its cell.
//
// What bounds it on an H100: scattered reads of the packed [nx, ny, 2K]
// float32 grid.  At the localisation shape (Q = 800k queries, a 400 x 400
// x 8 grid of 5.1 MB that stays in the 50 MB L2) one call reads 800k x 12
// B of queries (coalesced), 800k x 32 B of cell rows (two 16-byte loads
// each at K = 4, mostly L2 hits) and writes 800k x 9 B.  The TPU kernels'
// VMEM window, one-hot MXU matmuls, window anchor ladder and transposed
// table exist because a TPU gathers slowly; this card reads the cell row
// directly.  So the design is one thread per query, no shared memory, no
// padding (threads past Q return).
//
// Two entry points: world SoA queries (x, y, z), whose cell is
// floor((x - origin) * inv_res) rounded exactly as mls_grid.cells computes
// it, or int32 cells (ix, iy, z).  A pure select: no arithmetic beyond the
// cell index and |mean - z|.

#include <cuda_runtime.h>
#include <math.h>

#include "slot_select.cuh"

namespace {

template <int K>
__device__ __forceinline__ void select_one(const float* __restrict__ table,
                                           int ix, int iy, float z, int nx,
                                           int ny, float z_window,
                                           unsigned char* found, float* mean,
                                           float* stdev) {
  const bool inb = ix >= 0 && ix < nx && iy >= 0 && iy < ny;
  // the plain version reads cell (0, 0) for a query outside the grid
  const size_t cell = inb ? ((size_t)ix * ny + iy) * (2 * K) : 0;
  float m[K], s[K];
  bool valid[K];
  slot_select::load_slots<K>(table + cell, m);
  slot_select::load_slots<K>(table + cell + K, s);
#pragma unroll
  for (int k = 0; k < K; ++k) valid[k] = s[k] >= 0.0f;
  const int best = slot_select::zwindow_select<K>(m, valid, z, z_window);
  // no candidate: slot 0, as argmin over an all-inf row gives
  const int slot = best < 0 ? 0 : best;
  *found = (inb && best >= 0) ? 1 : 0;
  *mean = slot_select::pick<K>(m, slot);
  *stdev = fabsf(slot_select::pick<K>(s, slot));
}

template <int K>
__global__ void __launch_bounds__(256)
select_world_kernel(const float* __restrict__ table,
                    const float* __restrict__ origin,
                    const float* __restrict__ qx, const float* __restrict__ qy,
                    const float* __restrict__ qz,
                    unsigned char* __restrict__ found,
                    float* __restrict__ out_mean, float* __restrict__ out_stdev,
                    long long q, int nx, int ny, float inv_res,
                    float z_window) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= q) return;
  // round each step as the plain version does (no contraction into an FMA)
  const int ix = (int)floorf(__fmul_rn(__fsub_rn(__ldg(qx + t), __ldg(origin)),
                                       inv_res));
  const int iy = (int)floorf(
      __fmul_rn(__fsub_rn(__ldg(qy + t), __ldg(origin + 1)), inv_res));
  select_one<K>(table, ix, iy, __ldg(qz + t), nx, ny, z_window, found + t,
                out_mean + t, out_stdev + t);
}

template <int K>
__global__ void __launch_bounds__(256)
select_cells_kernel(const float* __restrict__ table,
                    const int* __restrict__ qix, const int* __restrict__ qiy,
                    const float* __restrict__ qz,
                    unsigned char* __restrict__ found,
                    float* __restrict__ out_mean, float* __restrict__ out_stdev,
                    long long q, int nx, int ny, float z_window) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= q) return;
  select_one<K>(table, __ldg(qix + t), __ldg(qiy + t), __ldg(qz + t), nx, ny,
                z_window, found + t, out_mean + t, out_stdev + t);
}

constexpr int kThreads = 256;

unsigned int grid_for(long long q) {
  return (unsigned int)((q + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  table: [nx, ny, 2k] float32
// (means, then stdevs, negative = empty slot); queries and outputs: [q].
// Launch on `stream` and return cudaGetLastError(); cudaErrorInvalidValue
// for a k other than 1, 2 or 4.
extern "C" int select_world_launch(const float* table, const float* origin,
                                   const float* qx, const float* qy,
                                   const float* qz, unsigned char* found,
                                   float* out_mean, float* out_stdev,
                                   long long q, int nx, int ny, int k,
                                   float inv_res, float z_window,
                                   void* stream) {
  if (q <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: select_world_kernel<1><<<grid_for(q), kThreads, 0, st>>>(table, origin, qx, qy, qz, found, out_mean, out_stdev, q, nx, ny, inv_res, z_window); break;
    case 2: select_world_kernel<2><<<grid_for(q), kThreads, 0, st>>>(table, origin, qx, qy, qz, found, out_mean, out_stdev, q, nx, ny, inv_res, z_window); break;
    case 4: select_world_kernel<4><<<grid_for(q), kThreads, 0, st>>>(table, origin, qx, qy, qz, found, out_mean, out_stdev, q, nx, ny, inv_res, z_window); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int select_cells_launch(const float* table, const int* qix,
                                   const int* qiy, const float* qz,
                                   unsigned char* found, float* out_mean,
                                   float* out_stdev, long long q, int nx,
                                   int ny, int k, float z_window,
                                   void* stream) {
  if (q <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: select_cells_kernel<1><<<grid_for(q), kThreads, 0, st>>>(table, qix, qiy, qz, found, out_mean, out_stdev, q, nx, ny, z_window); break;
    case 2: select_cells_kernel<2><<<grid_for(q), kThreads, 0, st>>>(table, qix, qiy, qz, found, out_mean, out_stdev, q, nx, ny, z_window); break;
    case 4: select_cells_kernel<4><<<grid_for(q), kThreads, 0, st>>>(table, qix, qiy, qz, found, out_mean, out_stdev, q, nx, ny, z_window); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
