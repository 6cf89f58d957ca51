// Chain lookup: per particle and query point, the first hit along the
// particle's map chain (MLSMap::getPatch over its grid list, head first).
//
// Replaces the TPU kernel slam_eslam_tpu/ops/pallas_chain.py::_chain_kernel
// (entered through chain_lookup_blocks, from map_pool.make_chain_lookup in
// the measurement update and map_pool.match_cloud_all with a one-level
// chain).  Per (n, c): for each chain level l, head first, take block
// b = chain[n, l] (b < 0 voids the level), compute the cell
// floor((x - origin[b]) * inv_res) (the same reciprocal product as the
// plain version, mls_grid.inverse_resolution), and run the z-window slot
// select (slot_select.cuh) over the cell's K slots; the first level with
// a hit gives (found, mean, stdev), none gives (0, 0, 0).  Where the
// caller passes out_slot, the hit slot's element index into the pool's
// flattened fields goes there (64 bits: a large pool has more than 2^31
// slots), -1 for no hit: a colour pool's caller gathers the patch colour
// by it.
//
// What bounds it on an H100: latency of scattered loads.  At the SLAM
// bench shape (N = 4096 particles, C = 8 contacts, L = 3, K = 4, a
// 16,384-block pool of 1.68 GB) one call reads at most N*C*L = 98k cells,
// 48 B each (mean, stdev, meta: one 16-byte load per field), about 4.7 MB,
// and writes 32k x 9 B.  The TPU kernel streams every chain block whole
// through VMEM (3 x 77 KB per particle, ~940 MB per call) and gathers
// with one-hot MXU matmuls, because a TPU gathers slowly; this card reads
// only the touched cell rows.  So the design is one thread per (n, c),
// direct global loads, no shared memory, and an early exit at the first
// level that hits.  Threads past N*C return; nothing is padded.
//
// The pool's mean and stdev are stored as float32 or bfloat16 (the kernel
// is templated on the storage type S); a bfloat16 cell row is one 8-byte
// load per field, upcast exactly, and the select and the outputs are
// float32 either way.
//
// A pure select: it matches the plain version bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#include "slot_select.cuh"

namespace {

template <int K, typename S>
__global__ void __launch_bounds__(256)
chain_lookup_kernel(const S* __restrict__ pool_mean,
                    const S* __restrict__ pool_stdev,
                    const int* __restrict__ pool_meta,
                    const float* __restrict__ origin,
                    const int* __restrict__ chain,
                    const float* __restrict__ qx, const float* __restrict__ qy,
                    const float* __restrict__ qz,
                    unsigned char* __restrict__ found,
                    float* __restrict__ out_mean, float* __restrict__ out_stdev,
                    long long* __restrict__ out_slot, int n, int c, int levels,
                    int num_blocks, int nx, int ny,
                    float inv_res, float z_window) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * c) return;
  const int i = (int)(t / c);
  const float x = __ldg(qx + t);
  const float y = __ldg(qy + t);
  const float z = __ldg(qz + t);

  bool hit = false;
  float mean = 0.0f, stdev = 0.0f;
  long long slot = -1;
  for (int l = 0; l < levels && !hit; ++l) {
    const int b = __ldg(chain + (size_t)i * levels + l);
    if (b < 0 || b >= num_blocks) continue;  // empty chain entry
    const int ix = (int)floorf((x - __ldg(origin + 2 * (size_t)b)) * inv_res);
    const int iy =
        (int)floorf((y - __ldg(origin + 2 * (size_t)b + 1)) * inv_res);
    if (ix < 0 || ix >= nx || iy < 0 || iy >= ny) continue;  // off the block

    const size_t cell = (((size_t)b * nx + ix) * ny + iy) * K;
    float m[K], s[K];
    int meta[K];
    bool valid[K];
    slot_select::load_values<K>(pool_mean + cell, m);
    slot_select::load_slots<K>(pool_meta + cell, meta);
#pragma unroll
    for (int k = 0; k < K; ++k) valid[k] = (meta[k] & 1) != 0;
    const int best = slot_select::zwindow_select<K>(m, valid, z, z_window);
    if (best < 0) continue;
    slot_select::load_values<K>(pool_stdev + cell, s);
    hit = true;
    mean = slot_select::pick<K>(m, best);
    stdev = slot_select::pick<K>(s, best);
    slot = (long long)cell + best;
  }
  found[t] = hit ? 1 : 0;
  out_mean[t] = mean;
  out_stdev[t] = stdev;
  if (out_slot != nullptr) out_slot[t] = slot;
}

template <int K, typename S>
void launch(const S* pool_mean, const S* pool_stdev, const int* pool_meta,
            const float* origin, const int* chain, const float* qx,
            const float* qy, const float* qz, unsigned char* found,
            float* out_mean, float* out_stdev, long long* out_slot, int n,
            int c, int levels, int num_blocks, int nx, int ny, float inv_res,
            float z_window, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long total = (long long)n * c;
  const unsigned int blocks = (unsigned int)((total + kThreads - 1) / kThreads);
  chain_lookup_kernel<K, S><<<blocks, kThreads, 0, stream>>>(
      pool_mean, pool_stdev, pool_meta, origin, chain, qx, qy, qz, found,
      out_mean, out_stdev, out_slot, n, c, levels, num_blocks, nx, ny,
      inv_res, z_window);
}

template <typename S>
int dispatch(const void* pool_mean, const void* pool_stdev,
             const int* pool_meta, const float* origin, const int* chain,
             const float* qx, const float* qy, const float* qz,
             unsigned char* found, float* out_mean, float* out_stdev,
             long long* out_slot, int n, int c, int levels, int num_blocks,
             int nx, int ny, int k,
             float inv_res, float z_window, cudaStream_t st) {
  const S* m = static_cast<const S*>(pool_mean);
  const S* s = static_cast<const S*>(pool_stdev);
  switch (k) {
    case 1: launch<1, S>(m, s, pool_meta, origin, chain, qx, qy, qz, found, out_mean, out_stdev, out_slot, n, c, levels, num_blocks, nx, ny, inv_res, z_window, st); break;
    case 2: launch<2, S>(m, s, pool_meta, origin, chain, qx, qy, qz, found, out_mean, out_stdev, out_slot, n, c, levels, num_blocks, nx, ny, inv_res, z_window, st); break;
    case 4: launch<4, S>(m, s, pool_meta, origin, chain, qx, qy, qz, found, out_mean, out_stdev, out_slot, n, c, levels, num_blocks, nx, ny, inv_res, z_window, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Pool fields are
// [num_blocks, nx, ny*k] (mean/stdev float32, or bfloat16 when `bf16` is
// not 0; int32 packed meta, bit 0 = valid), origin [num_blocks, 2], chain
// [n, levels] int32, queries and outputs [n, c] float32; out_slot [n, c]
// int64 or null.  Launches on
// `stream` and returns cudaGetLastError(); cudaErrorInvalidValue for a k
// other than 1, 2 or 4.
extern "C" int chain_lookup_launch(const void* pool_mean,
                                   const void* pool_stdev,
                                   const int* pool_meta, const float* origin,
                                   const int* chain, const float* qx,
                                   const float* qy, const float* qz,
                                   unsigned char* found, float* out_mean,
                                   float* out_stdev, long long* out_slot,
                                   int n, int c, int levels, int num_blocks,
                                   int nx, int ny, int k,
                                   int bf16, float inv_res, float z_window,
                                   void* stream) {
  if ((long long)n * c <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return dispatch<__nv_bfloat16>(pool_mean, pool_stdev, pool_meta, origin, chain, qx, qy, qz, found, out_mean, out_stdev, out_slot, n, c, levels, num_blocks, nx, ny, k, inv_res, z_window, st);
  }
  return dispatch<float>(pool_mean, pool_stdev, pool_meta, origin, chain, qx, qy, qz, found, out_mean, out_stdev, out_slot, n, c, levels, num_blocks, nx, ny, k, inv_res, z_window, st);
}
