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
// What bounds it on an H100: latency of dependent scattered loads.  At
// the SLAM bench shape (N = 4096 particles, C = 8 contacts, L = 3, K = 4,
// a 16,384-block pool of 1.68 GB) one call reads at most N*C*L = 98k
// cells, 48 B each (mean, stdev, meta: one 16-byte load per field), about
// 4.7 MB, and writes 32k x 9 B.  The TPU kernel streams every chain block
// whole through VMEM (3 x 77 KB per particle, ~940 MB per call) and
// gathers with one-hot MXU matmuls, because a TPU gathers slowly; this
// card reads only the touched cell rows.  A walk that loads a level only
// after the level before it missed costs up to 1 + 3 L trips to memory
// (chain entry, origin, mean and meta, then the next level), and most
// queries miss the head.
//
// Design: one thread per (n, c), direct global loads, no shared memory.
// The thread loads its particle's chain entries (kLevels of them at a
// time) and all their block origins together and computes every level's
// cell before it touches the pool; then it walks the levels head first,
// each level's mean and meta rows, its select, and on a hit the stdev
// row.  So the trips to memory are chain, origins, then two per level
// reached (rows, stdev at the hit), against 1 + 3 L for a walk that loads
// each level's chain entry and origin only after the level before it
// missed; and no cell row is read past the first hit.  Loading every
// level's rows before any select (about four trips in all) was measured
// too: it gained at 4,096 particles and lost at 100,000, where the row
// loads of levels past the first hit cost more than the trips they save
// (PERF.md; utils/kernel_eff.py::chain_traffic counts both).  The stdev
// row is loaded after the walk, not inside it: the form with the load in
// the loop was measured a tenth slower at 4,096.  Threads past N*C
// return; nothing is padded.
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

// chain levels whose loads are in flight together
constexpr int kLevels = 4;

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
  for (int l0 = 0; l0 < levels && !hit; l0 += kLevels) {
    // the chain entries, then their origins
    int b[kLevels];
#pragma unroll
    for (int u = 0; u < kLevels; ++u) {
      b[u] = l0 + u < levels ? __ldg(chain + (size_t)i * levels + l0 + u)
                             : -1;
    }
    float ox[kLevels], oy[kLevels];
#pragma unroll
    for (int u = 0; u < kLevels; ++u) {
      ox[u] = oy[u] = 0.0f;
      if (b[u] >= 0 && b[u] < num_blocks) {
        ox[u] = __ldg(origin + 2 * (size_t)b[u]);
        oy[u] = __ldg(origin + 2 * (size_t)b[u] + 1);
      }
    }
    // every level's cell; an empty chain entry or a cell off its block
    // skips the level
    bool on[kLevels];
    size_t cell[kLevels];
#pragma unroll
    for (int u = 0; u < kLevels; ++u) {
      const int ix = (int)floorf((x - ox[u]) * inv_res);
      const int iy = (int)floorf((y - oy[u]) * inv_res);
      on[u] = b[u] >= 0 && b[u] < num_blocks && ix >= 0 && ix < nx &&
              iy >= 0 && iy < ny;
      cell[u] = on[u] ? (((size_t)b[u] * nx + ix) * ny + iy) * K : 0;
    }
    // head first: the level's mean and meta rows, then its select; the
    // first level that hits gives the result
    float m[kLevels][K];
    int meta[kLevels][K];
    int level = -1, best = -1;
#pragma unroll
    for (int u = 0; u < kLevels; ++u) {
      if (level >= 0 || !on[u]) continue;
      slot_select::load_values<K>(pool_mean + cell[u], m[u]);
      slot_select::load_slots<K>(pool_meta + cell[u], meta[u]);
      bool valid[K];
#pragma unroll
      for (int k = 0; k < K; ++k) valid[k] = (meta[u][k] & 1) != 0;
      const int sel = slot_select::zwindow_select<K>(m[u], valid, z,
                                                     z_window);
      if (sel >= 0) {
        level = u;
        best = sel;
        mean = slot_select::pick<K>(m[u], sel);
      }
    }
    if (level < 0) continue;
    // the stdev row of the hit level
    size_t at = cell[0];
#pragma unroll
    for (int u = 1; u < kLevels; ++u) {
      if (u == level) at = cell[u];
    }
    float s[K];
    slot_select::load_values<K>(pool_stdev + at, s);
    hit = true;
    stdev = slot_select::pick<K>(s, best);
    slot = (long long)at + best;
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
