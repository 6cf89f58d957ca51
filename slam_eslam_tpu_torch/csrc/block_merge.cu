// Block merge: fuse one scan's P points into every particle's active map
// block, in place.
//
// Replaces the TPU kernels slam_eslam_tpu/ops/pallas_merge.py::_merge_kernel
// (merge_blocks, one block per grid step) and ::_merge_kernel_grouped
// (merge_blocks_grouped, G blocks per step with manual DMA); both compute
// _merge_body, which is also the XLA branch of map_pool.merge_cloud_all
// (mls_grid._dedup_fuse_rows + fuse_slot_rows).  Per particle n, for each
// cell (lx, ly) of its active block blk[n] that at least one point hits
// (points with an out-of-range lx or ly are masked out):
//   1. W = sum w, WZ = sum wz over the cell's points, z = WZ / max(W, 1e-30),
//      var = 1 / max(W, 1e-30);
//   2. the envire slot rules, lowest slot on every tie:
//      (a) Kalman-fuse with the nearest valid horizontal slot within
//          patch_thickness, else (b) extend the nearest valid slot within
//          gap_size, else (c) insert into the lowest free slot, else evict
//          the highest-stdev slot;
//   3. write the chosen slot's mean, stdev, height and
//      meta = 1 | horizontal << 1 | update_idx << 2, and, when the pool
//      carries colour, the w-weighted mean colour of the cell's points (the
//      XLA branch's colour rule; the TPU kernel cannot carry colour).
//
// What bounds it on an H100: nothing much -- a few scattered cell rows per
// particle.  At the SLAM bench shape (N = 4096, P = 64 points, K = 4) a
// call touches at most N*P cells, each 4 x 16 B read and 4 x 4 B written:
// ~17 MB read and ~4 MB written of a 1.68 GB pool.  The TPU kernel streams
// each particle's whole 102 KB block image through VMEM and accumulates
// with one-hot MXU matmuls, because a TPU scatters and gathers slowly;
// here only the hit cells move.
//
// Design: one CTA per particle.  Heads are unique after
// ensure_unique_active, so CTAs write disjoint blocks and no atomics are
// needed.  The CTA deduplicates its P points by cell with a bitonic sort
// of (cell << 32 | point) keys in shared memory: O(P log^2 P) work, so a
// camera cloud of thousands of points stays cheap; P is bounded by the
// shared memory of one CTA (kMaxPoints keys of 8 bytes; the launcher
// refuses more, and a caller chunks the cloud).  The first entry of each
// run of equal cells then owns that cell: it sums the run's points in
// point-index order (deterministic, no atomics on values, the order of the
// plain version's stable sort), reads the cell's K slots, applies the
// rules, and writes one slot back.
//
// Arithmetic follows the plain version op for op: the fusion formula is
// written with __fmul_rn / __fadd_rn / __fdiv_rn so that nvcc does not
// contract it into FMAs, and 1/x and sqrtf are IEEE (no --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "slot_select.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxPoints = 16384;  // 128 KB of sort keys
constexpr unsigned long long kEmpty = ~0ull;

__device__ __forceinline__ void bitonic_sort(unsigned long long* keys,
                                             int count) {
  // count is a power of two; ascending
  for (int size = 2; size <= count; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < count / 2; t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool ascending = (lo & size) == 0;
        const unsigned long long a = keys[lo];
        const unsigned long long b = keys[hi];
        if ((a > b) == ascending) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
block_merge_kernel(float* __restrict__ pool_mean, float* __restrict__ pool_stdev,
                   float* __restrict__ pool_height, int* __restrict__ pool_meta,
                   float* __restrict__ pool_color,
                   const int* __restrict__ blk, const int* __restrict__ lx,
                   const int* __restrict__ ly, const float* __restrict__ w,
                   const float* __restrict__ wz,
                   const float* __restrict__ point_color, int p, int p_pad,
                   int num_blocks, int nx, int ny, int update_idx,
                   float patch_thickness, float gap_size) {
  extern __shared__ unsigned long long keys[];
  const int n = blockIdx.x;
  const int b = __ldg(blk + n);
  if (b < 0 || b >= num_blocks) return;  // uniform across the CTA
  const size_t row = (size_t)n * p;

  for (int j = threadIdx.x; j < p_pad; j += blockDim.x) {
    unsigned long long key = kEmpty;
    if (j < p) {
      const int x = __ldg(lx + row + j);
      const int y = __ldg(ly + row + j);
      if (x >= 0 && x < nx && y >= 0 && y < ny) {
        key = ((unsigned long long)((unsigned)x * (unsigned)ny + (unsigned)y)
               << 32) | (unsigned)j;
      }
    }
    keys[j] = key;
  }
  __syncthreads();
  bitonic_sort(keys, p_pad);

  for (int j = threadIdx.x; j < p; j += blockDim.x) {
    const unsigned long long key = keys[j];
    if (key == kEmpty) continue;
    const unsigned cell = (unsigned)(key >> 32);
    if (j > 0 && (unsigned)(keys[j - 1] >> 32) == cell) continue;

    // this thread owns the cell: sums over its run, in point order
    float ws = 0.0f, wzs = 0.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
    for (int r = j; r < p; ++r) {
      const unsigned long long kr = keys[r];
      if (kr == kEmpty || (unsigned)(kr >> 32) != cell) break;
      const unsigned q = (unsigned)(kr & 0xffffffffu);
      const float wq = __ldg(w + row + q);
      ws = __fadd_rn(ws, wq);
      wzs = __fadd_rn(wzs, __ldg(wz + row + q));
      if (pool_color != nullptr) {
        cr = __fadd_rn(cr, __fmul_rn(wq, __ldg(point_color + 3 * q)));
        cg = __fadd_rn(cg, __fmul_rn(wq, __ldg(point_color + 3 * q + 1)));
        cb = __fadd_rn(cb, __fmul_rn(wq, __ldg(point_color + 3 * q + 2)));
      }
    }
    const float wsafe = fmaxf(ws, 1e-30f);
    const float z = __fdiv_rn(wzs, wsafe);
    const float var = __fdiv_rn(1.0f, wsafe);

    const unsigned ix = cell / (unsigned)ny;
    const unsigned iy = cell - ix * (unsigned)ny;
    const size_t base = (((size_t)b * nx + ix) * ny + iy) * K;
    float m[K], s[K], h[K];
    int meta[K];
    slot_select::load_slots<K>(pool_mean + base, m);
    slot_select::load_slots<K>(pool_stdev + base, s);
    slot_select::load_slots<K>(pool_height + base, h);
    slot_select::load_slots<K>(pool_meta + base, meta);

    int fslot = -1, gslot = -1, free_slot = -1, eslot = 0;
    float fbest = INFINITY, gbest = INFINITY, ebest = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool valid = (meta[k] & 1) != 0;
      const bool horiz = (meta[k] & 2) != 0;
      const float d = fabsf(m[k] - z);
      if (valid && horiz && d <= patch_thickness && d < fbest) {
        fslot = k;
        fbest = d;
      }
      if (valid && d <= gap_size && d < gbest) {
        gslot = k;
        gbest = d;
      }
      if (!valid && free_slot < 0) free_slot = k;
      // first maximum of where(valid, stdev, -inf)
      const float ev = valid ? s[k] : -INFINITY;
      if (k == 0 || ev > ebest) {
        eslot = k;
        ebest = ev;
      }
    }
    const bool can_fuse = fslot >= 0;
    const bool can_gap = !can_fuse && gslot >= 0;
    const int slot = can_fuse ? fslot
                     : can_gap ? gslot
                     : (free_slot >= 0 ? free_slot : eslot);
    const float m0 = slot_select::pick<K>(m, slot);
    const float s0 = slot_select::pick<K>(s, slot);
    const float h0 = slot_select::pick<K>(h, slot);

    float new_mean, new_stdev, new_height;
    if (can_fuse) {
      const float w1 = __fdiv_rn(1.0f, fmaxf(__fmul_rn(s0, s0), 1e-12f));
      const float w2 = __fdiv_rn(1.0f, fmaxf(var, 1e-12f));
      const float wsum = __fadd_rn(w1, w2);
      new_mean = __fdiv_rn(__fadd_rn(__fmul_rn(m0, w1), __fmul_rn(z, w2)),
                           wsum);
      new_stdev = sqrtf(__fdiv_rn(1.0f, wsum));
      new_height = h0;
    } else if (can_gap) {
      const float top = fmaxf(m0, z);
      const float bottom = fminf(__fsub_rn(m0, h0), z);
      new_mean = top;
      new_stdev = fminf(s0, sqrtf(var));
      new_height = __fsub_rn(top, bottom);
    } else {
      new_mean = z;
      new_stdev = sqrtf(var);
      new_height = 0.0f;
    }
    const int horizontal = (can_fuse || !can_gap) ? 1 : 0;
    const size_t at = base + slot;
    pool_mean[at] = new_mean;
    pool_stdev[at] = new_stdev;
    pool_height[at] = new_height;
    pool_meta[at] = 1 | (horizontal << 1) | (update_idx << 2);
    if (pool_color != nullptr) {
      pool_color[3 * at] = __fdiv_rn(cr, wsafe);
      pool_color[3 * at + 1] = __fdiv_rn(cg, wsafe);
      pool_color[3 * at + 2] = __fdiv_rn(cb, wsafe);
    }
  }
}

template <int K>
int launch(float* pool_mean, float* pool_stdev, float* pool_height,
           int* pool_meta, float* pool_color, const int* blk, const int* lx,
           const int* ly, const float* w, const float* wz,
           const float* point_color, int n, int p, int num_blocks, int nx,
           int ny, int update_idx, float patch_thickness, float gap_size,
           cudaStream_t stream) {
  int p_pad = 1;
  while (p_pad < p) p_pad <<= 1;
  const size_t smem = (size_t)p_pad * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        block_merge_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  block_merge_kernel<K><<<n, kThreads, smem, stream>>>(
      pool_mean, pool_stdev, pool_height, pool_meta, pool_color, blk, lx, ly,
      w, wz, point_color, p, p_pad, num_blocks, nx, ny, update_idx,
      patch_thickness, gap_size);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Pool fields are
// [num_blocks, nx, ny*k] (float32 mean/stdev/height, int32 meta) and, when
// pool_color is not null, [num_blocks, nx, ny*k*3] float32 colour with
// point_color [p, 3]; blk [n] int32; lx, ly [n, p] int32; w, wz [n, p]
// float32.  Updates the pool in place on `stream` and returns
// cudaGetLastError(); cudaErrorInvalidValue for a k other than 1, 2 or 4
// or for more than kMaxPoints points.
extern "C" int block_merge_launch(float* pool_mean, float* pool_stdev,
                                  float* pool_height, int* pool_meta,
                                  float* pool_color, const int* blk,
                                  const int* lx, const int* ly, const float* w,
                                  const float* wz, const float* point_color,
                                  int n, int p, int num_blocks, int nx, int ny,
                                  int k, int update_idx, float patch_thickness,
                                  float gap_size, void* stream) {
  if (n <= 0 || p <= 0) return (int)cudaSuccess;
  if (p > kMaxPoints) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(pool_mean, pool_stdev, pool_height, pool_meta, pool_color, blk, lx, ly, w, wz, point_color, n, p, num_blocks, nx, ny, update_idx, patch_thickness, gap_size, st);
    case 2: return launch<2>(pool_mean, pool_stdev, pool_height, pool_meta, pool_color, blk, lx, ly, w, wz, point_color, n, p, num_blocks, nx, ny, update_idx, patch_thickness, gap_size, st);
    case 4: return launch<4>(pool_mean, pool_stdev, pool_height, pool_meta, pool_color, blk, lx, ly, w, wz, point_color, n, p, num_blocks, nx, ny, update_idx, patch_thickness, gap_size, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
