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
//      meta = 1 | horizontal << 1 | update_idx << 2 (update_idx read from a
//      device int32, so a launch captured into a CUDA graph stamps the
//      value the scalar holds at each replay), and, when the pool
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
// of (cell << 32 | point) keys in shared memory (cell_sort.cuh): O(P
// log^2 P) work, so a camera cloud of thousands of points stays cheap; P
// is bounded by the shared memory of one CTA (kMaxPoints keys of 8 bytes;
// the launcher refuses more; a larger cloud shared by every particle takes
// cloud_merge.cu).  The first
// entry of each run of equal cells then owns that cell: it sums the run's
// points in point-index order (deterministic, no atomics on values, the
// order of the plain version's stable sort), reads the cell's K slots,
// applies the rules, and writes one slot back.
//
// The float fields (mean, stdev, height, colour) are stored as float32 or
// as bfloat16 (the kernel is templated on the storage type S): slots are
// read up to float32 exactly, the sums and the slot rules run in float32
// as below, and the written slot is rounded once, to nearest even, at the
// store, as the plain version's `.to(dtype)` does.
//
// Layout: the kernel addresses a field as base + b * block_stride + (cell
// * K + slot), with the stride between blocks (in elements) a parameter.
// A pool of four separate tensors [B, nx, ny*K] has block_stride = nx*ny*K.
// The packed block image of tools/probe_merge_overhead.py::merge_packed
// (its _merge_packed_kernel: the same _merge_body on one float32 tensor
// [B, 4*nx, ny*K], rows [0, nx) mean, [nx, 2nx) stdev, [2nx, 3nx) height,
// [3nx, 4nx) meta as int32 bits) is the same kernel with the four bases
// nx*ny*K elements apart and block_stride = 4*nx*ny*K
// (block_merge_packed_launch): a block's four fields then lie within 100 KB
// of each other instead of a whole field tensor apart.  The TPU kernel
// loads the whole image and concatenates the four results back; here the
// owner thread still moves only its cell's rows.  The meta rows are read
// and written as int32 words and never pass through float arithmetic.
//
// Arithmetic follows the plain version op for op: the fusion formula is
// written with __fmul_rn / __fadd_rn / __fdiv_rn so that nvcc does not
// contract it into FMAs, and 1/x and sqrtf are IEEE (no --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cell_sort.cuh"
#include "slot_select.cuh"

namespace {

using cell_sort::kEmpty;
using cell_sort::kMaxPoints;

constexpr int kThreads = 128;

template <int K, typename S>
__global__ void __launch_bounds__(kThreads)
block_merge_kernel(S* __restrict__ pool_mean, S* __restrict__ pool_stdev,
                   S* __restrict__ pool_height, int* __restrict__ pool_meta,
                   S* __restrict__ pool_color,
                   const int* __restrict__ blk, const int* __restrict__ lx,
                   const int* __restrict__ ly, const float* __restrict__ w,
                   const float* __restrict__ wz,
                   const float* __restrict__ point_color, int p, int p_pad,
                   int num_blocks, size_t block_stride, int nx, int ny,
                   const int* __restrict__ update_idx,
                   float patch_thickness, float gap_size) {
  extern __shared__ unsigned long long keys[];
  const int n = blockIdx.x;
  const int b = __ldg(blk + n);
  if (b < 0 || b >= num_blocks) return;  // uniform across the CTA
  const size_t row = (size_t)n * p;

  cell_sort::sorted_keys(keys, lx, ly, row, p, p_pad, nx, ny);

  for (int j = threadIdx.x; j < p; j += blockDim.x) {
    if (!cell_sort::owns_cell(keys, j)) continue;
    const unsigned cell = cell_sort::cell_of(keys[j]);

    // this thread owns the cell: sums over its run, in point order
    float ws = 0.0f, wzs = 0.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
    for (int r = j; r < p; ++r) {
      const unsigned long long kr = keys[r];
      if (kr == kEmpty || cell_sort::cell_of(kr) != cell) break;
      const unsigned q = cell_sort::point_of(kr);
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
    const size_t base =
        (size_t)b * block_stride + ((size_t)ix * ny + iy) * K;
    float m[K], s[K], h[K];
    int meta[K];
    slot_select::load_values<K>(pool_mean + base, m);
    slot_select::load_values<K>(pool_stdev + base, s);
    slot_select::load_values<K>(pool_height + base, h);
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
    slot_select::store_value(pool_mean + at, new_mean);
    slot_select::store_value(pool_stdev + at, new_stdev);
    slot_select::store_value(pool_height + at, new_height);
    pool_meta[at] = 1 | (horizontal << 1) | (__ldg(update_idx) << 2);
    if (pool_color != nullptr) {
      slot_select::store_value(pool_color + 3 * at, __fdiv_rn(cr, wsafe));
      slot_select::store_value(pool_color + 3 * at + 1, __fdiv_rn(cg, wsafe));
      slot_select::store_value(pool_color + 3 * at + 2, __fdiv_rn(cb, wsafe));
    }
  }
}

// One call's operands; the field pointers are typed by the launcher.
struct Operands {
  void* mean;
  void* stdev;
  void* height;
  int* meta;
  void* color;  // needs block_stride == nx * ny * k (colour has 3 per slot)
  const int* blk;
  const int* lx;
  const int* ly;
  const float* w;
  const float* wz;
  const float* point_color;
  int n, p, num_blocks;
  size_t block_stride;  // elements between a field's successive blocks
  int nx, ny;
  const int* update_idx;  // [] int32 on the device
  float patch_thickness, gap_size;
};

template <int K, typename S>
int launch(const Operands& a, cudaStream_t stream) {
  const int p_pad = cell_sort::padded(a.p);
  const size_t smem = (size_t)p_pad * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        block_merge_kernel<K, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  block_merge_kernel<K, S><<<a.n, kThreads, smem, stream>>>(
      static_cast<S*>(a.mean), static_cast<S*>(a.stdev),
      static_cast<S*>(a.height), a.meta, static_cast<S*>(a.color), a.blk,
      a.lx, a.ly, a.w, a.wz, a.point_color, a.p, p_pad, a.num_blocks,
      a.block_stride, a.nx, a.ny, a.update_idx, a.patch_thickness,
      a.gap_size);
  return (int)cudaGetLastError();
}

template <typename S>
int dispatch(const Operands& a, int k, void* stream) {
  if (a.n <= 0 || a.p <= 0) return (int)cudaSuccess;
  if (a.p > kMaxPoints) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1, S>(a, st);
    case 2: return launch<2, S>(a, st);
    case 4: return launch<4, S>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Both update the pool in place
// on `stream` and return cudaGetLastError(); cudaErrorInvalidValue for a k
// other than 1, 2 or 4 or for more than kMaxPoints points.  blk [n] int32;
// lx, ly [n, p] int32; w, wz [n, p] float32; update_idx [] int32.

// Pool fields are [num_blocks, nx, ny*k] (mean/stdev/height float32, or
// bfloat16 when `bf16` is not 0; int32 meta) and, when pool_color is not
// null, [num_blocks, nx, ny*k*3] colour of the same storage type with
// point_color [p, 3] float32.
extern "C" int block_merge_launch(void* pool_mean, void* pool_stdev,
                                  void* pool_height, int* pool_meta,
                                  void* pool_color, const int* blk,
                                  const int* lx, const int* ly, const float* w,
                                  const float* wz, const float* point_color,
                                  int n, int p, int num_blocks, int nx, int ny,
                                  int k, int bf16, const int* update_idx,
                                  float patch_thickness, float gap_size,
                                  void* stream) {
  const Operands a = {pool_mean, pool_stdev, pool_height, pool_meta,
                      pool_color, blk, lx, ly, w, wz, point_color, n, p,
                      num_blocks, (size_t)nx * ny * k, nx, ny, update_idx,
                      patch_thickness, gap_size};
  return bf16 ? dispatch<__nv_bfloat16>(a, k, stream)
              : dispatch<float>(a, k, stream);
}

// The packed block image: `packed` is float32 [num_blocks, 4*nx, ny*k] with
// a block's mean, stdev, height and meta (int32 bits) in successive groups
// of nx rows.  No colour, float32 only.
extern "C" int block_merge_packed_launch(float* packed, const int* blk,
                                         const int* lx, const int* ly,
                                         const float* w, const float* wz,
                                         int n, int p, int num_blocks, int nx,
                                         int ny, int k,
                                         const int* update_idx,
                                         float patch_thickness, float gap_size,
                                         void* stream) {
  const size_t field = (size_t)nx * ny * k;
  const Operands a = {packed, packed + field, packed + 2 * field,
                      reinterpret_cast<int*>(packed + 3 * field), nullptr,
                      blk, lx, ly, w, wz, nullptr, n, p, num_blocks,
                      4 * field, nx, ny, update_idx, patch_thickness,
                      gap_size};
  return dispatch<float>(a, k, stream);
}
