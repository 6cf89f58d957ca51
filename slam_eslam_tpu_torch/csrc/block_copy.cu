// Block copy: the block merge with its body taken out -- the traffic floor
// that the merge kernel's time is held against.
//
// Replaces the TPU kernel slam_eslam_tpu/utils/kernel_eff.py::
// _copy_all_kernel (in merge_floor_fraction), "the same grid spec, block
// indexing, aliasing and operands with a passthrough body", and with it the
// probe variants of tools/probe_merge_overhead.py that share that body:
// copy_all (the same kernel), copy_fields (no point operands) and
// copy_packed (one packed field image per block).
//
// The launch is the block merge's (csrc/block_merge.cu): one CTA of 128
// threads per particle n, working on block blk[n] of every field; a
// blk[n] outside [0, num_blocks) is skipped.  Each field is a block image
// [num_blocks, rows, cols] of 4-byte (float32, int32) or 2-byte (bfloat16)
// elements, given as an input and an output pointer.  They may be equal
// (in place, the aliasing of the TPU kernel) or two pools.  Three modes:
//
//   whole  what the TPU kernel computes: every element of block blk[n] of
//          every field is read and written to the same place in the output
//          and the particle's point rows lx, ly, w, wz [P] are read.  On the
//          TPU the merge streams whole blocks, so this is its floor there;
//          here it measures the card's achieved block-copy bandwidth.
//   cells  the merge of THIS card with its body taken out: the merge reads
//          and writes only the slot rows of the cells its points hit, so
//          the twin visits the hit cells in the merge's order (its sort
//          of the points by cell, cell_sort.cuh: one visit per distinct
//          cell, neighbouring threads on neighbouring cells), reads the
//          w and wz of the cell's points and the cell's row (K slots of
//          every field) and writes the row back unchanged: no sums, no
//          slot rules.  The sort stays because it is what makes this
//          traffic cheap: the same rows visited in point order took 1.07
//          to 1.15 times the whole merge (PERF.md).
//   points the same rows with no sort either: every in-range point's cell
//          row is read and written back in point order, a cell once per
//          point that hits it.  Beside cells mode it tells what the sort
//          costs and saves; nothing is held against it.
//
// What bounds it on an H100: bytes.  In whole mode at the merge benchmark
// shape (N = 4096 particles, blocks of 40 x 128 float32, three float fields
// and meta) a call moves 8 block images of 20,480 B per particle, 671 MB,
// which the card's 3.35 TB/s cannot move in under 0.2 ms.  The design is
// therefore plain: 16-byte loads and stores, neighbouring threads on
// neighbouring addresses, the block walked by the CTA in strides, a few
// loads in flight per thread.
//
// A copy of a block onto itself is dead code to a compiler that can prove
// input and output equal, so the two are separate pointers and neither is
// __restrict__; the point operands are kept alive with an empty asm that
// takes each value as an input.  blk must be unique when input and output
// differ per block, as for the merge; several points of one particle may
// hit one cell, and then all write the bytes they read.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cell_sort.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxFields = 4;

struct Fields {
  const char* in[kMaxFields];
  char* out[kMaxFields];
  int elem[kMaxFields];  // bytes per element: 4 or 2
  int count;
};

__device__ __forceinline__ void keep(int v) { asm volatile("" ::"r"(v)); }
__device__ __forceinline__ void keep(float v) { asm volatile("" ::"f"(v)); }

// Input and output may alias, so the compiler keeps every load behind the
// store before it.  Both kernels therefore load a batch into registers
// first and store it afterwards: the loads of a batch are independent
// and overlap, as the merge's loads of a cell's four fields do.

constexpr int kBatch = 4;  // loads in flight per thread and field

// Copy `bytes` bytes from src to dst in units of V, the CTA's threads
// striding over them, kBatch units per thread in flight (bytes is a
// multiple of sizeof(V), both pointers are aligned to it).
template <typename V>
__device__ __forceinline__ void copy_strided(char* dst, const char* src,
                                             size_t bytes) {
  const V* s = reinterpret_cast<const V*>(src);
  V* d = reinterpret_cast<V*>(dst);
  const size_t count = bytes / sizeof(V);
  for (size_t i = threadIdx.x; i < count; i += (size_t)kBatch * blockDim.x) {
    V v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const size_t at = i + (size_t)u * blockDim.x;
      if (at < count) v[u] = s[at];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const size_t at = i + (size_t)u * blockDim.x;
      if (at < count) d[at] = v[u];
    }
  }
}

// One unit of `bytes` bytes (16, 8, 4 or 2; aligned to its size) into a
// register quad, and back out.
__device__ __forceinline__ uint4 load_unit(const char* src, int bytes) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  switch (bytes) {
    case 16: v = *reinterpret_cast<const uint4*>(src); break;
    case 8: {
      const uint2 t = *reinterpret_cast<const uint2*>(src);
      v.x = t.x;
      v.y = t.y;
      break;
    }
    case 4: v.x = *reinterpret_cast<const unsigned int*>(src); break;
    default: v.x = *reinterpret_cast<const unsigned short*>(src); break;
  }
  return v;
}

__device__ __forceinline__ void store_unit(char* dst, uint4 v, int bytes) {
  switch (bytes) {
    case 16: *reinterpret_cast<uint4*>(dst) = v; break;
    case 8: *reinterpret_cast<uint2*>(dst) = make_uint2(v.x, v.y); break;
    case 4: *reinterpret_cast<unsigned int*>(dst) = v.x; break;
    default: *reinterpret_cast<unsigned short*>(dst) =
                 (unsigned short)v.x; break;
  }
}

// V: the unit of the whole-block copy (uint4, unsigned int or unsigned
// short), chosen by the launcher from the block size and the pointers'
// alignment.  The loop over the fields is unrolled to its compile-time
// bound, so `fields` is indexed by constants and stays in the kernel's
// parameter space.
template <typename V>
__global__ void __launch_bounds__(kThreads)
block_copy_whole_kernel(Fields fields, const int* blk, const int* lx,
                        const int* ly, const float* w, const float* wz, int p,
                        int num_blocks, int rows, int cols) {
  const int n = blockIdx.x;
  const int b = blk[n];
  if (b < 0 || b >= num_blocks) return;  // uniform across the CTA
  const size_t cells = (size_t)rows * cols;
#pragma unroll
  for (int f = 0; f < kMaxFields; ++f) {
    if (f < fields.count) {
      const size_t bytes = cells * fields.elem[f];
      const size_t at = (size_t)b * bytes;
      copy_strided<V>(fields.out[f] + at, fields.in[f] + at, bytes);
    }
  }
  if (lx != nullptr) {
    const size_t row = (size_t)n * p;
    for (int j = threadIdx.x; j < p; j += blockDim.x) {
      keep(lx[row + j]);
      keep(ly[row + j]);
      keep(w[row + j]);
      keep(wz[row + j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
block_copy_cells_kernel(Fields fields, const int* blk, const int* lx,
                        const int* ly, const float* w, const float* wz, int p,
                        int p_pad, int num_blocks, int nx, int ny, int k) {
  extern __shared__ unsigned long long keys[];
  const int n = blockIdx.x;
  const int b = blk[n];
  if (b < 0 || b >= num_blocks) return;  // uniform across the CTA
  const size_t row = (size_t)n * p;
  cell_sort::sorted_keys(keys, lx, ly, row, p, p_pad, nx, ny);

  for (int j = threadIdx.x; j < p; j += blockDim.x) {
    if (!cell_sort::owns_cell(keys, j)) continue;
    const unsigned local = cell_sort::cell_of(keys[j]);
    // this thread owns the cell: the point operands of its run
    for (int r = j; r < p; ++r) {
      const unsigned long long kr = keys[r];
      if (kr == cell_sort::kEmpty || cell_sort::cell_of(kr) != local) break;
      keep(w[row + cell_sort::point_of(kr)]);
      keep(wz[row + cell_sort::point_of(kr)]);
    }
    const size_t cell = ((size_t)b * nx * ny + local) * k;
    uint4 v[kMaxFields];
#pragma unroll
    for (int f = 0; f < kMaxFields; ++f) {
      if (f < fields.count) {
        v[f] = load_unit(fields.in[f] + cell * fields.elem[f],
                         k * fields.elem[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kMaxFields; ++f) {
      if (f < fields.count) {
        store_unit(fields.out[f] + cell * fields.elem[f], v[f],
                   k * fields.elem[f]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
block_copy_points_kernel(Fields fields, const int* blk, const int* lx,
                         const int* ly, const float* w, const float* wz, int p,
                         int num_blocks, int nx, int ny, int k) {
  const int n = blockIdx.x;
  const int b = blk[n];
  if (b < 0 || b >= num_blocks) return;  // uniform across the CTA
  const size_t row = (size_t)n * p;
  for (int j = threadIdx.x; j < p; j += blockDim.x) {
    const int x = lx[row + j];
    const int y = ly[row + j];
    if (x < 0 || x >= nx || y < 0 || y >= ny) continue;
    keep(w[row + j]);
    keep(wz[row + j]);
    const size_t cell = (((size_t)b * nx + x) * ny + y) * k;
    uint4 v[kMaxFields];
#pragma unroll
    for (int f = 0; f < kMaxFields; ++f) {
      if (f < fields.count) {
        v[f] = load_unit(fields.in[f] + cell * fields.elem[f],
                         k * fields.elem[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kMaxFields; ++f) {
      if (f < fields.count) {
        store_unit(fields.out[f] + cell * fields.elem[f], v[f],
                   k * fields.elem[f]);
      }
    }
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `in`, `out` and `elem` are
// host arrays of `count` (1..4) device pointers and element sizes (4 or 2
// bytes); every field is [num_blocks, rows, cols] elements.  blk [n] int32;
// lx, ly [n, p] int32 and w, wz [n, p] float32, or all four null in whole
// mode (no point operands).  mode 0 = whole, 1 = cells, 2 = points (for
// both cols = ny*k, k is 1, 2 or 4 and the points are required; in cells
// mode p is at most cell_sort::kMaxPoints).  Launches on `stream` and
// returns cudaGetLastError(); cudaErrorInvalidValue for arguments outside
// these.
extern "C" int block_copy_launch(const void* const* in, void* const* out,
                                 const int* elem, int count, const int* blk,
                                 const int* lx, const int* ly, const float* w,
                                 const float* wz, int n, int p, int num_blocks,
                                 int rows, int cols, int k, int mode,
                                 void* stream) {
  if (count < 1 || count > kMaxFields) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  Fields fields;
  fields.count = count;
  const size_t cells = (size_t)rows * cols;
  int vec = 16;
  for (int f = 0; f < count; ++f) {
    if (elem[f] != 4 && elem[f] != 2) return (int)cudaErrorInvalidValue;
    fields.in[f] = static_cast<const char*>(in[f]);
    fields.out[f] = static_cast<char*>(out[f]);
    fields.elem[f] = elem[f];
    const size_t bytes = cells * elem[f];
    while (vec > 2 && (bytes % vec || !aligned(in[f], vec) ||
                       !aligned(out[f], vec))) {
      vec = vec == 16 ? 4 : 2;
    }
  }
  for (int f = count; f < kMaxFields; ++f) {
    fields.in[f] = nullptr;
    fields.out[f] = nullptr;
    fields.elem[f] = 0;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    const bool points = lx != nullptr;
    if (points && (ly == nullptr || w == nullptr || wz == nullptr)) {
      return (int)cudaErrorInvalidValue;
    }
    const int pp = points ? p : 0;
    if (vec == 16) {
      block_copy_whole_kernel<uint4><<<n, kThreads, 0, st>>>(
          fields, blk, lx, ly, w, wz, pp, num_blocks, rows, cols);
    } else if (vec == 4) {
      block_copy_whole_kernel<unsigned int><<<n, kThreads, 0, st>>>(
          fields, blk, lx, ly, w, wz, pp, num_blocks, rows, cols);
    } else {
      block_copy_whole_kernel<unsigned short><<<n, kThreads, 0, st>>>(
          fields, blk, lx, ly, w, wz, pp, num_blocks, rows, cols);
    }
  } else if (mode == 1 || mode == 2) {
    if (lx == nullptr || ly == nullptr || w == nullptr || wz == nullptr ||
        p <= 0 || (mode == 1 && p > cell_sort::kMaxPoints) ||
        (k != 1 && k != 2 && k != 4) || cols % k) {
      return (int)cudaErrorInvalidValue;
    }
    for (int f = 0; f < count; ++f) {
      const int unit = k * elem[f];
      if (!aligned(in[f], unit) || !aligned(out[f], unit)) {
        return (int)cudaErrorInvalidValue;
      }
    }
    if (mode == 2) {
      block_copy_points_kernel<<<n, kThreads, 0, st>>>(
          fields, blk, lx, ly, w, wz, p, num_blocks, rows, cols / k, k);
      return (int)cudaGetLastError();
    }
    const int p_pad = cell_sort::padded(p);
    const size_t smem = (size_t)p_pad * sizeof(unsigned long long);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          block_copy_cells_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    block_copy_cells_kernel<<<n, kThreads, smem, st>>>(
        fields, blk, lx, ly, w, wz, p, p_pad, num_blocks, rows, cols / k, k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
