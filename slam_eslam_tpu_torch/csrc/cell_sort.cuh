// One particle's points sorted by the cell they hit, in shared memory:
// the order in which the block merge (block_merge.cu) and its twin with
// the body taken out (block_copy.cu, cells mode) visit a block.
//
// A key is cell << 32 | point for a point whose block-local cell (lx, ly)
// is in range, kEmpty otherwise; after the sort equal cells are adjacent,
// in point order, and the first entry of each run owns the cell.  Besides
// deduplicating, the sort makes neighbouring threads visit neighbouring
// cells, which is what keeps the scattered loads of a block cheap (the
// same cells visited in point order take longer, see PERF.md).
//
// The sort is bitonic, O(P log^2 P) compares in shared memory, so a
// camera cloud of thousands of points stays cheap; P is bounded by the
// shared memory of one CTA (kMaxPoints keys of 8 bytes).

#pragma once

#include <cuda_runtime.h>

namespace cell_sort {

constexpr int kMaxPoints = 16384;  // 128 KB of sort keys
constexpr unsigned long long kEmpty = ~0ull;

// The smallest power of two >= p: the number of keys that are sorted.
inline int padded(int p) {
  int p_pad = 1;
  while (p_pad < p) p_pad <<= 1;
  return p_pad;
}

__device__ __forceinline__ unsigned cell_of(unsigned long long key) {
  return (unsigned)(key >> 32);
}

__device__ __forceinline__ unsigned point_of(unsigned long long key) {
  return (unsigned)(key & 0xffffffffu);
}

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

// Fill keys[0, p_pad) from the particle's point row (lx, ly [p] at `row`)
// and sort them; every thread of the CTA must call it.
__device__ __forceinline__ void sorted_keys(unsigned long long* keys,
                                            const int* __restrict__ lx,
                                            const int* __restrict__ ly,
                                            size_t row, int p, int p_pad,
                                            int nx, int ny) {
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
}

// Does entry j (< p) start a run of equal cells?
__device__ __forceinline__ bool owns_cell(const unsigned long long* keys,
                                          int j) {
  const unsigned long long key = keys[j];
  if (key == kEmpty) return false;
  return j == 0 || cell_of(keys[j - 1]) != cell_of(key);
}

}  // namespace cell_sort
