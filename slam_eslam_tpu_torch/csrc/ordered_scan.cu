// Ordered scan: an inclusive float32 prefix sum whose additions happen in
// one fixed order, so that two calls on the same input give the same bits.
//
// Replaces no TPU kernel: it repairs the port.  The resampling search
// (core/filter.py::resample_from_positions) and the GMM's first draw
// (core/gmm.py::fit_gmm) searched a torch.cumsum of float weights, and on
// the card torch.cumsum of float32 is not repeatable (its order of
// additions depends on how the work is split at run time: two calls on the
// same 100,000 weights moved 54 ancestor indices, tools/profile_resample).
// On a device mesh every rank must find the same ancestors in the
// all-gathered weights, so the scan must give the same bits everywhere.
//
// The order is the one of the JAX package's cumsum on the CPU (XLA's
// rewrite of a prefix-sum reduce-window), so the port searches the very
// cumulative weights the JAX package searches:
//
//   * n <= 16: a sequential sum, y[i] = y[i - 1] + x[i];
//   * otherwise the input, padded with zeros to rows of 16, is summed in
//     sequence inside each row (loc); the row totals are scanned by this
//     same rule, recursively (tot); and y[16 r + j] = loc[r][j] + carry[r]
//     with carry[0] = 0 and carry[r] = tot[r - 1].
//
// ops/ordered_scan.py::ordered_scan_reference repeats that order with
// elementwise adds on the CPU; IEEE addition (no contraction: there is no
// product) makes the two agree bit for bit.
//
// What bounds it on an H100: bytes and launches.  The function must read
// the input once and write the output once, 8 bytes an element (0.8 MB at
// 100,000 particles: 0.24 us at 3.35 TB/s).  Above kSmall elements a call
// is three launches: row_totals reads x and writes its row totals (1/16 of
// it), the totals are scanned (recursively; by one CTA below kSmall), and
// add_carry reads x again, sums each row once more in the same order and
// writes y: 12 bytes an element, and no pass writes the local sums only to
// read them back.  Each CTA stages its 4,096 elements through shared
// memory (rows padded to 17 floats, so the threads' row walks do not
// collide on a bank) so that every global load and store is coalesced.  At
// the path's sizes the launches, not the bytes, take the time.

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 16;          // elements summed in sequence
constexpr int kPad = kRow + 1;    // shared-memory stride of a row
constexpr int kThreads = 256;     // rows per CTA of the large path
constexpr int kSmall = 8192;      // largest n scanned by one CTA
constexpr int kSmallThreads = kSmall / kRow;
constexpr int kMaxLevels = 4;     // 8192 -> 512 -> 32 -> 2

// Stage the CTA's kThreads rows of x (zeros past n) into s, row-padded.
__device__ __forceinline__ void stage(const float* x, float* s, long long n) {
  const long long base = (long long)blockIdx.x * kThreads * kRow;
  for (int k = 0; k < kRow; ++k) {
    const int idx = k * kThreads + threadIdx.x;
    const long long g = base + idx;
    s[(idx / kRow) * kPad + idx % kRow] = g < n ? x[g] : 0.0f;
  }
}

// totals[r] = the sequential sum of row r of x.
__global__ void __launch_bounds__(kThreads)
    row_totals(const float* x, float* totals, long long n, long long rows) {
  __shared__ float s[kThreads * kPad];
  stage(x, s, n);
  __syncthreads();
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  const float* row = s + threadIdx.x * kPad;
  float acc = row[0];
  for (int j = 1; j < kRow; ++j) acc = acc + row[j];
  if (r < rows) totals[r] = acc;
}

// y[16 r + j] = (sequential sum of x[16 r .. 16 r + j]) + carry[r], with
// carry[r] = tot[r - 1] (0 for r = 0).  y may be x: a CTA reads its
// elements before it writes them.
__global__ void __launch_bounds__(kThreads)
    add_carry(const float* x, const float* tot, float* y, long long n) {
  __shared__ float s[kThreads * kPad];
  stage(x, s, n);
  __syncthreads();
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  const float carry = (r == 0 || r * kRow >= n) ? 0.0f : tot[r - 1];
  float* row = s + threadIdx.x * kPad;
  float acc = row[0];
  row[0] = acc + carry;
  for (int j = 1; j < kRow; ++j) {
    acc = acc + row[j];
    row[j] = acc + carry;
  }
  __syncthreads();
  const long long base = (long long)blockIdx.x * kThreads * kRow;
  for (int k = 0; k < kRow; ++k) {
    const int idx = k * kThreads + threadIdx.x;
    const long long g = base + idx;
    if (g < n) y[g] = s[(idx / kRow) * kPad + idx % kRow];
  }
}

// The whole recursion for n <= kSmall in one CTA: every level in shared
// memory (level l holds ceil(n / 16^l) elements, padded with zeros to whole
// rows), rows summed up the levels, carries added down them.  y may be x.
__global__ void __launch_bounds__(kSmallThreads)
    scan_small(const float* x, float* y, int n) {
  // the levels of n = 8192, each rounded up to whole rows: 8192 + 512 + 32
  // + 16
  __shared__ float s[kSmall + kSmall / kRow + 3 * kRow];
  int start[kMaxLevels], len[kMaxLevels];
  int levels = 0, off = 0, m = n;
  while (true) {
    start[levels] = off;
    len[levels] = m;
    const int padded = (m + kRow - 1) / kRow * kRow;
    for (int i = threadIdx.x; i < padded; i += kSmallThreads) {
      s[off + i] = (levels == 0 && i < m) ? x[i] : 0.0f;
    }
    ++levels;
    if (m <= kRow) break;
    off += padded;
    m = (m + kRow - 1) / kRow;
  }
  __syncthreads();
  // up: each row summed in place, its total into the next level
  for (int l = 0; l + 1 < levels; ++l) {
    const int rows = len[l + 1];
    for (int r = threadIdx.x; r < rows; r += kSmallThreads) {
      float* row = s + start[l] + r * kRow;
      float acc = row[0];
      for (int j = 1; j < kRow; ++j) {
        acc = acc + row[j];
        row[j] = acc;
      }
      s[start[l + 1] + r] = acc;
    }
    __syncthreads();
  }
  // the last level (at most 16 elements) in sequence
  if (threadIdx.x == 0) {
    float* row = s + start[levels - 1];
    for (int j = 1; j < len[levels - 1]; ++j) row[j] = row[j - 1] + row[j];
  }
  __syncthreads();
  // down: each row of level l adds the scanned total of the row before it
  for (int l = levels - 2; l >= 0; --l) {
    const int rows = len[l + 1];
    for (int r = threadIdx.x; r < rows; r += kSmallThreads) {
      float* row = s + start[l] + r * kRow;
      const float carry = r == 0 ? 0.0f : s[start[l + 1] + r - 1];
      for (int j = 0; j < kRow; ++j) row[j] = row[j] + carry;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += kSmallThreads) y[i] = s[i];
}

int scan(const float* x, float* y, float* scratch, long long n,
         cudaStream_t st) {
  if (n <= kSmall) {
    scan_small<<<1, kSmallThreads, 0, st>>>(x, y, (int)n);
    return (int)cudaGetLastError();
  }
  const long long rows = (n + kRow - 1) / kRow;
  const unsigned ctas = (unsigned)((rows + kThreads - 1) / kThreads);
  float* tot = scratch;
  row_totals<<<ctas, kThreads, 0, st>>>(x, tot, n, rows);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = scan(tot, tot, scratch + rows, rows, st);
  if (err != 0) return err;
  add_carry<<<ctas, kThreads, 0, st>>>(x, tot, y, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Inclusive ordered scan of x [n] into y [n] on `stream`.  `scratch` holds
// the row totals of every level above kSmall elements:
// ops/ordered_scan.py::scratch_size(n) floats.
extern "C" int ordered_scan_launch(const float* x, float* y, float* scratch,
                                   long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  return scan(x, y, scratch, n, static_cast<cudaStream_t>(stream));
}
