// Row copy: the map pool's copy-on-write and rollover writes, moving only
// the block rows that a mask on the device selects.
//
// Replaces no TPU kernel.  The JAX package skips its pool-wide copy with
// lax.cond(any(mask)), which reads the mask on the host; the port reads
// nothing back inside a frame, so its plain torch copy wrote every
// particle's row, a row whose mask was off copying its block onto itself:
// O(N) blocks of traffic for the 0-3 % of rows that needed a copy.  This
// kernel reads the mask on the device and moves the masked rows alone, at
// a launch shape fixed by the pool, so a captured CUDA graph replays it
// unchanged whatever rows a frame selects.
//
// For every i with mask[i], in every field f of one launch:
//
//   field_f[dst[i]] <- field_f[src[i]]   (the copy form: src given)
//   field_f[dst[i]] <- fill_f[i]         (the fill form: src null; zeros
//                                        where field f has no fill)
//
// A field is a block image of num_blocks rows of row_bytes bytes each; the
// kernel moves bytes, so float32, bfloat16 and int32 fields, and the pool's
// [B, 2] origins, go through one launch.  The masked dst must be unique and
// none of them a masked row's src (copy-on-write copies into free blocks).
// A masked dst or src outside [0, num_blocks) traps, as an out-of-range
// index_copy_ asserts: the callers' allocation guarantees the range, and a
// fault there must not pass as a head that was never copied.
//
// What bounds it on an H100: bytes, 2 x masked rows x row bytes over
// 3.35 TB/s (a 10.24 MB float32 block of the reference's 20 m grid: ~6 us
// a row), plus a fixed cost for the launch and the reading of the mask.
// The design:
//
//   * A persistent grid, two CTAs of 256 threads per SM.  Every CTA reads
//     the mask in windows of 2,048 entries and compacts the window's
//     masked rows (their index, dst and src) into shared memory with a
//     block-wide prefix sum; a window with no masked row costs its mask
//     reads and nothing more.  No CTA is launched per row or per tile, so
//     rows whose mask is off cost no scheduling either.
//   * The grid's threads then stride together over the window's (masked
//     row x 16-byte unit) items of each field: 16-byte loads and stores
//     (8, 4 or 2 where a field's rows or pointers allow no more),
//     neighbouring threads on neighbouring addresses, four loads in flight
//     per thread before their stores.  A thread steps its (row, unit) pair
//     by the grid's stride with one division per field and window.
//   * Offsets are 64-bit throughout: the 100,000-particle pool's element
//     offsets pass 2^31, and a block's byte offset passes 2^32 sooner.
//
// The copy's source and destination lie in one image, so the pointers are
// not __restrict__; loads of a batch are issued before its stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWindow = 2048;                   // mask entries per window
constexpr int kPerThread = kWindow / kThreads;  // consecutive entries each
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFields = 8;
constexpr int kBatch = 4;  // loads in flight per thread
constexpr int kCtasPerSm = 2;

struct Fields {
  char* base[kMaxFields];        // the block image [num_blocks, row_bytes]
  const char* fill[kMaxFields];  // [n, row_bytes] values of the fill form,
                                 // or null: zeros
  unsigned long long row_bytes[kMaxFields];
  int unit[kMaxFields];          // bytes moved per item: 16, 8, 4 or 2
  int count;
};

template <int B> struct Unit;
template <> struct Unit<16> { using T = uint4; };
template <> struct Unit<8> { using T = uint2; };
template <> struct Unit<4> { using T = unsigned int; };
template <> struct Unit<2> { using T = unsigned short; };

// The window's m masked rows of one field: row q goes from row from[q] of
// `in` (the image itself, or the fill form's rows; null: zeros) to row
// dsts[q] of `base`.  Item j is unit j % units of row j / units, and a
// thread takes items tid, tid + stride, ...
template <int B>
__device__ __forceinline__ void copy_field(
    char* base, const char* in, unsigned long long row_bytes,
    const int* dsts, const int* from, int m, unsigned long long tid,
    unsigned long long stride) {
  using V = typename Unit<B>::T;
  const unsigned long long units = row_bytes / B;
  const unsigned long long items = (unsigned long long)m * units;
  if (tid >= items) return;
  unsigned long long q = tid / units, u = tid % units;
  const unsigned long long sq = stride / units, sr = stride % units;
  while (q < (unsigned long long)m) {
    V v[kBatch];
    V* out[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      out[b] = nullptr;
      if (q < (unsigned long long)m) {
        out[b] = reinterpret_cast<V*>(base + (unsigned long long)dsts[q] *
                                                 row_bytes) + u;
        v[b] = in == nullptr
                   ? V{}
                   : reinterpret_cast<const V*>(
                         in + (unsigned long long)from[q] * row_bytes)[u];
        q += sq;
        u += sr;
        if (u >= units) {
          u -= units;
          ++q;
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (out[b] != nullptr) *out[b] = v[b];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
row_copy_kernel(Fields fields, const int* dst, const int* src,
                const unsigned char* mask, int n, int num_blocks) {
  __shared__ int dsts[kWindow];
  __shared__ int from[kWindow];  // src[i] (copy form) or i (fill form)
  __shared__ int warp_sums[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned long long tid =
      (unsigned long long)blockIdx.x * blockDim.x + t;
  const unsigned long long stride =
      (unsigned long long)gridDim.x * blockDim.x;

  for (int w0 = 0; w0 < n; w0 += kWindow) {
    // this thread's kPerThread consecutive entries: which are on
    const int first = w0 + t * kPerThread;
    unsigned bits = 0;
    int mine = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = first + k;
      if (i < n && mask[i]) {
        const int d = dst[i];
        const int s = src == nullptr ? 0 : src[i];
        if (d < 0 || d >= num_blocks || s < 0 || s >= num_blocks) __trap();
        bits |= 1u << k;
        ++mine;
      }
    }
    // the block's exclusive prefix sum of `mine`
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int total = 0, before = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int s = warp_sums[w];
      before += w < warp ? s : 0;
      total += s;
    }
    int at = before + incl - mine;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (bits >> k & 1u) {
        const int i = first + k;
        dsts[at] = dst[i];
        from[at] = src == nullptr ? i : src[i];
        ++at;
      }
    }
    __syncthreads();
    if (total > 0) {  // uniform across the grid
#pragma unroll
      for (int f = 0; f < kMaxFields; ++f) {
        if (f < fields.count) {
          char* base = fields.base[f];
          const char* in = src != nullptr ? base : fields.fill[f];
          const unsigned long long rb = fields.row_bytes[f];
          switch (fields.unit[f]) {
            case 16:
              copy_field<16>(base, in, rb, dsts, from, total, tid, stride);
              break;
            case 8:
              copy_field<8>(base, in, rb, dsts, from, total, tid, stride);
              break;
            case 4:
              copy_field<4>(base, in, rb, dsts, from, total, tid, stride);
              break;
            default:
              copy_field<2>(base, in, rb, dsts, from, total, tid, stride);
              break;
          }
        }
      }
    }
    __syncthreads();  // the window's lists are read before the next's
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `base`, `fill` and
// `row_bytes` are host arrays of `count` (1..8) entries: each field's
// device pointer, its fill form's device pointer [n, row_bytes] or null
// (zeros), and its bytes per row, an even number.  dst, src [n] int32 and
// mask [n] bool on the device; src null means the fill form, given, the
// copy form (fill is then not read).
// Launches two CTAs per SM of the current device on `stream`, whatever the
// mask holds (none for n = 0), and returns cudaGetLastError();
// cudaErrorInvalidValue for arguments outside these.
extern "C" int row_copy_launch(void* const* base, const void* const* fill,
                               const unsigned long long* row_bytes, int count,
                               const int* dst, const int* src,
                               const unsigned char* mask, int n,
                               int num_blocks, void* stream) {
  if (count < 1 || count > kMaxFields || n < 0 || num_blocks < 0 ||
      dst == nullptr || mask == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  Fields fields;
  fields.count = count;
  for (int f = 0; f < kMaxFields; ++f) {
    fields.base[f] = nullptr;
    fields.fill[f] = nullptr;
    fields.row_bytes[f] = 0;
    fields.unit[f] = 2;
  }
  for (int f = 0; f < count; ++f) {
    if (base[f] == nullptr || row_bytes[f] == 0 || row_bytes[f] % 2) {
      return (int)cudaErrorInvalidValue;
    }
    int unit = 16;
    while (unit > 2 && (row_bytes[f] % unit || !aligned(base[f], unit) ||
                        (fill[f] != nullptr && !aligned(fill[f], unit)))) {
      unit /= 2;
    }
    if (!aligned(base[f], unit) ||
        (fill[f] != nullptr && !aligned(fill[f], unit))) {
      return (int)cudaErrorInvalidValue;
    }
    fields.base[f] = static_cast<char*>(base[f]);
    fields.fill[f] = static_cast<const char*>(fill[f]);
    fields.row_bytes[f] = row_bytes[f];
    fields.unit[f] = unit;
  }
  if (n == 0) return (int)cudaSuccess;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  row_copy_kernel<<<kCtasPerSm * sms, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      fields, dst, src, mask, n, num_blocks);
  return (int)cudaGetLastError();
}
