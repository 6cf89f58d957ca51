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
// cumulative weights the JAX package searches.  With levels l = 0, 1, ...
// (level 0 the input, level l + 1 the row totals of level l):
//
//   * a level of m <= 16 values is summed in sequence from +0.0 (for
//     m >= 2; one value is returned as it is);
//   * a level of m > 16 values, padded with zeros to rows of 16, is summed
//     in sequence inside each row (loc), its row totals form the next
//     level, whose scan is TOT_{l+1}, and TOT_l[16 r + j] = loc_l[r][j] +
//     carry_l[r], with carry_l[0] = +0.0 and carry_l[r] = TOT_{l+1}[r - 1].
//
// ops/ordered_scan.py::ordered_scan_reference repeats that order with
// elementwise adds on the CPU; IEEE addition (no contraction: there is no
// product) makes the two agree bit for bit.
//
// One launch at every size.  A CTA owns a tile of 4,096 elements: 256
// level-0 rows (a thread each), 16 level-1 rows, one level-2 row, one
// level-3 value.  It sums its rows up the three levels in shared memory
// and publishes three sums of its own: its total f (= its level-3 value),
// its level-2 partial p at position 14 and its last level-2 input e.  Tile
// c then needs TOT_3[c - 1] and TOT_3[c - 2], the scan of the tiles'
// totals, which it evaluates in the fixed order from the totals f_0 ..
// f_{c-1} its predecessors published (above 16 tiles rows of 16 and the
// recursion, in shared memory), and its carries are
//
//   level 2, its row:         TOT_3[c - 1]
//   level 1, its first row:   TOT_2[16 c - 1]  = f_{c-1} + TOT_3[c - 2]
//   level 0, its first row:   TOT_1[256 c - 1] = e_{c-1} + (p_{c-1} +
//                                                  TOT_3[c - 2])
//
// (TOT_3[-1] = +0.0), every later row's carry being the scanned value
// before it inside the tile.  A tile waits on its predecessors' totals
// only, never on their prefixes: all tiles publish before they look back,
// so the wait is one round trip.  The shortcut of scanning a tile alone
// and adding TOT_3[c - 1] is not this order (tests/test_torch_ordered_
// scan.py shows it differs).
//
// The state (ops/ordered_scan.py::device_state, int64 words, zeroed once):
// a word holding the launch's generation (high half) and its ticket count
// (low half), the number of records the last launch left tagged, and three
// words a tile, each a value in its low half and the tag of the launch that
// wrote it in its high half (the generation with its top bit set, so never
// 0).  One 64-bit store publishes a value with its tag and one 64-bit load
// reads both, so a reader that sees its launch's tag has the value: the
// word carries nothing else, and relaxed gpu-scope accesses suffice (with
// release/acquire, which order other memory too, the kernel took 1.3 us
// more at 100,000 elements on an H100).  A CTA takes its tile from the
// ticket, not from blockIdx.x, so it only ever waits on tiles whose CTAs
// already run.  The CTA that draws the last ticket resets the ticket count
// and steps the generation (every ticket is drawn by then), and clears the
// records an earlier, larger launch tagged that this one leaves unused:
// after each launch every record is zero or carries its tag, so no launch
// can take a record of an earlier one for its own, and none waits for the
// others to finish (a count of finished CTAs and a reset after it took 1.1
// us more).
// The next launch, or the next replay of a CUDA graph holding this one,
// starts clean.  Launches that share a state run one after another on one
// stream.
//
// What bounds it on an H100: the function must read the input once and
// write the output once, 8 bytes an element (0.8 MB at 100,000 particles:
// 0.24 us at 3.35 TB/s); at the path's sizes the launch, the ticket and the
// one look-back round trip take the time.  A thread loads its row of 16
// with four 16-byte loads into registers; the output goes back through
// shared memory (rows padded to 17 floats, so the threads' row writes do
// not collide on a bank) so that every store is coalesced: 16-byte stores
// at a row's stride leave sectors half written (1.4x the time at
// 2,100,000 elements), and staging the loads through shared memory as
// well cost 0.5 us more at 100,000.

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 16;                 // elements summed in sequence
constexpr int kPad = kRow + 1;           // shared-memory stride of a row
constexpr int kThreads = 256;            // level-0 rows of a tile
constexpr int kTile = kThreads * kRow;   // elements of a tile
constexpr int kMaxTiles = 32768;         // tiles the look-back holds
constexpr int kMaxLevels = 8;            // 32768 -> 2048 -> 128 -> 8
constexpr int kHeader = 2;               // state words: ticket, tagged
constexpr int kRecord = 3;               // state words a tile: f, p, e
constexpr unsigned kTagBit = 0x80000000u;

__device__ __forceinline__ void publish(unsigned long long* word, float v,
                                        unsigned tag) {
  const unsigned long long w =
      ((unsigned long long)tag << 32) | __float_as_uint(v);
  asm volatile("st.global.relaxed.gpu.b64 [%0], %1;"
               :: "l"(word), "l"(w) : "memory");
}

// A record not ready after kMaxSpins reads (seconds) means a fault in the
// state, not a slow predecessor: stop the launch with an error rather than
// spin on.
constexpr long long kMaxSpins = 1ll << 26;

__device__ __forceinline__ float await_value(const unsigned long long* word,
                                             unsigned tag) {
  unsigned long long w;
  long long spins = 0;
  do {
    asm volatile("ld.global.relaxed.gpu.b64 %0, [%1];"
                 : "=l"(w) : "l"(word) : "memory");
    if (++spins > kMaxSpins) __trap();
  } while ((unsigned)(w >> 32) != tag);
  return __uint_as_float(static_cast<unsigned>(w));
}

// Element k of the ordered scan of a level of m[0] values v[0] (+0.0 for
// k < 0), v[l] holding the row totals of level l - 1 that the prefix needs.
__device__ float level_prefix(float* const* v, const int* m, int k) {
  float loc[kMaxLevels];
  int used = 0;
  float top = 0.0f;
  for (int l = 0; k >= 0; ++l) {
    if (m[l] <= kRow) {
      float acc = 0.0f;
      for (int i = 0; i <= k; ++i) acc = acc + v[l][i];
      top = acc;
      break;
    }
    const float* row = v[l] + (k / kRow) * kRow;
    float acc = row[0];
    for (int i = 1; i <= k % kRow; ++i) acc = acc + row[i];
    loc[used++] = acc;
    k = k / kRow - 1;
  }
  while (used > 0) top = loc[--used] + top;
  return top;
}

__global__ void __launch_bounds__(kThreads)
    scan_tiles(const float* x, float* y, long long n, int tiles,
               unsigned long long* state) {
  // the predecessors' totals, then the row totals of the levels above
  extern __shared__ float look[];
  __shared__ float s[kThreads * kPad];   // y's rows, padded, for the stores
  __shared__ float s1[kRow * kPad];      // level 1, row-padded: loc_1
  __shared__ float s2[kRow];             // level 2: loc_2
  __shared__ float carry1[kRow];
  __shared__ float prev_p, prev_e, before, second;
  __shared__ int tile;
  __shared__ unsigned tag_of_launch;
  __shared__ long long tagged;
  const int tid = threadIdx.x;
  unsigned long long* rec = state + kHeader;

  int c = 0;
  unsigned tag = 0;
  if (tiles > 1) {
    if (tid == 0) {
      const unsigned long long w = atomicAdd(state, 1ull);
      const unsigned gen = (unsigned)(w >> 32);
      tile = (int)(unsigned)w;
      tag_of_launch = gen | kTagBit;
      if (tile == tiles - 1) {
        atomicExch(state, (unsigned long long)(gen + 1u) << 32);
        tagged = (long long)state[1];
      }
    }
    __syncthreads();
    c = tile;
    tag = tag_of_launch;
  }
  // up: the thread's row (zeros past n) in registers, then each level's
  // rows in sequence
  const long long base = (long long)c * kTile;
  const long long r0 = base + (long long)tid * kRow;
  float row[kRow];
  if (r0 + kRow <= n && (reinterpret_cast<size_t>(x) & 15) == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(x + r0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = p4[q];
      row[4 * q] = v.x;
      row[4 * q + 1] = v.y;
      row[4 * q + 2] = v.z;
      row[4 * q + 3] = v.w;
    }
  } else {  // the ragged row, or x not 16-byte aligned (a view)
#pragma unroll
    for (int j = 0; j < kRow; ++j) row[j] = r0 + j < n ? x[r0 + j] : 0.0f;
  }
  float acc = row[0];
#pragma unroll
  for (int j = 1; j < kRow; ++j) {
    acc = acc + row[j];
    row[j] = acc;
  }
  s1[(tid / kRow) * kPad + tid % kRow] = acc;
  __syncthreads();
  if (tid < kRow) {
    float* r1 = s1 + tid * kPad;
    float a1 = r1[0];
    for (int j = 1; j < kRow; ++j) {
      a1 = a1 + r1[j];
      r1[j] = a1;
    }
    s2[tid] = a1;
  }
  __syncthreads();
  if (tid == 0) {
    const float e = s2[kRow - 1];
    float a2 = s2[0];
    for (int j = 1; j < kRow; ++j) {
      a2 = a2 + s2[j];
      s2[j] = a2;
    }
    if (c + 1 < tiles) {
      unsigned long long* mine = rec + (long long)kRecord * c;
      publish(mine, a2, tag);
      publish(mine + 1, s2[kRow - 2], tag);
      publish(mine + 2, e, tag);
    }
  }
  // the look-back: TOT_3[c - 1] and TOT_3[c - 2] from f_0 .. f_{c-1}
  if (c > 0) {
    for (int i = tid; i < c; i += kThreads) {
      look[i] = await_value(rec + (long long)kRecord * i, tag);
    }
    if (tid == 0) {
      prev_p = await_value(rec + (long long)kRecord * (c - 1) + 1, tag);
      prev_e = await_value(rec + (long long)kRecord * (c - 1) + 2, tag);
    }
    __syncthreads();
    float* v[kMaxLevels];
    int m[kMaxLevels];
    v[0] = look;
    m[0] = tiles;
    float* next = look + c;
    int depth = 1, k = c - 1;
    while (m[depth - 1] > kRow && k >= kRow) {
      const int rows = k / kRow;
      const float* cur = v[depth - 1];
      for (int r = tid; r < rows; r += kThreads) {
        float a = cur[r * kRow];
        for (int j = 1; j < kRow; ++j) a = a + cur[r * kRow + j];
        next[r] = a;
      }
      __syncthreads();
      v[depth] = next;
      m[depth] = (m[depth - 1] + kRow - 1) / kRow;
      ++depth;
      next += rows;
      k = rows - 1;
    }
    if (tid == 0) before = level_prefix(v, m, c - 1);
    if (tid == 32) second = level_prefix(v, m, c - 2);
    __syncthreads();
  } else {
    __syncthreads();  // loc_2
  }
  // down: the carries of the tile's level-1 rows, then of its level-0 rows
  if (tid < kRow) {
    const float c2 = c == 0 ? 0.0f : before;
    const float c1 = c == 0 ? 0.0f : look[c - 1] + second;
    carry1[tid] = tid == 0 ? c1 : s2[tid - 1] + c2;
  }
  __syncthreads();
  float c0;
  if (tid == 0) {
    c0 = c == 0 ? (n == 1 ? -0.0f : 0.0f) : prev_e + (prev_p + second);
  } else {
    const int q = tid - 1;
    c0 = s1[(q / kRow) * kPad + q % kRow] + carry1[q / kRow];
  }
#pragma unroll
  for (int j = 0; j < kRow; ++j) row[j] = row[j] + c0;
#pragma unroll
  for (int j = 0; j < kRow; ++j) s[tid * kPad + j] = row[j];
  __syncthreads();
  // out through shared memory, so that every store is coalesced
  for (int k = 0; k < kRow; ++k) {
    const int idx = k * kThreads + tid;
    const long long g = base + idx;
    if (g < n) y[g] = s[(idx / kRow) * kPad + idx % kRow];
  }
  // the last ticket's CTA clears the records this launch leaves unused
  // (tiles - 1 publish), which no CTA of it reads
  if (c == tiles - 1 && c > 0) {
    const long long used = (long long)kRecord * c;
    for (long long i = used + tid; i < (long long)kRecord * tagged;
         i += kThreads) {
      rec[i] = 0;
    }
    if (tid == 0) state[1] = (unsigned long long)c;
  }
}

// Does nothing: one launch of it is the least any one-launch kernel costs
// (chip_smoke.py's launch_floor_ms).
__global__ void launch_floor_kernel() {}

}  // namespace

// Inclusive ordered scan of x [n] into y [n] (y may be x) on `stream`, one
// kernel launch.  `state`: ops/ordered_scan.py::state_words(n) int64 words,
// zero before the first launch, kept by the launches that share it.
extern "C" int ordered_scan_launch(const float* x, float* y, void* state,
                                   long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const long long t = (n + kTile - 1) / kTile;
  if (t > kMaxTiles) return (int)cudaErrorInvalidValue;
  const int tiles = (int)t;
  const size_t look =
      tiles > 1 ? sizeof(float) * (tiles + tiles / 15 + kMaxLevels) : 0;
  if (look > 24 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        scan_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)look);
    if (err != 0) return err;
  }
  scan_tiles<<<tiles, kThreads, look, static_cast<cudaStream_t>(stream)>>>(
      x, y, n, tiles, static_cast<unsigned long long*>(state));
  return (int)cudaGetLastError();
}

// One launch of an empty CTA of kThreads threads on `stream`.
extern "C" int ordered_scan_floor_launch(void* stream) {
  launch_floor_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
