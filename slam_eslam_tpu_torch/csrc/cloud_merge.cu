// Cloud merge: fuse one shared point cloud, placed by every particle's pose,
// into that particle's active map block, in place -- the block merge K3
// (block_merge.cu) for clouds of any size, with its operands computed here.
//
// K3 takes per-particle operand rows [N, P] (cell x, cell y, weight and
// weighted height) and sorts one particle's points in one CTA's shared
// memory, so a cloud stops at kMaxPoints = 16,384 points.  A 640 x 480
// distance image is 307,200 points, and its operand rows at 1,000
// particles would be ~11 GB.  This kernel takes the shared cloud [P] once
// (xy, z, stdev, valid, colour) and the poses [N], and places each point
// in registers, as map_pool.merge_operands does, op for op:
//   wx = (c * px - s * py) + x,  wy = (s * px + c * py) + y,
//   ix = floor((wx - ox) * inv_res),  iy = floor((wy - oy) * inv_res),
//   w = 1 / max(stdev^2 + z_sigma^2, 1e-12),  wz = w * (z + z_offset),
// with c, s the cosine and sine of the particle's yaw as the caller's
// torch.cos / torch.sin give them.  The result is K3's: per touched cell
// the sums of w, wz (and w * colour) over all of the cloud's points in the
// cell, added in point order, then the envire slot rules once, stamped
// with update_idx (see block_merge.cu).  Since the sums run in the same
// order with the same roundings, the merge equals K3's bit for bit on a
// cloud both take, and the plain version's (block_merge_reference on the
// same operands) as K3 does.
//
// Design: one warp per particle (a CTA of 32 threads), so that no point
// is placed twice and no barrier orders warps.  The warp keeps the sums of
// a window of its block's cells in shared memory: the cells that the
// cloud's bounding box (bounds, in the cloud's frame) can reach under the
// particle's pose, one cell of margin on each side, clipped to the block.
// A window larger than kAccBytes of sums is taken in tiles, one pass over
// the cloud each.  The cloud passes through 32 points at a time, one a
// lane: the lane places its point and stages w, wz and w * colour in
// shared memory; __match_any_sync groups the lanes whose points share a
// cell, and each group's lowest lane (its leader) adds, to the cell's
// sums, its own values and then its members' in lane order, reading them
// from the stage.  Every point of a cell is so added by one thread, in
// chunk order and lane order, that is in point order: no atomics on
// values, and the result repeats bit for bit from run to run and in a CUDA
// graph.  The members are walked in steps that every lane takes alike
// (each leader adding its own members and +0 for the rest, four lanes'
// values loaded at once), so that no lane waits on another's branch, and
// a lane loads its next point while it merges the current one.  After the
// cloud, the lanes take cells of the tile and, where the sum of w is
// positive, apply the slot rules and write one slot back.
//
// Where the time goes (1,000 particles, a 640 x 480 image; PERF.md): the
// loads of the cloud, which every warp reads whole from L2, about a
// quarter; placing the points, a fifth; the leaders' chains, about half.
//
// Offsets into the pool are 64-bit: the colour field of a 4,000-block pool
// of 400 x 400 cells x 4 slots holds 7.68e9 elements.
//
// Counters (when `counters` is not null, for the tracer): [0] += the
// valid (particle, point) placements that fall in the block, [1] += the
// cells written; integer atomics, once per CTA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "slot_select.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kAccBytes = 35 * 1024;  // the window's sums, a warp

struct Operands {
  void* mean;
  void* stdev;
  void* height;
  int* meta;
  void* color;              // [num_blocks, nx, ny*K*3] or null
  const float* origin;      // [num_blocks, 2]: world xy of cell (0, 0)
  const int* blk;           // [n] active block (skip < 0 or >= num_blocks)
  const float* px;          // [n] pose x
  const float* py;          // [n] pose y
  const float* pc;          // [n] cos yaw
  const float* ps;          // [n] sin yaw
  const float* pz;          // [n] z offset
  const float* pzsd;        // [n] its standard deviation
  const float* cxy;         // [p, 2] cloud xy
  const float* cz;          // [p]
  const float* csd;         // [p]
  const unsigned char* cvalid;  // [p] bool
  const float* ccolor;      // [p, 3] or null
  const float* bounds;      // [4]: min x, max x, min y, max y of the valid
  unsigned long long* counters;  // [2] or null
  const int* update_idx;    // [] int32
  int n, p, num_blocks, nx, ny;
  float inv_res, patch_thickness, gap_size;
};

// The envire slot rules for one cell's fused measurement (W, WZ, colour
// sums), written into the cell's K slots at `base`: block_merge.cu's, op
// for op.
template <int K, typename S>
__device__ __forceinline__ void fuse_cell(const Operands& a, size_t base,
                                          float ws, float wzs, float cr,
                                          float cg, float cb) {
  S* pool_mean = static_cast<S*>(a.mean);
  S* pool_stdev = static_cast<S*>(a.stdev);
  S* pool_height = static_cast<S*>(a.height);
  S* pool_color = static_cast<S*>(a.color);
  const float wsafe = fmaxf(ws, 1e-30f);
  const float z = __fdiv_rn(wzs, wsafe);
  const float var = __fdiv_rn(1.0f, wsafe);
  float m[K], s[K], h[K];
  int meta[K];
  slot_select::load_values<K>(pool_mean + base, m);
  slot_select::load_values<K>(pool_stdev + base, s);
  slot_select::load_values<K>(pool_height + base, h);
  slot_select::load_slots<K>(a.meta + base, meta);

  int fslot = -1, gslot = -1, free_slot = -1, eslot = 0;
  float fbest = INFINITY, gbest = INFINITY, ebest = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool valid = (meta[k] & 1) != 0;
    const bool horiz = (meta[k] & 2) != 0;
    const float d = fabsf(m[k] - z);
    if (valid && horiz && d <= a.patch_thickness && d < fbest) {
      fslot = k;
      fbest = d;
    }
    if (valid && d <= a.gap_size && d < gbest) {
      gslot = k;
      gbest = d;
    }
    if (!valid && free_slot < 0) free_slot = k;
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
  a.meta[at] = 1 | (horizontal << 1) | (__ldg(a.update_idx) << 2);
  if (pool_color != nullptr) {
    slot_select::store_value(pool_color + 3 * at, __fdiv_rn(cr, wsafe));
    slot_select::store_value(pool_color + 3 * at + 1, __fdiv_rn(cg, wsafe));
    slot_select::store_value(pool_color + 3 * at + 2, __fdiv_rn(cb, wsafe));
  }
}

// The cell range [lo, hi] along one axis that values in [fmin, fmax]
// (cells, unfloored) reach, one cell of margin each side, clipped to
// [0, extent); lo > hi when none.
__device__ __forceinline__ void cell_range(float fmin, float fmax, int extent,
                                           int& lo, int& hi) {
  const float top = (float)extent + 2.0f;
  lo = max(0, (int)floorf(fminf(fmaxf(fmin, -2.0f), top)) - 1);
  hi = min(extent - 1, (int)floorf(fminf(fmaxf(fmax, -2.0f), top)) + 1);
}

// One point of the cloud as a lane loads it (ok: in range and valid).
struct Point {
  bool ok;
  float qx, qy, sd, z, r, g, b;
};

template <bool kColor>
__device__ __forceinline__ Point load_point(const Operands& a, int j) {
  Point pt = {false, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (j < a.p) {
    pt.ok = __ldg(a.cvalid + j) != 0;
    const float2 q = __ldg(reinterpret_cast<const float2*>(a.cxy) + j);
    pt.qx = q.x;
    pt.qy = q.y;
    pt.sd = __ldg(a.csd + j);
    pt.z = __ldg(a.cz + j);
    if (kColor) {
      pt.r = __ldg(a.ccolor + 3 * (size_t)j);
      pt.g = __ldg(a.ccolor + 3 * (size_t)j + 1);
      pt.b = __ldg(a.ccolor + 3 * (size_t)j + 2);
    }
  }
  return pt;
}

template <int K, typename S, bool kColor>
__global__ void __launch_bounds__(32)
cloud_merge_kernel(const Operands a, int cap) {
  constexpr int kVals = kColor ? 5 : 2;
  extern __shared__ float4 smem4[];
  float4* stage = smem4;                                     // [32]
  float* stage5 = reinterpret_cast<float*>(smem4 + 32);      // [32]
  float* acc = stage5 + 32;                                  // [kVals][cap]

  const int n = blockIdx.x;
  const int b = __ldg(a.blk + n);
  if (b < 0 || b >= a.num_blocks) return;  // uniform across the warp
  const float bx0 = __ldg(a.bounds), bx1 = __ldg(a.bounds + 1);
  const float by0 = __ldg(a.bounds + 2), by1 = __ldg(a.bounds + 3);
  if (!(bx0 <= bx1 && by0 <= by1)) return;  // no valid point
  const float c = __ldg(a.pc + n), s = __ldg(a.ps + n);
  const float x = __ldg(a.px + n), y = __ldg(a.py + n);
  const float zo = __ldg(a.pz + n);
  const float zsd = __ldg(a.pzsd + n);
  const float zs2 = __fmul_rn(zsd, zsd);
  const float ox = __ldg(a.origin + 2 * (size_t)b);
  const float oy = __ldg(a.origin + 2 * (size_t)b + 1);

  // the window: the box's corners under the pose, in cells
  float fx0 = INFINITY, fx1 = -INFINITY, fy0 = INFINITY, fy1 = -INFINITY;
#pragma unroll
  for (int corner = 0; corner < 4; ++corner) {
    const float qx = (corner & 1) ? bx1 : bx0;
    const float qy = (corner & 2) ? by1 : by0;
    const float wx = __fadd_rn(__fsub_rn(__fmul_rn(c, qx), __fmul_rn(s, qy)), x);
    const float wy = __fadd_rn(__fadd_rn(__fmul_rn(s, qx), __fmul_rn(c, qy)), y);
    const float fx = __fmul_rn(__fsub_rn(wx, ox), a.inv_res);
    const float fy = __fmul_rn(__fsub_rn(wy, oy), a.inv_res);
    fx0 = fminf(fx0, fx);
    fx1 = fmaxf(fx1, fx);
    fy0 = fminf(fy0, fy);
    fy1 = fmaxf(fy1, fy);
  }
  int lo_x, hi_x, lo_y, hi_y;
  cell_range(fx0, fx1, a.nx, lo_x, hi_x);
  cell_range(fy0, fy1, a.ny, lo_y, hi_y);
  if (lo_x > hi_x || lo_y > hi_y) return;  // the cloud misses the block

  const int lane = threadIdx.x;
  const size_t block_base = (size_t)b * a.nx * a.ny * K;
  unsigned long long placed = 0, written = 0;
  const int ty = min(hi_y - lo_y + 1, cap);
  const int tx = cap / ty;

  for (int x0 = lo_x; x0 <= hi_x; x0 += tx) {
    const int rx = min(tx, hi_x - x0 + 1);
    for (int y0 = lo_y; y0 <= hi_y; y0 += ty) {
      const int ry = min(ty, hi_y - y0 + 1);
      const int ncell = rx * ry;
      for (int v = 0; v < kVals; ++v) {
        for (int l = lane; l < ncell; l += 32) acc[v * cap + l] = 0.0f;
      }
      __syncwarp();
      Point next = load_point<kColor>(a, lane);
      for (int base = 0; base < a.p; base += 32) {
        // this lane's point, the next one's loads in flight meanwhile
        const Point pt = next;
        if (base + 32 < a.p) next = load_point<kColor>(a, base + 32 + lane);
        int cell = -1;
        float w = 0.0f, wz = 0.0f, wr = 0.0f, wg = 0.0f, wb = 0.0f;
        if (pt.ok) {
          const float wx =
              __fadd_rn(__fsub_rn(__fmul_rn(c, pt.qx), __fmul_rn(s, pt.qy)), x);
          const float wy =
              __fadd_rn(__fadd_rn(__fmul_rn(s, pt.qx), __fmul_rn(c, pt.qy)), y);
          const float fx = floorf(__fmul_rn(__fsub_rn(wx, ox), a.inv_res));
          const float fy = floorf(__fmul_rn(__fsub_rn(wy, oy), a.inv_res));
          if (fx >= (float)x0 && fx < (float)(x0 + rx) && fy >= (float)y0 &&
              fy < (float)(y0 + ry)) {
            cell = ((int)fx - x0) * ry + ((int)fy - y0);
            w = __fdiv_rn(1.0f, fmaxf(__fadd_rn(__fmul_rn(pt.sd, pt.sd), zs2),
                                      1e-12f));
            wz = __fmul_rn(w, __fadd_rn(pt.z, zo));
            if (kColor) {
              wr = __fmul_rn(w, pt.r);
              wg = __fmul_rn(w, pt.g);
              wb = __fmul_rn(w, pt.b);
            }
            ++placed;
          }
        }
        if (!__any_sync(kFull, cell >= 0)) continue;
        stage[lane] = make_float4(w, wz, wr, wg);
        if (kColor) stage5[lane] = wb;
        const unsigned group =
            __match_any_sync(kFull, cell >= 0 ? cell : -1 - lane);
        const bool leader = cell >= 0 && lane == __ffs(group) - 1;
        // every lane that follows its group's leader, in lane order
        const unsigned members = __ballot_sync(kFull, cell >= 0 && !leader);
        __syncwarp();
        float sw = 0.0f, swz = 0.0f, sr = 0.0f, sg = 0.0f, sb = 0.0f;
        if (leader) {
          sw = __fadd_rn(acc[cell], w);
          swz = __fadd_rn(acc[cap + cell], wz);
          if (kColor) {
            sr = __fadd_rn(acc[2 * cap + cell], wr);
            sg = __fadd_rn(acc[3 * cap + cell], wg);
            sb = __fadd_rn(acc[4 * cap + cell], wb);
          }
        }
        // The members in lane order, the same steps for every lane (no
        // lane waits on another's branch): four lanes' values loaded at
        // once, then a leader adds those of its own members and +0 for
        // the others.  A sum that starts at +0 is never -0, so adding +0
        // leaves it as it is, bit for bit.  Blocks of four lanes with no
        // member are skipped, alike for the whole warp.
        const unsigned mine = leader ? group & ~(1u << lane) : 0u;
#pragma unroll
        for (int j0 = 0; j0 < 32; j0 += 4) {
          if (((members >> j0) & 0xfu) == 0u) continue;
          float4 v[4];
          float v5[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            v[i] = stage[j0 + i];
            v5[i] = kColor ? stage5[j0 + i] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool take = (mine >> (j0 + i)) & 1u;
            sw = __fadd_rn(sw, take ? v[i].x : 0.0f);
            swz = __fadd_rn(swz, take ? v[i].y : 0.0f);
            if (kColor) {
              sr = __fadd_rn(sr, take ? v[i].z : 0.0f);
              sg = __fadd_rn(sg, take ? v[i].w : 0.0f);
              sb = __fadd_rn(sb, take ? v5[i] : 0.0f);
            }
          }
        }
        if (leader) {
          acc[cell] = sw;
          acc[cap + cell] = swz;
          if (kColor) {
            acc[2 * cap + cell] = sr;
            acc[3 * cap + cell] = sg;
            acc[4 * cap + cell] = sb;
          }
        }
        __syncwarp();
      }
      // the slot rules for every touched cell of the tile
      for (int l = lane; l < ncell; l += 32) {
        const float ws = acc[l];
        if (!(ws > 0.0f)) continue;
        const int ix = x0 + l / ry, iy = y0 + l % ry;
        const size_t base = block_base + ((size_t)ix * a.ny + iy) * K;
        fuse_cell<K, S>(a, base, ws, acc[cap + l],
                        kColor ? acc[2 * cap + l] : 0.0f,
                        kColor ? acc[3 * cap + l] : 0.0f,
                        kColor ? acc[4 * cap + l] : 0.0f);
        ++written;
      }
      __syncwarp();
    }
  }
  if (a.counters != nullptr) {
    for (int off = 16; off; off >>= 1) {
      placed += __shfl_down_sync(kFull, placed, off);
      written += __shfl_down_sync(kFull, written, off);
    }
    if (lane == 0) {
      if (placed) atomicAdd(a.counters, placed);
      if (written) atomicAdd(a.counters + 1, written);
    }
  }
}

template <int K, typename S, bool kColor>
int launch(const Operands& a, cudaStream_t stream) {
  constexpr int kVals = kColor ? 5 : 2;
  const int cap = kAccBytes / (kVals * (int)sizeof(float));
  const size_t smem =
      32 * sizeof(float4) + 32 * sizeof(float) + (size_t)kVals * cap * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cloud_merge_kernel<K, S, kColor>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cloud_merge_kernel<K, S, kColor><<<a.n, 32, smem, stream>>>(a, cap);
  return (int)cudaGetLastError();
}

template <typename S, bool kColor>
int dispatch_k(const Operands& a, int k, cudaStream_t stream) {
  switch (k) {
    case 1: return launch<1, S, kColor>(a, stream);
    case 2: return launch<2, S, kColor>(a, stream);
    case 4: return launch<4, S, kColor>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename S>
int dispatch(const Operands& a, int k, cudaStream_t stream) {
  return a.color != nullptr ? dispatch_k<S, true>(a, k, stream)
                            : dispatch_k<S, false>(a, k, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Updates the pool in place on
// `stream` and returns cudaGetLastError(); cudaErrorInvalidValue for a k
// other than 1, 2 or 4.  Pool fields [num_blocks, nx, ny*k] (mean, stdev,
// height float32, or bfloat16 when `bf16` is not 0; int32 meta) and, when
// color is not null, [num_blocks, nx, ny*k*3] of the same storage type
// with ccolor [p, 3] float32; origin [num_blocks, 2] float32; blk [n]
// int32; px, py, pc, ps, pz, pzsd [n] float32; cxy [p, 2], cz, csd [p]
// float32, cvalid [p] bool; bounds [4] float32; counters [2] int64 or
// null; update_idx [] int32.
extern "C" int cloud_merge_launch(
    void* mean, void* stdev, void* height, int* meta, void* color,
    const float* origin, const int* blk, const float* px, const float* py,
    const float* pc, const float* ps, const float* pz, const float* pzsd,
    const float* cxy, const float* cz, const float* csd,
    const unsigned char* cvalid, const float* ccolor, const float* bounds,
    unsigned long long* counters, int n, int p, int num_blocks, int nx,
    int ny, int k, int bf16, const int* update_idx, float inv_res,
    float patch_thickness, float gap_size, void* stream) {
  if (n <= 0 || p <= 0) return (int)cudaSuccess;
  const Operands a = {mean, stdev, height, meta, color, origin, blk, px,
                      py, pc, ps, pz, pzsd, cxy, cz, csd, cvalid,
                      color != nullptr ? ccolor : nullptr, bounds, counters,
                      update_idx, n, p, num_blocks, nx, ny, inv_res,
                      patch_thickness, gap_size};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(a, k, st) : dispatch<float>(a, k, st);
}
