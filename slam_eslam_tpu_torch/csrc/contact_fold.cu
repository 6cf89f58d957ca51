// Contact fold: per-particle contact-likelihood statistics against one
// shared MLS grid, in one launch.
//
// Replaces the TPU kernel slam_eslam_tpu/ops/pallas_gather.py
// ::_fused_select_contact_kernel (entered through window_select_contact
// and windowed_grid_lookup.fold).  Per contact query: the cell gather, the
// z-window slot select of mls_grid.get_patch_packed_cells, the Mills-ratio
// likelihood ratio (pallas_gather._mills_ratio / _contact_rows); per
// contact group: the ratio-weighted sums and the group validity rule of
// _contact_group_stats; per particle: the totals
//   out[0..7, i] = (d1, d2, sq, pose_var, n_contacts, 0, 0, 0).
//
// What bounds it on an H100: the instructions it executes, at about four
// times what the card would need for the call.  At the benchmark shape
// (N = 100k particles, C = 8 contacts, a 400x400x(2K=8) f32 grid of 5 MB
// that stays in the 50 MB L2) one call moves 800k x 12 B of queries, at
// most 160k x 32 B of cell rows, 100k x 4 B of measurement variance and
// 100k x 32 B of output: 13.4 MB, 4.0 us at 3.35 TB/s.  The arithmetic the
// inputs need is as long: four IEEE divisions (ten for a query in the
// Mills ratio's tail), an IEEE square root and two expf, each 8
// instructions on nvcc's fast path without --use_fast_math, around 155
// instructions a query in all (utils/kernel_eff.py::fold_work and
// fold_costs count them from a call's inputs): 3.7 us at the card's
// 33.5e12 float32 instructions a second.  The kernel takes 16.5 us.  Its
// code holds some 560 instructions (chip_smoke.py prints the count from
// `cuobjdump -sass`): the operand checks and call set-up around every
// IEEE division and square root, the select on register arrays, and both
// Mills branches, which nearly every warp runs in full because one query
// in eight lies in the tail.  Taking the Mills ratio out of a build took
// two fifths off its time, --use_fast_math as much, and with all the
// arithmetic out the loads, the select and the stores alone took 8.9 us
// (the cell select K5 alone takes 7.5 us for as many queries).  None of
// these may go: the arithmetic is the reference's, op for op.
//
// Layouts that were built and measured against this one, all bit for bit
// equal to it: one thread per query (800k threads, the integrands handed
// to a particle's thread through shared memory) took the same time at
// N = 100k and 1.03 times it at C = 20; it wins only below some 30k
// particles (a third of the time at 4,096), where one thread per particle
// leaves most of the card idle, and no path runs the fold there.  Blocks
// of 64 to 1,024 threads, the next query's loads issued ahead of the
// arithmetic, the tail's queries gathered into dense warps, a grid-stride
// loop, rolled loops and a called division took the same time or longer.
//
// The design: one plain pass.  One thread per particle, a loop over the C
// contact rows in order, running per-group sums that are flushed at each
// group boundary, no shared memory and no atomics; a warp reads 32
// neighbouring floats of a query row.  The TPU kernel's VMEM window,
// one-hot MXU gathers and lane layouts exist only because a TPU gathers
// slowly; a GPU reads the cell row directly.  Nothing is padded: threads
// past N return.
//
// No warp takes IEEE division's slow path for nothing.  nvcc's division
// checks its operands' exponents and calls a subroutine of some 170
// instructions for a zero, denormal or huge one, and the whole warp waits
// for it.  Written naively the fold divides 0 by something in most warps:
// phi(u) underflows to 0 for u > 14.6 (any query a metre off its patch),
// an invalid group divides 0 by 1 three times, and the head's Phi(u),
// clamped to 1e-38, is divided by for every query of the tail, whose
// result the select then drops.  Here the head runs only for u >= -3 and
// the tail's continued fraction (eight divisions) only for u < -3, a zero
// phi or ratio skips its division (0 / x = +0 for the positive x here)
// and an invalid group adds its zeros directly.  Every value is what the
// division would have given, bit for bit; the shortcuts take 10 to 14 %
// off the kernel's time.
//
// Arithmetic follows the JAX reference op for op in float (IEEE division
// and sqrt, expf); do not build with --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>

#include "slot_select.cuh"

namespace {

constexpr float kMillsU0 = -3.0f;
constexpr int kMillsCfDepth = 8;

// Inverse Mills ratio phi(u) / Phi(u): the Laplace continued fraction
// (depth 8) in the tail u < -3 (and for a NaN), Abramowitz-Stegun 7.1.26
// erfc elsewhere.  Two branches, so a warp pays the tail's eight divisions
// only when one of its queries lies there, and no tail query pays the
// head's division by a Phi(u) clamped to 1e-38.
__device__ __forceinline__ float mills_ratio(float u) {
  if (!(u >= kMillsU0)) {
    const float xx = fmaxf(-u, 0.5f);
    float tcf = xx;
#pragma unroll
    for (int j = kMillsCfDepth; j > 0; --j) tcf = xx + (float)j / tcf;
    return tcf;
  }
  const float a = u * -0.7071067811865476f;
  const float x = fabsf(a);
  const float t = 1.0f / (1.0f + 0.3275911f * x);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float e = poly * expf(-x * x);
  const float cphi = 0.5f * (a >= 0.0f ? e : 2.0f - e);
  const float phi = 0.3989422804014327f * expf(-0.5f * u * u);
  // phi underflows to 0 for u > 14.6 and 0 / cphi is +0: skip the
  // division, whose zero numerator would send the warp down IEEE
  // division's slow path
  return phi == 0.0f ? 0.0f : phi / fmaxf(cphi, 1e-38f);
}

struct GroupSums {
  float rsum, zds, zvs, pvs, ncb, acts;
};

__device__ __forceinline__ void reset(GroupSums& g) {
  g.rsum = g.zds = g.zvs = g.pvs = g.ncb = g.acts = 0.0f;
}

// The group epilogue of _contact_group_stats: a group is valid when every
// active member found a patch (ncb >= acts), at least one did, and the
// ratio mass is not negligible.  Returns what the group adds to the
// particle's totals: (cp_zdiff, 1 / cp_zvar, pose_var share, valid).
__device__ __forceinline__ float4 epilogue(const GroupSums& g) {
  const bool ok = (g.ncb >= g.acts - 0.5f) && (g.ncb > 0.5f) && (g.rsum > 1e-9f);
  // an invalid group adds (0, 0 * 1 / 1, 0 * pvs / 1, 0): no division
  if (!ok) return make_float4(0.0f, 0.0f, 0.0f * g.pvs, 0.0f);
  return make_float4(g.zds / g.rsum, g.rsum / g.zvs, g.pvs / g.rsum, 1.0f);
}

// Add a finished group to the particle's totals.
__device__ __forceinline__ void flush(const GroupSums& g, float& d1, float& d2,
                                      float& sq, float& pv, float& nc) {
  const float4 e = epilogue(g);
  const float czd = e.x, inv = e.y;
  d1 = d1 + czd * inv;
  d2 = d2 + inv;
  sq = sq + czd * czd * inv;
  pv = pv + e.z;
  nc = nc + e.w;
}

// qx, qy, qz: [C, N] world queries; mv: [N]; act: [C] 0/1 active mask;
// seg: [C] group ids, equal ids consecutive; origin: [2];
// table: [nx, ny, 2K]; out: [8, N].
template <int K>
__global__ void __launch_bounds__(256)
contact_fold_kernel(const float* __restrict__ qx, const float* __restrict__ qy,
                    const float* __restrict__ qz, const float* __restrict__ mv,
                    const float* __restrict__ act, const int* __restrict__ seg,
                    const float* __restrict__ origin,
                    const float* __restrict__ table, float* __restrict__ out,
                    int c, int n, int nx, int ny, float inv_res,
                    float z_window, float correction) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = __ldg(origin);
  const float oy = __ldg(origin + 1);
  const float mvi = __ldg(mv + i);

  float d1 = 0.0f, d2 = 0.0f, sq = 0.0f, pv = 0.0f, nc = 0.0f;
  GroupSums g;
  reset(g);
  for (int ci = 0; ci < c; ++ci) {
    const int s = __ldg(seg + ci);
    if (ci > 0 && s != __ldg(seg + ci - 1)) {
      flush(g, d1, d2, sq, pv, nc);
      reset(g);
    }
    const float a = __ldg(act + ci);
    g.acts += a;
    if (a <= 0.5f) continue;  // inactive: contributes nothing

    const size_t q = (size_t)ci * n + i;
    const float x = __ldg(qx + q);
    const float y = __ldg(qy + q);
    const float z = __ldg(qz + q);
    // floor(offset * cells-per-metre): bit for bit the plain version's
    // mls_grid.cells
    const int ix = (int)floorf((x - ox) * inv_res);
    const int iy = (int)floorf((y - oy) * inv_res);
    if (ix < 0 || ix >= nx || iy < 0 || iy >= ny) continue;  // not found

    const float* cell = table + ((size_t)ix * ny + iy) * (2 * K);
    float m[K], sd[K];
    bool valid[K];
    slot_select::load_slots<K>(cell, m);
    slot_select::load_slots<K>(cell + K, sd);
#pragma unroll
    for (int k = 0; k < K; ++k) valid[k] = sd[k] >= 0.0f;
    const int best = slot_select::zwindow_select<K>(m, valid, z, z_window);
    if (best < 0) continue;  // no slot within the z window

    const float zdiff = z - slot_select::pick<K>(m, best);
    const float stdev = fabsf(slot_select::pick<K>(sd, best));
    // rounded before zvar's sum, as the plain version rounds it: left to
    // itself nvcc fuses the two in some builds of this loop and not in
    // others, which moves the last bit of every sum
    const float pose_var = __fmul_rn(stdev, stdev);
    const float zvar = pose_var + mvi;
    const float sc = sqrtf(zvar) * correction;
    const float lam = mills_ratio(zdiff / sc);
    // 0 / sc is +0 for the positive sc here: skip the division
    const float ratio = (lam == 0.0f && sc > 0.0f) ? 0.0f : lam / sc;
    g.rsum += ratio;
    g.zds += ratio * zdiff;
    g.zvs += ratio * zvar;
    g.pvs += ratio * pose_var;
    g.ncb += 1.0f;
  }
  if (c > 0) flush(g, d1, d2, sq, pv, nc);

  out[i] = d1;
  out[(size_t)n + i] = d2;
  out[2 * (size_t)n + i] = sq;
  out[3 * (size_t)n + i] = pv;
  out[4 * (size_t)n + i] = nc;
  out[5 * (size_t)n + i] = 0.0f;
  out[6 * (size_t)n + i] = 0.0f;
  out[7 * (size_t)n + i] = 0.0f;
}

template <int K>
void launch(const float* qx, const float* qy, const float* qz, const float* mv,
            const float* act, const int* seg, const float* origin,
            const float* table, float* out, int c, int n, int nx, int ny,
            float inv_res, float z_window, float correction,
            cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int blocks = (n + kThreads - 1) / kThreads;
  contact_fold_kernel<K><<<blocks, kThreads, 0, stream>>>(
      qx, qy, qz, mv, act, seg, origin, table, out, c, n, nx, ny, inv_res,
      z_window, correction);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream` and
// returns cudaGetLastError(); cudaErrorInvalidValue for a K other than the
// slot counts the repository's grids use (1, 2, 4).
extern "C" int contact_fold_launch(const float* qx, const float* qy,
                                   const float* qz, const float* mv,
                                   const float* act, const int* seg,
                                   const float* origin, const float* table,
                                   float* out, int c, int n, int nx, int ny,
                                   int k, float inv_res, float z_window,
                                   float correction, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: launch<1>(qx, qy, qz, mv, act, seg, origin, table, out, c, n, nx, ny, inv_res, z_window, correction, st); break;
    case 2: launch<2>(qx, qy, qz, mv, act, seg, origin, table, out, c, n, nx, ny, inv_res, z_window, correction, st); break;
    case 4: launch<4>(qx, qy, qz, mv, act, seg, origin, table, out, c, n, nx, ny, inv_res, z_window, correction, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
