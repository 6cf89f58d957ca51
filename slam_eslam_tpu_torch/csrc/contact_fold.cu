// Contact fold: per-particle contact-likelihood statistics against one
// shared MLS grid, in one pass.
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
// What bounds it on an H100: nothing but memory traffic.  At the
// benchmark shape (N = 100k particles, C = 8 contacts, a 400x400x(2K=8)
// f32 grid of 5 MB) one call reads 800k x 12 B of contact-grid queries
// (coalesced), 800k x 32 B of cell rows (random, but the whole grid fits
// in the 50 MB L2, so most hit L2), 100k x 4 B of measurement variance,
// and writes 100k x 32 B.  Per query it does ~60 flops and two expf.
// The TPU kernel's VMEM window, one-hot MXU gathers and lane layouts
// exist only because a TPU gathers slowly; a GPU reads the cell row
// directly.  So the design is one plain pass: one thread per particle,
// a loop over the C contact rows in order, running per-group sums that
// are flushed at each group boundary, no shared memory and no atomics.
// Nothing is padded: threads past N return.
//
// Arithmetic follows the JAX reference op for op in float (IEEE division
// and sqrt, expf); do not build with --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kMillsU0 = -3.0f;
constexpr int kMillsCfDepth = 8;

// Inverse Mills ratio phi(u) / Phi(u): Abramowitz-Stegun 7.1.26 erfc for
// u >= -3, the Laplace continued fraction (depth 8) below.
__device__ __forceinline__ float mills_ratio(float u) {
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
  const float lam_a = phi / fmaxf(cphi, 1e-38f);
  const float xx = fmaxf(-u, 0.5f);
  float tcf = xx;
#pragma unroll
  for (int j = kMillsCfDepth; j > 0; --j) tcf = xx + (float)j / tcf;
  return u >= kMillsU0 ? lam_a : tcf;
}

template <int K>
__device__ __forceinline__ void load_cell(const float* __restrict__ cell,
                                          float (&m)[K], float (&s)[K]) {
  if constexpr (K == 4) {
    const float4 mv = __ldg(reinterpret_cast<const float4*>(cell));
    const float4 sv = __ldg(reinterpret_cast<const float4*>(cell) + 1);
    m[0] = mv.x; m[1] = mv.y; m[2] = mv.z; m[3] = mv.w;
    s[0] = sv.x; s[1] = sv.y; s[2] = sv.z; s[3] = sv.w;
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      m[k] = __ldg(cell + k);
      s[k] = __ldg(cell + K + k);
    }
  }
}

struct GroupSums {
  float rsum, zds, zvs, pvs, ncb, acts;
};

__device__ __forceinline__ void reset(GroupSums& g) {
  g.rsum = g.zds = g.zvs = g.pvs = g.ncb = g.acts = 0.0f;
}

// The group epilogue of _contact_group_stats: a group is valid when every
// active member found a patch (ncb >= acts), at least one did, and the
// ratio mass is not negligible.
__device__ __forceinline__ void flush(const GroupSums& g, float& d1, float& d2,
                                      float& sq, float& pv, float& nc) {
  const bool ok = (g.ncb >= g.acts - 0.5f) && (g.ncb > 0.5f) && (g.rsum > 1e-9f);
  const float okf = ok ? 1.0f : 0.0f;
  const float safe = ok ? g.rsum : 1.0f;
  const float czd = ok ? g.zds / safe : 0.0f;
  const float inv = okf * safe / (ok ? g.zvs : 1.0f);
  d1 = d1 + czd * inv;
  d2 = d2 + inv;
  sq = sq + czd * czd * inv;
  pv = pv + okf * g.pvs / safe;
  nc = nc + okf;
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

    float m[K], sd[K];
    load_cell<K>(table + ((size_t)ix * ny + iy) * (2 * K), m, sd);
    int best = -1;
    float bestd = INFINITY;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float dist = fabsf(m[k] - z);
      if (sd[k] >= 0.0f && dist <= z_window && dist < bestd) {
        best = k;
        bestd = dist;
      }
    }
    if (best < 0) continue;  // no slot within the z window

    float mean = 0.0f, stdev = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k == best) {
        mean = m[k];
        stdev = fabsf(sd[k]);
      }
    }
    const float zdiff = z - mean;
    const float pose_var = stdev * stdev;
    const float zvar = pose_var + mvi;
    const float sc = sqrtf(zvar) * correction;
    const float ratio = mills_ratio(zdiff / sc) / sc;
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
