// The stage layout of the cooperative wavefront kernels (op_row, shared by
// temporal_pair.cu and temporal_kstep.cu), and the pair kernel's scalar
// elements: one Jia-Zhao anisotropic dual update and one reconstruction
// update (with the reference cube's squared errors, optionally) of a
// single element, with the arithmetic of fused_iteration.cu
// (the same clip form, the same order of operations; built with
// --fmad=false), so the pair kernel's state is bitwise equal to two K=1
// launches. (The K-step kernel walks four elements per thread, vec_walk.cuh.)
//
// `Args` is a kernel's argument struct; these functions read its members
// recon, orig, b[k], d[k], n[k] and s[k]. Loads of the state bypass L1
// (ld.global.cg): L1 is not coherent across SMs, and a wavefront kernel
// rewrites rows that other blocks read before the previous grid barrier.
// Only orig and the reference cube, which nothing writes, take the
// read-only path.

#pragma once

#include <stdint.h>

#include "block.cuh"

namespace {

__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }

// Jia-Zhao backward neighbour: a_{i-1}, or the element itself at index 0.
__device__ __forceinline__ int64_t bwd(int64_t idx, int64_t c, int64_t s) {
  return c > 0 ? idx - s : idx;
}

// Jia-Zhao forward neighbour: b_{i+1}, or b_0 (kept zero) at the last index.
__device__ __forceinline__ int64_t fwd(int64_t idx, int64_t c, int64_t n,
                                       int64_t s) {
  return c < n - 1 ? idx + s : idx - (n - 1) * s;
}

// The row of row-operation `op` in stage `st`: dual-(l+1) (op 2l) at
// st - 3l, recon-(l+1) (op 2l+1) two rows behind it.
__device__ __forceinline__ int64_t op_row(int64_t st, int op) {
  return st - 3 * (op / 2) - 2 * (op % 2);
}

// Dual update of one element at one level, as fused_iteration.cu's
// dual_kernel does it for an anisotropic axis; returns sum_k |b_k|. Every
// load of the element is sent before its first store: recon at the element
// and its backward neighbours, then each axis's b and d. The element waits
// one L2 round trip instead of one per axis (a store to b_k or d_k could
// alias the next axis's loads, so the compiler keeps them in program
// order). Race-free: the element's own b, d are read and written by this
// thread only, and recon, which a dual reads around the element, no dual
// writes. The arithmetic and its order are dual_kernel's.
// SEAM0 (the first row of a mesh shard, temporal_pair.cu's HALO0): the
// axis-0 backward neighbour is xb0, the caller's value from the -1 shard's
// bands, instead of a load.
template <int ND, bool FISTA, bool SEAM0, class Args>
__device__ __forceinline__ double dual_elem(const Args& a, int64_t idx,
                                            const int64_t* c, const float* lam,
                                            float rho, float xb0) {
  const float x = ld(a.recon + idx);
  float xb[ND], bo[ND], dold[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    xb[k] = SEAM0 && k == 0 ? xb0 : ld(a.recon + bwd(idx, c[k], a.s[k]));
    bo[k] = ld(a.b[k] + idx);
    if (FISTA) dold[k] = ld(a.d[k] + idx);
  }
  double acc = 0.0;
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    const float diff = x - xb[k];
    const float dn = fminf(fmaxf(diff + bo[k], -lam[k]), lam[k]);
    const float bn = FISTA ? dn + rho * (dn - dold[k]) : dn;
    // b before d: the store of d then waits for bn, so for the load of
    // d's old value, and never goes out while that load is in flight (a d
    // store sent with that load in flight made the pair kernel 2.6-6x
    // slower, PERF.md section 6, PR 8)
    a.b[k][idx] = bn;
    if (FISTA) a.d[k][idx] = dn;
    acc += static_cast<double>(fabsf(bn));
  }
  return acc;
}

// Reconstruction update of one element, as fused_iteration.cu's
// recon_kernel does it; adds |R_new - R_old| and |R_old| to the sums. With
// a reference cube (REF; `Args` then has a member `ref`) it also adds
// (R_old - ref)^2 and (R_new - ref)^2 to sse_old and sse_new, from one load
// of ref: the pair kernel's recon-2 element holds both iterations' recon
// there (R_old is iteration 1's). ref, which nothing writes, takes the
// read-only path, and its load is sent with orig's, before the store.
// SEAM0 (the last row of a mesh shard, HALO0): the axis-0 forward
// neighbour is bf0, the caller's value (the +1 shard's first b_0 row,
// recomputed, or Jia-Zhao's zero at the global edge), instead of a load.
template <int ND, bool REF, bool SEAM0, class Args>
__device__ __forceinline__ void recon_elem(const Args& a, int64_t idx,
                                           const int64_t* c, const float* lm,
                                           double& dnum, double& dden,
                                           double& sse_old, double& sse_new,
                                           float bf0) {
  float div = 0.0f;
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    const float bk = ld(a.b[k] + idx);
    const float bf = SEAM0 && k == 0
                         ? bf0
                         : ld(a.b[k] + fwd(idx, c[k], a.n[k], a.s[k]));
    div = div + lm[k] * (bk - bf);
  }
  const float og = __ldg(a.orig + idx);
  const float rv = REF ? __ldg(a.ref + idx) : 0.0f;
  const float rn = og - div;
  const float ro = ld(a.recon + idx);
  dnum += static_cast<double>(fabsf(rn - ro));
  dden += static_cast<double>(fabsf(ro));
  if (REF) {
    const float e_old = ro - rv;
    const float e_new = rn - rv;
    sse_old += static_cast<double>(e_old * e_old);
    sse_new += static_cast<double>(e_new * e_new);
  }
  a.recon[idx] = rn;
}

}  // namespace
