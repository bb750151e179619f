// Element functions shared by the cooperative wavefront kernels
// (temporal_pair.cu, temporal_kstep.cu): one Jia-Zhao anisotropic dual
// update and one reconstruction update of a single element, with the
// arithmetic of fused_iteration.cu (the same clip form, the same order of
// operations; built with --fmad=false), so every wavefront kernel's state is
// bitwise equal to the same number of K=1 launches.
//
// `Args` is a kernel's argument struct; these functions read its members
// recon, orig, b[k], d[k], n[k] and s[k]. Loads of the state bypass L1
// (ld.global.cg): L1 is not coherent across SMs, and a wavefront kernel
// rewrites rows that other blocks read before the previous grid barrier.
// Only orig, which nothing writes, takes the read-only path.

#pragma once

#include <stdint.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int NT = TX * TY;

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

// Fixed-order tree sum over the block; every thread gets the total.
__device__ __forceinline__ double block_sum(double v, double* red) {
  const int t = threadIdx.y * TX + threadIdx.x;
  red[t] = v;
  __syncthreads();
  for (int h = NT / 2; h > 0; h >>= 1) {
    if (t < h) red[t] += red[t + h];
    __syncthreads();
  }
  const double total = red[0];
  __syncthreads();
  return total;
}

// Dual update of one element at one level, as fused_iteration.cu's
// dual_kernel does it for an anisotropic axis; returns sum_k |b_k|.
template <int ND, bool FISTA, class Args>
__device__ __forceinline__ double dual_elem(const Args& a, int64_t idx,
                                            const int64_t* c, const float* lam,
                                            float rho) {
  const float x = ld(a.recon + idx);
  double acc = 0.0;
#pragma unroll (ND == 4 ? 4 : 1)
  for (int k = 0; k < ND; ++k) {
    const float diff = x - ld(a.recon + bwd(idx, c[k], a.s[k]));
    const float dn = fminf(fmaxf(diff + ld(a.b[k] + idx), -lam[k]), lam[k]);
    float bn = dn;
    if (FISTA) {
      bn = dn + rho * (dn - ld(a.d[k] + idx));
      a.d[k][idx] = dn;
    }
    a.b[k][idx] = bn;
    acc += static_cast<double>(fabsf(bn));
  }
  return acc;
}

// Reconstruction update of one element, as fused_iteration.cu's
// recon_kernel does it; adds |R_new - R_old| and |R_old| to the sums.
template <int ND, class Args>
__device__ __forceinline__ void recon_elem(const Args& a, int64_t idx,
                                           const int64_t* c, const float* lm,
                                           double& dnum, double& dden) {
  float div = 0.0f;
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    const float bk = ld(a.b[k] + idx);
    const float bf = ld(a.b[k] + fwd(idx, c[k], a.n[k], a.s[k]));
    div = div + lm[k] * (bk - bf);
  }
  const float rn = __ldg(a.orig + idx) - div;
  const float ro = ld(a.recon + idx);
  dnum += static_cast<double>(fabsf(rn - ro));
  dden += static_cast<double>(fabsf(ro));
  a.recon[idx] = rn;
}

}  // namespace
