// Element code of one TV iteration for the one-iteration kernels of
// fused_iteration.cu: the argument struct, the boundary offsets of all
// three boundary conditions, the (row, tile) walk over a block's work
// items, and one element's dual update and reconstruction update. The
// vector walk of the whole-run and K-step kernels (vec_walk.cuh) shares
// the struct, the shape, the boundary offsets and the arithmetic helpers,
// and does each element's arithmetic in the order of dual_elem and
// recon_elem (built with --fmad=false), so their state is bitwise equal to
// the same number of one-iteration launches; its walk and loads are its
// own. The block's layout (TX, TY, NT) is block.cuh's.
//
// The one-iteration kernels load the state plainly: a launch boundary
// separates each write from every read of another block.
//
// HALO makes the cube one axis-0 slab of a larger one (out-of-core runs):
// seam operands (Halos) stand in for the Jia-Zhao edges of axes 0 and 1,
// as the TPU kernel's with-halo operands do (cytvdn_tpu/kernels/fused.py
// :316-328). The backward difference at a leading edge reads the -1
// neighbour's pre-update slab; the forward difference at a trailing edge
// reads the +1 neighbour's first updated accumulator slab, which the dual
// update recomputes from that neighbour's pre-update slabs with the
// neighbour's own arithmetic and leaves in a scratch slab (bhat) for the
// reconstruction update. A caller realizes a global edge by the halo's
// values: its own edge slab as prev, its own last slab with zero acc and d
// as next, so that bhat is exactly the Jia-Zhao zero.
//
// Layout: a block is 32 x 8 threads over a tile of the two trailing axes
// (x along the contiguous last axis). Work items are (row, tile) pairs, the
// tile index fastest, the leading axes (one in 3D, two in 4D) flattened into
// rows; blocks stride over them, so blocks in flight together cover
// neighbouring tiles of a row and stream through memory. Index arithmetic is
// 32-bit (the wrappers keep the work-item count below 2^31); element offsets
// are 64-bit. The rank is a template parameter, so the per-axis scalars live
// in registers.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "block.cuh"

namespace {

__device__ __forceinline__ float clip_(float x, float c) { return fminf(fmaxf(x, -c), c); }
__device__ __forceinline__ double clip_(double x, double c) { return fmin(fmax(x, -c), c); }
__device__ __forceinline__ float hypot_(float a, float b) { return hypotf(a, b); }
__device__ __forceinline__ double hypot_(double a, double b) { return hypot(a, b); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }

template <typename T>
struct Args {
  const T* orig;
  T* recon;
  T* b[4];
  T* d[4];
  const T* lambda_inv;
  const T* lam_mu;
  const T* rho;
  double* partials;  // [3][gridDim.x] (one-iteration kernels)
  T* out;            // [3]: sum|b|, sum|recon_new - recon|, sum|recon|
  int64_t n[4];      // extents of the ndim axes
  int64_t s[4];      // element strides of the ndim axes
  int64_t rows;      // product of the leading ndim-2 extents
  int64_t tiles_m;   // tiles of TY along axis ndim-2
  int64_t tiles_l;   // tiles of TX along axis ndim-1
  int bc;            // 0 periodic, 1 mirror, 2 Jia-Zhao
  int iso_r;         // joint projection of axes (0, 1)
  int iso_q;         // joint projection of axes (2, 3)
};

// Seam operands of a HALO launch, for axes 0 and 1. Each has the cube's
// layout with that axis collapsed to 1.
template <typename T>
struct Halos {
  const T* prev[2];        // the -1 neighbour's pre-update last slab of recon
  const T* next_recon[2];  // the +1 neighbour's pre-update first slab of recon,
  const T* next_acc[2];    //   of its accumulator along the axis
  const T* next_d[2];      //   and of its shadow dual (FISTA)
  T* bhat[2];              // scratch: the +1 neighbour's updated first b slab
};

// Fills the extents, strides, rows and tiles of `a` for an ndim-axis cube.
template <typename T>
void set_shape(Args<T>& a, int ndim, const long long n[4]) {
  for (int k = 0; k < 4; ++k) a.n[k] = k < ndim ? n[k] : 1;
  int64_t stride = 1;
  for (int k = ndim - 1; k >= 0; --k) {
    a.s[k] = stride;
    stride *= a.n[k];
  }
  for (int k = ndim; k < 4; ++k) a.s[k] = 0;
  a.rows = 1;
  for (int k = 0; k < ndim - 2; ++k) a.rows *= a.n[k];
  a.tiles_m = (a.n[ndim - 2] + TY - 1) / TY;
  a.tiles_l = (a.n[ndim - 1] + TX - 1) / TX;
}

// Offset of s_i = a_{i-1} along one axis.
__device__ __forceinline__ int64_t bwd(int64_t idx, int64_t c, int64_t n,
                                       int64_t s, int bc) {
  if (c > 0) return idx - s;
  if (bc == 0) return idx + (n - 1) * s;  // periodic: a_{N-1}
  if (bc == 1) return idx + s;            // mirror: a_1
  return idx;                             // Jia-Zhao: own element
}

// Offset of s_i = b_{i+1} along one axis.
__device__ __forceinline__ int64_t fwd(int64_t idx, int64_t c, int64_t n,
                                       int64_t s, int bc) {
  if (c < n - 1) return idx + s;
  if (bc == 1) return idx;                // mirror: own b_{N-1}
  return idx - (n - 1) * s;               // periodic and Jia-Zhao: b_0
}

// Offset of an element's image in a slab with axis A (0 or 1) collapsed
// to 1: the element's offset without its axis-A coordinate.
__device__ __forceinline__ int64_t seam_offset(int A, int64_t idx,
                                               const int64_t* c,
                                               const int64_t* s) {
  const int64_t rest = idx - c[0] * s[0];
  return A == 0 ? rest : c[0] * s[1] + (rest - c[1] * s[1]);
}

// Walk this block's (row, tile) work items and call body(idx, c) with each
// element's offset and coordinates. Threads past the ragged edge of a tile
// skip it. A block visits the same elements on every walk.
template <int ND, typename T, typename F>
__device__ __forceinline__ void for_each_element(const Args<T>& a, F body) {
  const uint32_t tiles = static_cast<uint32_t>(a.tiles_m * a.tiles_l);
  const uint32_t tl_n = static_cast<uint32_t>(a.tiles_l);
  const uint32_t work = static_cast<uint32_t>(a.rows) * tiles;
  const int64_t M = a.n[ND - 2];
  const int64_t L = a.n[ND - 1];
  const uint32_t n1 = static_cast<uint32_t>(a.n[1]);
  for (uint32_t w = blockIdx.x; w < work; w += gridDim.x) {
    const uint32_t r = w / tiles;
    const uint32_t t = w - r * tiles;
    const uint32_t tm = t / tl_n;
    const int64_t m = int64_t(tm) * TY + threadIdx.y;
    const int64_t l = int64_t(t - tm * tl_n) * TX + threadIdx.x;
    if (m >= M || l >= L) continue;
    int64_t c[ND];
    if (ND == 4) {
      const uint32_t c0 = r / n1;
      c[0] = c0;
      c[1] = r - c0 * n1;
    } else {
      c[0] = r;
    }
    c[ND - 2] = m;
    c[ND - 1] = l;
    body((int64_t(r) * M + m) * L + l, c);
  }
}

// Dual update of one element: every axis's b (and under FISTA d), reading
// recon at the element and its backward neighbours and b, d at the element;
// adds each new |b_k| to acc in axis order. With HALO, along axes 0 and 1
// the backward neighbour of a leading-edge element is h.prev, and a
// trailing-edge element also writes the +1 neighbour's recomputed b into
// h.bhat (not counted in acc).
template <typename T, int ND, bool FISTA, bool HALO>
__device__ __forceinline__ void dual_elem(const Args<T>& a, const Halos<T>& h,
                                          int64_t idx, const int64_t* c,
                                          const T* lam, T rho, bool iso_r,
                                          bool iso_q, double& acc) {
  const T x = a.recon[idx];
  // Unrolled in 4D only: unrolled in 3D, this loop measured 3x slower on
  // an H100 at 256x256x2048 FISTA (13.1 vs 4.3 ms, rolled), in 4D 12%
  // faster at 256^2 x 128^2 (48.7 vs 55.6 ms).
#pragma unroll (ND == 4 ? 4 : 1)
  for (int k = 0; k < ND; ++k) {
    if ((k == 1 && iso_r) || (k == 3 && iso_q)) continue;  // done with k-1
    if ((k == 0 && iso_r) || (k == 2 && iso_q)) {
      // the pair shares axis k's clip radius (reference cyTVDN.py:160-162)
      const T e1 = x - a.recon[bwd(idx, c[k], a.n[k], a.s[k], a.bc)]
                   + a.b[k][idx];
      const T e2 = x - a.recon[bwd(idx, c[k + 1], a.n[k + 1], a.s[k + 1],
                                   a.bc)]
                   + a.b[k + 1][idx];
      const T cl = lam[k];
      const T mag = hypot_(e1, e2);
      const T scale = mag > cl ? cl / (mag > T(0) ? mag : T(1)) : T(1);
      const T d1 = e1 * scale;
      const T d2 = e2 * scale;
      T b1 = d1, b2 = d2;
      if (FISTA) {
        b1 = d1 + rho * (d1 - a.d[k][idx]);
        b2 = d2 + rho * (d2 - a.d[k + 1][idx]);
        a.d[k][idx] = d1;
        a.d[k + 1][idx] = d2;
      }
      a.b[k][idx] = b1;
      a.b[k + 1][idx] = b2;
      acc += static_cast<double>(abs_(b1));
      acc += static_cast<double>(abs_(b2));
    } else {
      const bool seam = HALO && k < 2;
      const T prev = seam && c[k] == 0
                         ? h.prev[k][seam_offset(k, idx, c, a.s)]
                         : a.recon[bwd(idx, c[k], a.n[k], a.s[k], a.bc)];
      const T diff = x - prev;
      const T dn = clip_(diff + a.b[k][idx], lam[k]);
      T bn = dn;
      if (FISTA) {
        bn = dn + rho * (dn - a.d[k][idx]);
        a.d[k][idx] = dn;
      }
      a.b[k][idx] = bn;
      acc += static_cast<double>(abs_(bn));
      if (seam && c[k] == a.n[k] - 1) {
        // the +1 neighbour's first slab, in its own order of operations
        const int64_t o = seam_offset(k, idx, c, a.s);
        const T dh = clip_((h.next_recon[k][o] - x) + h.next_acc[k][o],
                           lam[k]);
        T bh = dh;
        if (FISTA) bh = dh + rho * (dh - h.next_d[k][o]);
        h.bhat[k][o] = bh;
      }
    }
  }
}

// Reconstruction update of one element, reading every b at the element and
// its forward neighbours (with HALO, along axes 0 and 1 h.bhat at a
// trailing edge); adds |R_new - R_old| and |R_old| to the sums and returns
// R_new.
template <typename T, int ND, bool HALO>
__device__ __forceinline__ T recon_elem(const Args<T>& a, const Halos<T>& h,
                                        int64_t idx, const int64_t* c,
                                        const T* lm, double& dnum,
                                        double& dden) {
  T div = T(0);
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    const T bk = a.b[k][idx];
    const T bf = HALO && k < 2 && c[k] == a.n[k] - 1
                     ? h.bhat[k][seam_offset(k, idx, c, a.s)]
                     : a.b[k][fwd(idx, c[k], a.n[k], a.s[k], a.bc)];
    div = div + lm[k] * (bk - bf);
  }
  const T rn = a.orig[idx] - div;
  const T ro = a.recon[idx];
  dnum += static_cast<double>(abs_(rn - ro));
  dden += static_cast<double>(abs_(ro));
  a.recon[idx] = rn;
  return rn;
}

}  // namespace
