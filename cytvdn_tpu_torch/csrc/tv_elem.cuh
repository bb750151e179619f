// Element code of one TV iteration for the one-iteration kernels of
// fused_iteration.cu: the argument struct, the boundary offsets of all
// three boundary conditions, the (row, tile) walk over a block's work
// items, and one element's dual update and reconstruction update. The
// vector walk of the whole-run and K-step kernels (vec_walk.cuh) shares
// the struct, the shape, the boundary offsets and the arithmetic helpers,
// and does each element's arithmetic in the order of dual_elem and
// recon_elem (built with --fmad=false), so their state is bitwise equal to
// the same number of one-iteration launches; its walk and loads are its
// own. dual_elem_iso, the dual update of 4D half-isotropic launches, does
// dual_elem's arithmetic in its order with every load first;
// dual_elem_lossy, that of lossy-duals launches, with d stored as
// bfloat16. The block's layout (TX, TY, NT) is block.cuh's.
//
// The one-iteration kernels load the state plainly: a launch boundary
// separates each write from every read of another block.
//
// HALO makes the cube one block of a larger one (out-of-core slabs, mesh
// shards): seam operands (Halos) stand in for the edges of the halo axes
// (a non-null prev; axes 0 and 1 always, 2 and 3 on meshes that split
// them), as the TPU kernel's with-halo operands do
// (cytvdn_tpu/kernels/fused.py:316-356). The backward difference at a
// leading edge reads the -1 neighbour's pre-update slab; the forward
// difference at a trailing edge reads the +1 neighbour's first updated
// accumulator slab, which the dual update recomputes from that neighbour's
// pre-update slabs with the neighbour's own arithmetic (for a split
// half-isotropic axis, the joint projection, with the neighbour's partner
// accumulator and, at the partner's leading index, the diagonal
// neighbour's corner) and leaves in a scratch slab (bhat) for the
// reconstruction update. A caller realizes a global edge by the halo's
// values: Jia-Zhao its own edge slab as prev, its own last slab with zero
// acc and d as next, so that bhat is exactly the Jia-Zhao zero; mirror its
// own slab 1 as prev, and the block holding the trailing edge (a bit of
// Halos::edge) reads its own updated last slab; periodic the ring
// neighbours' slabs.
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

#include <cuda_bf16.h>
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

// Seam operands of a HALO launch, per axis (null: no halos on that axis).
// Each slab has the cube's layout with its axis collapsed to 1; a corner
// has the axis and its iso partner collapsed.
template <typename T>
struct Halos {
  const T* prev[4];        // the -1 neighbour's pre-update last slab of recon
  const T* next_recon[4];  // the +1 neighbour's pre-update first slab of recon,
  const T* next_acc[4];    //   of its accumulator along the axis
  const T* next_d[4];      //   and of its shadow dual (FISTA)
  const T* next_accp[4];   //   and of its partner-axis accumulator (iso)
  const T* corner[4];      // iso, partner split: the diagonal neighbour's recon
  T* bhat[4];              // scratch: the +1 neighbour's updated first b slab
  int edge;                // bit A: the block holds the cube's trailing edge
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

// Offset of an element's image in a halo slab: its coordinates in the
// cube's layout with axes A and B (B < 0: none) collapsed to 1.
template <int ND>
__device__ __forceinline__ int64_t slab_offset(const int64_t* c,
                                               const int64_t* n, int A,
                                               int B = -1) {
  int64_t o = 0;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    if (i != A && i != B) o = o * n[i] + c[i];
  }
  return o;
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

// The +1 neighbour's first updated accumulator slab along halo axis s at
// the image of element c (c[s] = n[s]-1, recon x), in the neighbour's own
// order of operations, into h.bhat[s]: the clip of its backward difference
// (whose operand is x) plus its accumulator, or, where it has a partner
// slab (split iso axis, partner o), the s component of the pair's joint
// projection, the partner's backward difference reading the neighbour's
// slab, the corner at the partner's leading index (partner split) or
// Jia-Zhao's zero.
template <typename T, int ND, bool FISTA>
__device__ __forceinline__ void seam_b(const Args<T>& a, const Halos<T>& h,
                                       int s, int o, const int64_t* c, T x,
                                       const T* lam, T rho) {
  const int64_t off = slab_offset<ND>(c, a.n, s);
  const T rn = h.next_recon[s][off];
  const T ds = (rn - x) + h.next_acc[s][off];
  T p;
  if (o >= 0 && h.next_accp[s] != nullptr) {
    T rp = rn;
    if (c[o] > 0) {
      int64_t cp[ND];
#pragma unroll
      for (int i = 0; i < ND; ++i) cp[i] = c[i] - (i == o);
      rp = h.next_recon[s][slab_offset<ND>(cp, a.n, s)];
    } else if (h.corner[s] != nullptr) {
      rp = h.corner[s][slab_offset<ND>(c, a.n, s, o)];
    }
    const T dp = (rn - rp) + h.next_accp[s][off];
    const T e1 = s < o ? ds : dp;
    const T e2 = s < o ? dp : ds;
    const T cl = lam[s < o ? s : o];
    const T mag = hypot_(e1, e2);
    const T scale = mag > cl ? cl / (mag > T(0) ? mag : T(1)) : T(1);
    p = ds * scale;
  } else {
    p = clip_(ds, lam[s]);
  }
  T bh = p;
  if (FISTA) bh = p + rho * (p - h.next_d[s][off]);
  h.bhat[s][off] = bh;
}

// The backward neighbour's recon along axis k: with HALO, h.prev at a halo
// axis's leading edge.
template <typename T, int ND, bool HALO>
__device__ __forceinline__ T prev_recon(const Args<T>& a, const Halos<T>& h,
                                        int k, int64_t idx,
                                        const int64_t* c) {
  if (HALO && h.prev[k] != nullptr && c[k] == 0)
    return h.prev[k][slab_offset<ND>(c, a.n, k)];
  return a.recon[bwd(idx, c[k], a.n[k], a.s[k], a.bc)];
}

// Dual update of one element: every axis's b (and under FISTA d), reading
// recon at the element and its backward neighbours and b, d at the element;
// adds each new |b_k| to acc in axis order. With HALO, along each halo axis
// the backward neighbour of a leading-edge element is h.prev, and a
// trailing-edge element also writes the +1 neighbour's recomputed b into
// h.bhat (seam_b; not counted in acc). The 4D half-isotropic launches take
// dual_elem_iso, so no launch runs the iso branch here; it stays so that
// the anisotropic instantiations compile to the code they were measured as.
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
      const T e1 = x - prev_recon<T, ND, HALO>(a, h, k, idx, c)
                   + a.b[k][idx];
      const T e2 = x - prev_recon<T, ND, HALO>(a, h, k + 1, idx, c)
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
      if (HALO) {
        if (h.prev[k] != nullptr && c[k] == a.n[k] - 1)
          seam_b<T, ND, FISTA>(a, h, k, k + 1, c, x, lam, rho);
        if (h.prev[k + 1] != nullptr && c[k + 1] == a.n[k + 1] - 1)
          seam_b<T, ND, FISTA>(a, h, k + 1, k, c, x, lam, rho);
      }
    } else {
      const T prev = prev_recon<T, ND, HALO>(a, h, k, idx, c);
      const T diff = x - prev;
      const T dn = clip_(diff + a.b[k][idx], lam[k]);
      T bn = dn;
      if (FISTA) {
        bn = dn + rho * (dn - a.d[k][idx]);
        a.d[k][idx] = dn;
      }
      a.b[k][idx] = bn;
      acc += static_cast<double>(abs_(bn));
      if (HALO && h.prev[k] != nullptr && c[k] == a.n[k] - 1)
        seam_b<T, ND, FISTA>(a, h, k, -1, c, x, lam, rho);
    }
  }
}

// v[k] for a k known only at run time, as a chain of selects over the ND
// constant indices, so that v stays in registers: a runtime index into a
// local array (lam, c) puts the array in local memory, as it does in
// dual_elem's rolled 3D loop.
template <int ND, typename V>
__device__ __forceinline__ V pick(const V* v, int k) {
  V r = v[0];
#pragma unroll
  for (int i = 1; i < ND; ++i) r = k == i ? v[i] : r;
  return r;
}

// dual_elem of a lossy-duals launch (float, FISTA, anisotropic, Jia-Zhao:
// the mode's scope): d is stored as bfloat16 (Args::d holds bf16 arrays).
// The old d widens exactly (__bfloat162float); b = dn + rho (dn - d_old)
// takes the unrounded float dn; dn is stored rounded to nearest even
// (__float2bfloat16_rn), as the TPU kernel's bf16 d_new
// (cytvdn_tpu/kernels/fused.py:555-566, :1230-1233). b is stored before d:
// b's value reads the old d, and the stores keep their order (the arrays
// may alias as far as the compiler knows), so the d store is not sent
// while the load of the old d at its address is in flight. The axis loop
// is rolled in 3D and unrolled in 4D, as dual_elem's (and for its
// reason); lam[k] and c[k] are picked from registers. The +1 neighbour's
// recomputed slab (HALO) is seam_b's, without a partner: the seam operand
// next_d stays float (the neighbour's d widened by the caller).
template <int ND, bool HALO>
__device__ __forceinline__ void dual_elem_lossy(const Args<float>& a,
                                                const Halos<float>& h,
                                                int64_t idx, const int64_t* c,
                                                const float* lam, float rho,
                                                double& acc) {
  const float x = a.recon[idx];
#pragma unroll (ND == 4 ? 4 : 1)
  for (int k = 0; k < ND; ++k) {
    __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(a.d[k]);
    const int64_t ck = pick<ND>(c, k);
    const float clip = pick<ND>(lam, k);
    const bool halo = HALO && h.prev[k] != nullptr;
    const float prev = halo && ck == 0
                           ? h.prev[k][slab_offset<ND>(c, a.n, k)]
                           : a.recon[bwd(idx, ck, a.n[k], a.s[k], a.bc)];
    const float diff = x - prev;
    const float dn = clip_(diff + a.b[k][idx], clip);
    const float bn = dn + rho * (dn - __bfloat162float(d[idx]));
    a.b[k][idx] = bn;
    d[idx] = __float2bfloat16_rn(dn);
    acc += static_cast<double>(abs_(bn));
    if (halo && ck == a.n[k] - 1) {
      const int64_t off = slab_offset<ND>(c, a.n, k);
      const float rn = h.next_recon[k][off];
      const float p = clip_((rn - x) + h.next_acc[k][off], clip);
      h.bhat[k][off] = p + rho * (p - h.next_d[k][off]);
    }
  }
}

// New d and b of axes K and K+1 from loaded values (recon x, its backward
// neighbours xb, b and d at the element): under `iso` the pair's joint
// projection, else each axis's clip, in dual_elem's order of operations.
template <int K, typename T, bool FISTA>
__device__ __forceinline__ void dual_pair(bool iso, T x, const T* xb,
                                          const T* bo, const T* dol,
                                          const T* lam, T rho, T* bn, T* dn) {
  if (iso) {
    // the pair shares axis K's clip radius (reference cyTVDN.py:160-162)
    const T e1 = x - xb[K] + bo[K];
    const T e2 = x - xb[K + 1] + bo[K + 1];
    const T cl = lam[K];
    const T mag = hypot_(e1, e2);
    const T scale = mag > cl ? cl / (mag > T(0) ? mag : T(1)) : T(1);
    dn[K] = e1 * scale;
    dn[K + 1] = e2 * scale;
  } else {
#pragma unroll
    for (int k = K; k < K + 2; ++k) {
      const T diff = x - xb[k];
      dn[k] = clip_(diff + bo[k], lam[k]);
    }
  }
#pragma unroll
  for (int k = K; k < K + 2; ++k)
    bn[k] = FISTA ? dn[k] + rho * (dn[k] - dol[k]) : dn[k];
}

// dual_elem of a 4D half-isotropic launch (iso_r or iso_q): every load of
// the element first (recon at the element and its four backward
// neighbours, every b and under FISTA every d), then the arithmetic of the
// pairs (0, 1) and (2, 3), then every b and then every d stored, so that
// no store is sent while a load of its address is in flight. The sums and
// the seam recomputes follow dual_elem's axis order.
template <typename T, bool FISTA, bool HALO>
__device__ __forceinline__ void dual_elem_iso(const Args<T>& a,
                                              const Halos<T>& h, int64_t idx,
                                              const int64_t* c, const T* lam,
                                              T rho, bool iso_r, bool iso_q,
                                              double& acc) {
  const T x = a.recon[idx];
  T xb[4], bo[4], dol[4], bn[4], dn[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) xb[k] = prev_recon<T, 4, HALO>(a, h, k, idx, c);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bo[k] = a.b[k][idx];
    dol[k] = FISTA ? a.d[k][idx] : T(0);
  }
  dual_pair<0, T, FISTA>(iso_r, x, xb, bo, dol, lam, rho, bn, dn);
  dual_pair<2, T, FISTA>(iso_q, x, xb, bo, dol, lam, rho, bn, dn);
#pragma unroll
  for (int k = 0; k < 4; ++k) acc += static_cast<double>(abs_(bn[k]));
#pragma unroll
  for (int k = 0; k < 4; ++k) a.b[k][idx] = bn[k];
  if (FISTA) {
#pragma unroll
    for (int k = 0; k < 4; ++k) a.d[k][idx] = dn[k];
  }
  if (HALO) {
    // each call with constant axes: a runtime partner would index c[] in
    // local memory
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (h.prev[k] == nullptr || c[k] != a.n[k] - 1) continue;
      if (k < 2 ? iso_r : iso_q) {
        seam_b<T, 4, FISTA>(a, h, k, k ^ 1, c, x, lam, rho);
      } else {
        seam_b<T, 4, FISTA>(a, h, k, -1, c, x, lam, rho);
      }
    }
  }
}

// Reconstruction update of one element, reading every b at the element and
// its forward neighbours (with HALO, along each halo axis h.bhat at a
// trailing edge, but the own last b under mirror where the block holds the
// cube's trailing edge); adds |R_new - R_old| and |R_old| to the sums and
// returns R_new.
template <typename T, int ND, bool HALO>
__device__ __forceinline__ T recon_elem(const Args<T>& a, const Halos<T>& h,
                                        int64_t idx, const int64_t* c,
                                        const T* lm, double& dnum,
                                        double& dden) {
  T div = T(0);
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    const T bk = a.b[k][idx];
    const T bf = HALO && h.prev[k] != nullptr && c[k] == a.n[k] - 1 &&
                         !(a.bc == 1 && (h.edge >> k & 1))
                     ? h.bhat[k][slab_offset<ND>(c, a.n, k)]
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
