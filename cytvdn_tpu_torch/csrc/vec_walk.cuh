// The vector walk of the whole-run kernel (resident.cu) and the K-step
// kernel (temporal_kstep.cu): one work item of the dual update or of the
// reconstruction update over a tile of the two trailing axes, four
// elements per thread.
//
// What bounds such a walk on the H100 is the latency and then the
// throughput of its L2 requests (PERF.md section 6, PR 7), so it cuts the
// dependent round trips and the requests per element:
// - A thread owns four consecutive elements along the last axis and moves
//   them with one 128-bit load or store per array (ld.global.cg.v4.f32)
//   where VEC: the last extent a multiple of 4 and every array 16-byte
//   aligned (a bfloat16 d array 8-byte: one 64-bit access). Otherwise the
//   same walk moves the elements one by one and masks those past the
//   ragged edge.
// - Every load of an item is issued before its first store, so the item
//   waits out one round of L2 latency, not one per axis; b is stored before
//   d, so the store of d waits for bn, which needs d's old value, and never
//   goes out while the load of that value is in flight (such a store made
//   the pair kernel 2.6-6x slower, PERF.md section 6, PR 8).
// - Neighbours along the last axis come from the neighbouring lane
//   (__shfl_up_sync / __shfl_down_sync within a row segment of `lw`
//   lanes); only a segment's edge lane loads one scalar, which also carries
//   the wrap of periodic, mirror and Jia-Zhao at the row's ends.
// - Neighbours along axis ND-2 come from the tile's neighbouring row
//   through shared memory; the tile's edge row loads its neighbour row, as
//   does the cube's last row (its wrap). The leading axes' neighbours (in
//   the K-step kernel, axis 0, along which its wavefront walks) are loads.
//
// Layout: a block of NT threads covers a tile of NT / lw rows of axis ND-2
// by VW lw elements of axis ND-1, lw the least power of two (at most 32)
// with VW lw >= the last extent, so a narrow cube still fills its lanes.
// A work item is one (row, tile) pair, the row being the leading axes
// flattened. Every thread of the block takes part in every item (threads
// past the cube's edge move nothing), since an item has a block barrier.
//
// What a caller guarantees, and why an item is then race-free:
// - No store of the caller's phase (whole-run) or stage (K-step) writes
//   what an item loads, except the item's own elements of what it updates:
//   b and d at its elements for a dual item, recon at its elements for a
//   reconstruction item. Those are read and written by the same thread,
//   which loads them before it stores them. So every load of an item may go
//   out before its first store.
// - Shared memory holds one row exchange per item, in two buffers used in
//   turns (`parity`): the block barrier of item i+1 lies between item i's
//   reads of a buffer and item i+2's writes to it.
// - The caller's grid barriers order one phase's or stage's stores before
//   the next one's loads. Every load of the state goes through L2 (__ldcg):
//   L1 is not coherent across SMs and would keep values from before the
//   barrier. orig and the reference cube, which nothing writes, take the
//   read-only path.
// Each element's arithmetic is tv_elem.cuh dual_elem's and recon_elem's, in
// their order, built with --fmad=false, so a walk's state is bitwise that
// of the one-iteration kernel.
//
// Lossy duals (dual_item's LOSSY, FISTA only; the K-step kernel's bfloat16
// d): Args::d then holds bfloat16 arrays. A thread's four old d values
// come in one 64-bit load where VEC (the d arrays 8-byte aligned), else
// one by one, and stay packed until each widens exactly at its use; the
// arithmetic stays float, b takes the unrounded d_new, and the four d_new,
// each rounded to nearest even as it is computed, go out packed in one
// 64-bit store where VEC, still after b: tv_elem.cuh dual_elem_lossy's
// element, so a lossy walk's state is bitwise that of LOSSY K=1 launches.

#pragma once

#include <stdint.h>

#include "tv_elem.cuh"

namespace {

constexpr int VW = 4;  // elements of a thread along the last axis
constexpr unsigned FULL = 0xffffffffu;

// The walk's tiling of one cube.
struct VecTiles {
  int lw;            // lanes of a row segment: a power of two, 1..32
  int lw_log;        // log2(lw)
  uint32_t tiles_m;  // tiles of NT / lw rows along axis ND-2
  uint32_t tiles_l;  // tiles of VW lw elements along axis ND-1
};

// The tiling for trailing extents M (axis ND-2) and L (axis ND-1): lw the
// least power of two, at most 32, whose VW lanes' elements cover L.
// Returns the tiles of one row.
inline long long set_tiles(VecTiles& v, long long M, long long L) {
  v.lw = 1;
  while (v.lw < 32 && int64_t(VW) * v.lw < L) v.lw <<= 1;
  v.lw_log = 0;
  while ((1 << v.lw_log) < v.lw) ++v.lw_log;
  const long long rows_t = NT / v.lw;
  const long long tm = (M + rows_t - 1) / rows_t;
  const long long tl = (L + VW * v.lw - 1) / (VW * v.lw);
  v.tiles_m = static_cast<uint32_t>(tm);
  v.tiles_l = static_cast<uint32_t>(tl);
  return tm * tl;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

inline bool aligned8(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 7u) == 0;
}

// The four elements at p + i, the first n (0..4) of them inside the cube:
// one 128-bit load where VEC, else n scalar loads; through L2 where CG,
// else through the read-only path. Elements past n read as 0.
template <bool VEC, bool CG>
__device__ __forceinline__ void ld4(float (&v)[VW], const float* p, int64_t i,
                                    int n) {
  if (VEC) {
    float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (n > 0) {
      const float4* p4 = reinterpret_cast<const float4*>(p + i);
      q = CG ? __ldcg(p4) : __ldg(p4);
    }
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      v[j] = j < n ? (CG ? __ldcg(p + i + j) : __ldg(p + i + j)) : 0.0f;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void st4(float* p, int64_t i, int n,
                                    const float (&v)[VW]) {
  if (VEC) {
    if (n > 0) {
      *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      if (j < n) p[i + j] = v[j];
    }
  }
}

// A thread's four bfloat16 values of a d array stay packed, two to a
// 32-bit word (element j in the low half of word j / 2 where j is even,
// the high half where it is odd), from their load to their use and from
// their rounding to their store: 2 registers an axis instead of 4, for
// the 128-register cap of the 4D FISTA K-step launch.

// The bits of the four bfloat16 values at p + i (p a bfloat16 array), the
// first n of them inside the cube: one 64-bit load where VEC, else n
// scalar loads; through L2. Elements past n read as 0.
template <bool VEC>
__device__ __forceinline__ void ld4_bf16(uint32_t (&w)[2], const float* p,
                                         int64_t i, int n) {
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
  if (VEC) {
    uint2 q = make_uint2(0u, 0u);
    if (n > 0) q = __ldcg(reinterpret_cast<const uint2*>(h + i));
    w[0] = q.x;
    w[1] = q.y;
  } else {
    uint32_t e[VW];
#pragma unroll
    for (int j = 0; j < VW; ++j) e[j] = j < n ? __ldcg(h + i + j) : 0u;
    w[0] = e[0] | e[1] << 16;
    w[1] = e[2] | e[3] << 16;
  }
}

// Element j of packed bfloat16 bits, widened exactly (a bfloat16 is the
// upper half of a float's bits).
__device__ __forceinline__ float widen_bf16(const uint32_t (&w)[2], int j) {
  const uint32_t u = w[j >> 1];
  return __uint_as_float(j & 1 ? u & 0xFFFF0000u : u << 16);
}

// Packs v rounded to nearest even onto the bfloat16 grid as element j.
__device__ __forceinline__ void pack_bf16(uint32_t (&w)[2], int j, float v) {
  const uint32_t bits = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  w[j >> 1] = j & 1 ? w[j >> 1] | bits << 16 : bits;
}

// Stores the first n of four packed bfloat16 values at p + i (p a
// bfloat16 array): one 64-bit store where VEC.
template <bool VEC>
__device__ __forceinline__ void st4_bf16(float* p, int64_t i, int n,
                                         const uint32_t (&w)[2]) {
  unsigned short* h = reinterpret_cast<unsigned short*>(p);
  if (VEC) {
    if (n > 0) *reinterpret_cast<uint2*>(h + i) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      if (j < n) {
        h[i + j] = static_cast<unsigned short>(j & 1 ? w[j >> 1] >> 16
                                                     : w[j >> 1]);
      }
    }
  }
}

__device__ __forceinline__ float4 pack(const float (&v)[VW]) {
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void unpack(float (&v)[VW], float4 q) {
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// One thread's place in a work item: the offset of its first element, its
// coordinates, and how many of its four elements lie inside the cube.
template <int ND>
struct Item {
  int64_t idx;
  int64_t c[ND];
  int n;
};

// The thread (lane xl of tile row y) of tile t of row `row` (the leading
// axes flattened).
template <int ND>
__device__ __forceinline__ Item<ND> item_at(const Args<float>& a,
                                            const VecTiles& v, uint32_t row,
                                            uint32_t t, int y, int xl) {
  const uint32_t tm = t / v.tiles_l;
  const int64_t M = a.n[ND - 2];
  const int64_t L = a.n[ND - 1];
  Item<ND> it;
  const int64_t m = int64_t(tm) * (NT >> v.lw_log) + y;
  const int64_t l = (int64_t(t - tm * v.tiles_l) * v.lw + xl) * VW;
  if (ND == 4) {
    const uint32_t n1 = static_cast<uint32_t>(a.n[1]);
    const uint32_t c0 = row / n1;
    it.c[0] = c0;
    it.c[1] = row - c0 * n1;
  } else {
    it.c[0] = row;
  }
  it.c[ND - 2] = m;
  it.c[ND - 1] = l;
  it.idx = (int64_t(row) * M + m) * L + l;
  const int64_t left = L - l;
  it.n = m < M ? static_cast<int>(left < 0 ? 0 : left > VW ? VW : left) : 0;
  return it;
}

// Dual update of one element from its loaded values (recon x, recon at the
// backward neighbour of every axis xb, b and d at the element): the
// arithmetic of tv_elem.cuh dual_elem, in its order.
template <int ND, bool FISTA>
__device__ __forceinline__ void dual_math(float x, const float* xb,
                                          const float* bo, const float* dol,
                                          const float* lam, float rho,
                                          bool iso_r, bool iso_q, float* bn,
                                          float* dn) {
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    if ((k == 1 && iso_r) || (k == 3 && iso_q)) continue;  // done with k-1
    if ((k == 0 && iso_r) || (k == 2 && iso_q)) {
      // the pair shares axis k's clip radius (reference cyTVDN.py:160-162)
      const float e1 = x - xb[k] + bo[k];
      const float e2 = x - xb[k + 1] + bo[k + 1];
      const float cl = lam[k];
      const float mag = hypot_(e1, e2);
      const float scale = mag > cl ? cl / (mag > 0.0f ? mag : 1.0f) : 1.0f;
      dn[k] = e1 * scale;
      dn[k + 1] = e2 * scale;
      bn[k] = dn[k];
      bn[k + 1] = dn[k + 1];
      if (FISTA) {
        bn[k] = dn[k] + rho * (dn[k] - dol[k]);
        bn[k + 1] = dn[k + 1] + rho * (dn[k + 1] - dol[k + 1]);
      }
    } else {
      const float diff = x - xb[k];
      dn[k] = clip_(diff + bo[k], lam[k]);
      bn[k] = dn[k];
      if (FISTA) bn[k] = dn[k] + rho * (dn[k] - dol[k]);
    }
  }
}

// One dual work item: the thread's elements' b_k (and d_k); adds each new
// |b_k| to acc, element by element in axis order. LOSSY (FISTA only): the
// d arrays are bfloat16, loaded widened and stored rounded.
template <int ND, bool FISTA, bool VEC, bool LOSSY = false>
__device__ __forceinline__ void dual_item(const Args<float>& a,
                                          const Item<ND>& it, int lw, int xl,
                                          int y, int tid, const float* lam,
                                          float rho, bool iso_r, bool iso_q,
                                          float4 (*buf)[NT], int& parity,
                                          double& acc) {
  static_assert(!LOSSY || FISTA, "lossy duals: FISTA only");
  const int64_t M = a.n[ND - 2];
  const int64_t L = a.n[ND - 1];
  const int n = it.n;
  // every load first
  float x[VW], xk[ND - 2][VW], xm[VW], bo[ND][VW], dol[ND][VW];
  uint32_t dq[ND][2];  // LOSSY: the old d, packed bfloat16
  ld4<VEC, true>(x, a.recon, it.idx, n);
#pragma unroll
  for (int k = 0; k < ND - 2; ++k) {
    ld4<VEC, true>(xk[k], a.recon,
                   bwd(it.idx, it.c[k], a.n[k], a.s[k], a.bc), n);
  }
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    ld4<VEC, true>(bo[k], a.b[k], it.idx, n);
    if (LOSSY) {
      ld4_bf16<VEC>(dq[k], a.d[k], it.idx, n);
    } else if (FISTA) {
      ld4<VEC, true>(dol[k], a.d[k], it.idx, n);
    }
  }
  // the tile's first row: its backward row along axis ND-2 (or the wrap)
  ld4<VEC, true>(xm, a.recon,
                 bwd(it.idx, it.c[ND - 2], M, a.s[ND - 2], a.bc),
                 y == 0 ? n : 0);
  // a segment's first lane: the element before its first (or the wrap)
  const float edge = xl == 0 && n > 0
      ? __ldcg(a.recon + bwd(it.idx, it.c[ND - 1], L, 1, a.bc)) : 0.0f;
  // neighbours from the lane below and the row above
  const float up = __shfl_up_sync(FULL, x[VW - 1], 1, lw);
  buf[parity][tid] = pack(x);
  __syncthreads();
  if (y > 0) unpack(xm, buf[parity][tid - lw]);
  parity ^= 1;
  float bn[ND][VW], dn[ND][VW];
  uint32_t dqn[ND][2];  // LOSSY: the new d, rounded and packed
#pragma unroll
  for (int j = 0; j < VW; ++j) {
    float xb[ND], b1[ND], d1[ND], nb[ND], nd[ND];
#pragma unroll
    for (int k = 0; k < ND - 2; ++k) xb[k] = xk[k][j];
    xb[ND - 2] = xm[j];
    xb[ND - 1] = j > 0 ? x[j - 1] : (xl > 0 ? up : edge);
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      b1[k] = bo[k][j];
      d1[k] = LOSSY ? widen_bf16(dq[k], j) : FISTA ? dol[k][j] : 0.0f;
    }
    dual_math<ND, FISTA>(x[j], xb, b1, d1, lam, rho, iso_r, iso_q, nb, nd);
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      bn[k][j] = nb[k];
      dn[k][j] = nd[k];
      if (LOSSY) pack_bf16(dqn[k], j, nd[k]);
      if (j < n) acc += static_cast<double>(abs_(nb[k]));
    }
  }
  // b before d
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    st4<VEC>(a.b[k], it.idx, n, bn[k]);
    if (LOSSY) {
      st4_bf16<VEC>(a.d[k], it.idx, n, dqn[k]);
    } else if (FISTA) {
      st4<VEC>(a.d[k], it.idx, n, dn[k]);
    }
  }
}

// One reconstruction work item: the thread's elements' recon, as
// tv_elem.cuh recon_elem in its order; adds |R_new - R_old| and |R_old| to
// s[1], s[2] and, with a reference cube `ref` (REF), (R_new - ref)^2 to
// s[3].
template <int ND, bool REF, bool VEC>
__device__ __forceinline__ void recon_item(const Args<float>& a,
                                           const Item<ND>& it, int lw, int xl,
                                           int y, int last_y, int tid,
                                           const float* lm, const float* ref,
                                           float4 (*buf)[NT], int& parity,
                                           double* s) {
  const int64_t M = a.n[ND - 2];
  const int64_t L = a.n[ND - 1];
  const int n = it.n;
  // every load first
  float bo[ND][VW], bf[ND - 2][VW], bm[VW], o[VW], ro[VW], rf[VW];
#pragma unroll
  for (int k = 0; k < ND; ++k) ld4<VEC, true>(bo[k], a.b[k], it.idx, n);
#pragma unroll
  for (int k = 0; k < ND - 2; ++k) {
    ld4<VEC, true>(bf[k], a.b[k],
                   fwd(it.idx, it.c[k], a.n[k], a.s[k], a.bc), n);
  }
  // the tile's last row and the cube's last row: the forward row along
  // axis ND-2 (or the wrap)
  const bool m_edge = y == last_y || it.c[ND - 2] >= M - 1;
  ld4<VEC, true>(bm, a.b[ND - 2],
                 fwd(it.idx, it.c[ND - 2], M, a.s[ND - 2], a.bc),
                 m_edge ? n : 0);
  ld4<VEC, false>(o, a.orig, it.idx, n);
  ld4<VEC, true>(ro, a.recon, it.idx, n);
  if (REF) ld4<VEC, false>(rf, ref, it.idx, n);
  // the element at the row's end takes the wrap; a segment's last lane,
  // short of the row's end, the element after its last
  const int64_t jl = L - 1 - it.c[ND - 1];
  float edge = 0.0f;
  if (n > 0 && jl < VW) {
    edge = __ldcg(a.b[ND - 1] + fwd(it.idx + jl, L - 1, L, 1, a.bc));
  } else if (n > 0 && xl == lw - 1) {
    edge = __ldcg(a.b[ND - 1] + it.idx + VW);
  }
  // neighbours from the lane above and the row below
  const float down = __shfl_down_sync(FULL, bo[ND - 1][0], 1, lw);
  buf[parity][tid] = pack(bo[ND - 2]);
  __syncthreads();
  if (!m_edge) unpack(bm, buf[parity][tid + lw]);
  parity ^= 1;
  float rn[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) {
    const float bl = j == jl ? edge
                     : j < VW - 1 ? bo[ND - 1][j + 1]
                     : xl < lw - 1 ? down : edge;
    float div = 0.0f;
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      const float f = k < ND - 2 ? bf[k < ND - 2 ? k : 0][j]
                      : k == ND - 2 ? bm[j] : bl;
      div = div + lm[k] * (bo[k][j] - f);
    }
    rn[j] = o[j] - div;
    if (j < n) {
      s[1] += static_cast<double>(abs_(rn[j] - ro[j]));
      s[2] += static_cast<double>(abs_(ro[j]));
      if (REF) {
        const float e = rn[j] - rf[j];
        s[3] += static_cast<double>(e * e);
      }
    }
  }
  st4<VEC>(a.recon, it.idx, n, rn);
}

}  // namespace
