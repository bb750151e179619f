// A whole TV-denoising run of T iterations in one persistent cooperative
// launch on a Hopper card (sm_90a), float32, all three boundary conditions,
// anisotropic duals and 4D Jia-Zhao iso pairs, FISTA with a per-iteration
// momentum ratio (0 gives the unaccelerated update, so a hybrid schedule is
// one launch) or unaccelerated, with an optional reference cube for the
// per-iteration SSE.
//
// Replaces the TPU kernel cytvdn_tpu/kernels/resident.py::resident_solve
// (entry resident.py:293, body _make_resident_kernel resident.py:133,
// pallas_call resident.py:391). The TPU kernel holds the whole state in VMEM
// for grid=(T,) steps; the H100 has no on-chip store of that size (132 x
// 227 KB of shared memory against config 1's 41.9 MB of state), so here the
// state stays in device memory, where the 50 MB L2 can hold a small cube's
// state from one iteration to the next, and the grid is persistent: every
// block lives for all T iterations, and grid barriers take the place of the
// launch boundaries between the one-iteration kernel's passes.
//
// What bounds it on the H100: at the shapes it serves (states of tens of
// MB) the two grid barriers per iteration and the latency of each work
// item's L2 loads, not HBM bytes; one launch's least time is set by its
// operations (utils/perf.py::launch_bound_seconds). The design cuts the
// number of dependent L2 round trips and of L2 requests per element:
// - A thread owns four consecutive elements along the last axis and moves
//   them with one 128-bit load or store per array (ld.global.cg.v4.f32).
// - Every load of a work item is issued before its first store, so the
//   item waits out one round of L2 latency, not one per axis.
// - Neighbours along the last axis come from the neighbouring lane
//   (__shfl_up_sync / __shfl_down_sync within a row segment of `lw` lanes);
//   only a segment's edge lane loads one scalar, which also carries the
//   wrap of periodic, mirror and Jia-Zhao at the row's ends.
// - Neighbours along axis ND-2 come from the tile's neighbouring row
//   through shared memory; the tile's edge row loads its neighbour row, as
//   does the cube's last row (its wrap). Leading axes' neighbours are loads.
//
// Layout: a block of 256 threads covers a tile of NT / lw rows of axis ND-2
// by 4 lw elements of axis ND-1, lw the least power of two (at most 32) with
// 4 lw >= the last extent, so a narrow cube still fills its lanes. Work
// items are (row, tile) pairs, the tile index fastest, the leading axes
// flattened into rows; blocks stride over them, and a block visits the same
// elements in every phase of every iteration. Where the last extent is a
// multiple of 4 and every array 16-byte aligned the loads and stores are
// 128-bit (VEC); otherwise the same walk moves the elements one by one and
// masks those past the ragged edge. Index arithmetic is 32-bit (the wrapper
// keeps the work-item count below 2^31); element offsets are 64-bit.
//
// Schedule, per iteration t:
//   dual phase    every element's b_k (and d_k), momentum rhos[t];
//   grid barrier;
//   recon phase   every element's recon, and with a reference the
//                 element's (recon_new - ref)^2; each block's four sums into
//                 its slot of `partials`;
//   grid barrier.
// Why it is race-free (the argument of the one-iteration kernel's two
// launches, with a grid barrier in place of each launch boundary):
// - The dual phase writes b and d at each element only. It reads recon (at
//   the element and its backward neighbours, directly, from a lane or from
//   shared memory), which nothing writes in that phase, and b, d at the
//   thread's own elements, which only that thread reads and writes; it
//   loads them before it stores them.
// - The recon phase writes recon at each element only. It reads b (at the
//   element and its forward neighbours), which nothing writes in that phase,
//   orig and ref, which nothing writes, and its own old recon elements,
//   which it loads before it overwrites them.
// - So a thread may issue every load of a work item before its first store:
//   no store of the phase can change what any load of the phase reads.
// - Shared memory holds one row exchange per work item, in two buffers used
//   in turns: the block barrier of item i+1 lies between item i's reads of
//   a buffer and item i+2's writes to it.
// - Each grid barrier orders one phase's stores before the next phase's
//   loads. Every load of the state goes through L2 (__ldcg): L1 is not
//   coherent across SMs and would keep values from before the barrier.
//   orig and ref take the read-only path.
// - Sums: each block reduces its four sums (sum|b|, sum|recon_new - recon|,
//   sum|recon|, SSE) in a fixed order (warp shuffles, then the warps in
//   order) into `partials` at the end of the recon phase. The last block
//   (which has no more work items than any other) reduces iteration t's
//   partials in a fixed order into the traces during its dual phase of t+1,
//   after barrier 2 of t and before barrier 1 of t+1; no block writes the
//   partials again before barrier 1 of t+1, so one set of partials and two
//   barriers per iteration suffice, and only gridDim.x x 4 doubles are
//   stored, not T x gridDim.x. The grid is fixed by the wrapper, so the
//   traces repeat exactly from run to run; they may differ from T
//   one-iteration launches in the last bit after the cast.
// The state after a launch is bitwise equal to T launches of the
// one-iteration kernel with the same momentum ratios: each element's
// arithmetic is tv_elem.cuh dual_elem's and recon_elem's, in their order,
// built with --fmad=false.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tv_elem.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NSUM = 4;
constexpr int NWARP = NT / 32;
constexpr int VW = 4;  // elements of a thread along the last axis
constexpr unsigned FULL = 0xffffffffu;

struct ResidentArgs {
  const float* rhos;  // [T] momentum ratios (FISTA)
  const float* ref;   // reference cube for the SSE trace (REF)
  double* partials;   // [NSUM][gridDim.x] per-block sums of one iteration
  float* traces;      // [NSUM][T]: sum|b|, sum|dR|, sum|R|, SSE
  int n_iters;
  int lw;             // lanes of a row segment: a power of two, 1..32
  int lw_log;         // log2(lw)
  uint32_t tiles_m;   // tiles of NT / lw rows along axis ND-2
  uint32_t tiles_l;   // tiles of VW lw elements along axis ND-1
  uint32_t work;      // rows x tiles_m x tiles_l
};

// Lanes per row segment for a last extent of L: the least power of two,
// at most 32, whose VW lanes' elements cover L.
int lanes_for(long long L) {
  int lw = 1;
  while (lw < 32 && int64_t(VW) * lw < L) lw <<= 1;
  return lw;
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

template <int ND>
__device__ __forceinline__ Item<ND> item_at(const Args<float>& a,
                                            const ResidentArgs& r, uint32_t w,
                                            int y, int xl) {
  const uint32_t per_row = r.tiles_m * r.tiles_l;
  const uint32_t row = w / per_row;
  const uint32_t t = w - row * per_row;
  const uint32_t tm = t / r.tiles_l;
  const int64_t M = a.n[ND - 2];
  const int64_t L = a.n[ND - 1];
  Item<ND> it;
  const int64_t m = int64_t(tm) * (NT >> r.lw_log) + y;
  const int64_t l = (int64_t(t - tm * r.tiles_l) * r.lw + xl) * VW;
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

// The dual phase's walk: every element's b_k (and d_k); adds each new |b_k|
// to acc, element by element in axis order.
template <int ND, bool FISTA, bool VEC>
__device__ __forceinline__ void dual_walk(const Args<float>& a,
                                          const ResidentArgs& r,
                                          const float* lam, float rho,
                                          bool iso_r, bool iso_q, int tid,
                                          float4 (*buf)[NT], double& acc) {
  const int lw = r.lw;
  const int xl = tid & (lw - 1);
  const int y = tid >> r.lw_log;
  const int64_t M = a.n[ND - 2];
  const int64_t L = a.n[ND - 1];
  int parity = 0;
  for (uint32_t w = blockIdx.x; w < r.work; w += gridDim.x) {
    const Item<ND> it = item_at<ND>(a, r, w, y, xl);
    const int n = it.n;
    // every load first
    float x[VW], xk[ND - 2][VW], xm[VW], bo[ND][VW], dol[ND][VW];
    ld4<VEC, true>(x, a.recon, it.idx, n);
#pragma unroll
    for (int k = 0; k < ND - 2; ++k) {
      ld4<VEC, true>(xk[k], a.recon,
                     bwd(it.idx, it.c[k], a.n[k], a.s[k], a.bc), n);
    }
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      ld4<VEC, true>(bo[k], a.b[k], it.idx, n);
      if (FISTA) ld4<VEC, true>(dol[k], a.d[k], it.idx, n);
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
        d1[k] = FISTA ? dol[k][j] : 0.0f;
      }
      dual_math<ND, FISTA>(x[j], xb, b1, d1, lam, rho, iso_r, iso_q, nb, nd);
#pragma unroll
      for (int k = 0; k < ND; ++k) {
        bn[k][j] = nb[k];
        dn[k][j] = nd[k];
        if (j < n) acc += static_cast<double>(abs_(nb[k]));
      }
    }
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      if (FISTA) st4<VEC>(a.d[k], it.idx, n, dn[k]);
      st4<VEC>(a.b[k], it.idx, n, bn[k]);
    }
  }
}

// The recon phase's walk: every element's recon, as tv_elem.cuh recon_elem
// in its order; adds |R_new - R_old| and |R_old| to s[1], s[2] and, with a
// reference, (R_new - ref)^2 to s[3].
template <int ND, bool REF, bool VEC>
__device__ __forceinline__ void recon_walk(const Args<float>& a,
                                           const ResidentArgs& r,
                                           const float* lm, int tid,
                                           float4 (*buf)[NT], double* s) {
  const int lw = r.lw;
  const int xl = tid & (lw - 1);
  const int y = tid >> r.lw_log;
  const int last_y = (NT >> r.lw_log) - 1;
  const int64_t M = a.n[ND - 2];
  const int64_t L = a.n[ND - 1];
  int parity = 0;
  for (uint32_t w = blockIdx.x; w < r.work; w += gridDim.x) {
    const Item<ND> it = item_at<ND>(a, r, w, y, xl);
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
    if (REF) ld4<VEC, false>(rf, r.ref, it.idx, n);
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
}

// Fixed-order sums of v[0..NS) over the block: a shuffle tree in each warp,
// then the warps in order. Thread j < NS returns total j.
template <int NS>
__device__ __forceinline__ double block_sums(const double* v, double* wsum) {
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    double x = v[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(FULL, x, o);
    if (lane == 0) wsum[j * NWARP + warp] = x;
  }
  __syncthreads();
  double total = 0.0;
  if (tid < NS) {
    for (int w = 0; w < NWARP; ++w) total += wsum[tid * NWARP + w];
  }
  return total;
}

// Iteration t's per-block partials, summed in a fixed order into the traces.
template <int NS>
__device__ __forceinline__ void reduce_traces(const ResidentArgs& r, int t,
                                              double* wsum) {
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int nb = static_cast<int>(gridDim.x);
  double v[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    v[j] = 0.0;
    for (int i = tid; i < nb; i += NT) v[j] += __ldcg(r.partials + j * nb + i);
  }
  const double total = block_sums<NS>(v, wsum);
  if (tid < NS) r.traces[int64_t(tid) * r.n_iters + t] = static_cast<float>(total);
}

template <int ND, bool FISTA, bool ISO, bool REF, bool VEC>
__device__ __forceinline__ void run(const Args<float>& a,
                                    const ResidentArgs& r, double* wsum,
                                    float4 (*buf)[NT]) {
  constexpr int NS = REF ? 4 : 3;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.y * TX + threadIdx.x;
  float lam[ND], lm[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    lam[k] = a.lambda_inv[k];
    lm[k] = a.lam_mu[k];
  }
  const bool iso_r = ISO && a.iso_r;
  const bool iso_q = ISO && a.iso_q;
  const bool reducer = blockIdx.x == gridDim.x - 1;
  for (int t = 0; t < r.n_iters; ++t) {
    const float rho = FISTA ? __ldg(r.rhos + t) : 0.0f;
    double s[NSUM] = {0.0, 0.0, 0.0, 0.0};
    dual_walk<ND, FISTA, VEC>(a, r, lam, rho, iso_r, iso_q, tid, buf, s[0]);
    if (reducer && t > 0) reduce_traces<NS>(r, t - 1, wsum);
    grid.sync();
    recon_walk<ND, REF, VEC>(a, r, lm, tid, buf, s);
    const double total = block_sums<NS>(s, wsum);
    if (tid < NS) r.partials[tid * gridDim.x + blockIdx.x] = total;
    grid.sync();
  }
  if (reducer && r.n_iters > 0) reduce_traces<NS>(r, r.n_iters - 1, wsum);
}

template <int ND, bool FISTA, bool ISO, bool REF>
__global__ void __launch_bounds__(NT) resident_kernel(Args<float> a,
                                                      ResidentArgs r,
                                                      int vec) {
  __shared__ double wsum[NSUM * NWARP];
  __shared__ float4 buf[2][NT];
  if (vec) {
    run<ND, FISTA, ISO, REF, true>(a, r, wsum, buf);
  } else {
    run<ND, FISTA, ISO, REF, false>(a, r, wsum, buf);
  }
}

template <int ND, bool FISTA, bool ISO>
const void* kernel_for_iso(int ref) {
  return ref ? reinterpret_cast<const void*>(resident_kernel<ND, FISTA, ISO, true>)
             : reinterpret_cast<const void*>(resident_kernel<ND, FISTA, ISO, false>);
}

// The instantiation for (ndim, fista, iso, ref); iso pairs exist in 4D only.
const void* kernel_for(int ndim, int fista, int iso, int ref) {
  if (ndim == 4) {
    if (iso) {
      return fista ? kernel_for_iso<4, true, true>(ref)
                   : kernel_for_iso<4, false, true>(ref);
    }
    return fista ? kernel_for_iso<4, true, false>(ref)
                 : kernel_for_iso<4, false, false>(ref);
  }
  if (ndim != 3 || iso) return nullptr;
  return fista ? kernel_for_iso<3, true, false>(ref)
               : kernel_for_iso<3, false, false>(ref);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// The largest grid a cooperative launch of the (ndim, fista, iso, ref)
// kernel may have on the current device: resident blocks per SM of that
// exact instantiation (its registers) times SMs.
extern "C" int tv_resident_max_blocks(int ndim, int fista, int iso, int ref,
                                      int* blocks) {
  const void* fn = kernel_for(ndim, fista, iso, ref);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, NT, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = per_sm * sms;
  return 0;
}

extern "C" int tv_resident_solve_f32(
    const void* orig, void* recon, void* b0, void* b1, void* b2, void* b3,
    void* d0, void* d1, void* d2, void* d3, const void* lambda_inv,
    const void* lam_mu, const void* rhos, const void* ref, void* partials,
    void* traces, int ndim, long long n0, long long n1, long long n2,
    long long n3, int fista, int bc, int iso_r, int iso_q, int n_iters,
    int nblocks, void* stream) {
  const int iso = ndim == 4 && (iso_r || iso_q);
  const void* fn = kernel_for(ndim, fista, iso, ref != nullptr);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Args<float> a{};
  a.orig = static_cast<const float*>(orig);
  a.recon = static_cast<float*>(recon);
  void* const bs[4] = {b0, b1, b2, b3};
  void* const dd[4] = {d0, d1, d2, d3};
  int vec = aligned16(orig) && aligned16(recon) && aligned16(ref);
  for (int k = 0; k < 4; ++k) {
    a.b[k] = static_cast<float*>(bs[k]);
    a.d[k] = static_cast<float*>(dd[k]);
    vec = vec && aligned16(bs[k]) && aligned16(dd[k]);
  }
  const long long n[4] = {n0, n1, n2, n3};
  set_shape(a, ndim, n);
  a.lambda_inv = static_cast<const float*>(lambda_inv);
  a.lam_mu = static_cast<const float*>(lam_mu);
  a.bc = bc;
  a.iso_r = iso_r;
  a.iso_q = iso_q;
  ResidentArgs r;
  r.rhos = static_cast<const float*>(rhos);
  r.ref = static_cast<const float*>(ref);
  r.partials = static_cast<double*>(partials);
  r.traces = static_cast<float*>(traces);
  r.n_iters = n_iters;
  const long long M = n[ndim - 2], L = n[ndim - 1];
  r.lw = lanes_for(L);
  r.lw_log = 0;
  while ((1 << r.lw_log) < r.lw) ++r.lw_log;
  const long long rows_t = NT / r.lw;
  const long long tiles = (M + rows_t - 1) / rows_t * ((L + VW * r.lw - 1) / (VW * r.lw));
  const long long work = a.rows * tiles;
  // the wrapper refuses 2^31 work items or more
  if (work >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  r.tiles_m = static_cast<uint32_t>((M + rows_t - 1) / rows_t);
  r.tiles_l = static_cast<uint32_t>((L + VW * r.lw - 1) / (VW * r.lw));
  r.work = static_cast<uint32_t>(work);
  vec = vec && L % VW == 0;

  void* args[] = {&a, &r, &vec};
  // a grid above the cooperative limit is refused here, not shrunk
  cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(nblocks), dim3(TX, TY), args, 0,
      static_cast<cudaStream_t>(stream));
  // reading the last error also clears it, so a refused launch does not
  // surface again at the next launch's check
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
