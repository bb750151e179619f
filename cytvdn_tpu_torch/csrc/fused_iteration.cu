// One TV-denoising iteration on a Hopper card (sm_90a), float and double.
//
// Replaces the TPU kernel cytvdn_tpu/kernels/fused.py::fused_iteration
// (entry fused.py:872, body _make_kernel fused.py:300, pallas_call
// fused.py:1239). What it computes, for each axis k (or jointly for a
// half-isotropic pair):
//   d_k = clip(recon - S_k^- recon + b_k, +-lambda_inv_k)
//   b_k = d_k + rho (d_k - d_k_old)            (FISTA; else b_k = d_k)
//   recon = orig - sum_k lam_mu_k (b_k - S_k^+ b_k)
// and the sums sum|b|, sum|recon_new - recon| and sum|recon|.
//
// What bounds it on the H100: HBM bytes. The arithmetic is a few flops per
// element against 4n+3 (FISTA) cube-size reads and writes per iteration.
//
// Design:
// - Two launches per iteration, both in place and race-free. On the TPU
//   the grid runs in order and the kernel pre-gathers seam columns; here
//   blocks run concurrently, so a single in-place pass would let one tile
//   overwrite recon or b where a neighbour tile still has to read them.
//   (a) the dual pass writes every axis's b and d at each element and
//       reads only the old recon, which no block writes in this launch;
//   (b) the recon pass reads the new b (read-only by then) and reads and
//       writes recon at the same element only.
//   Double-buffering the state instead would not fit: the 256^2 x 128^2
//   FISTA state is 10 arrays of 4.29 GB. The price is 5n+4 traversals per
//   FISTA iteration (24 in 4D) against 4n+3 (19) for one pass: at 3.35
//   TB/s the two-pass floor is 30.8 ms at 256^2 x 128^2 FISTA against
//   24.4 ms. One in-place pass would need a wavefront over whole rows or
//   L2-sized strips, with a barrier per stage; the pair kernel's strip
//   sweep showed that such a wavefront does not pay on this card
//   (temporal_pair.cu, PERF.md section 6), so the passes stay two.
// - The float32 launches take the vector walk (dualwalk_kernel,
//   reconwalk_kernel; the items of vec_walk.cuh) without halos, and with
//   Jia-Zhao anisotropic halos on axes 0 and 1 (below): four
//   elements of the last axis per thread, moved with one 128-bit access
//   per array (64-bit for a bfloat16 d) through L2, or one by one where
//   the last extent or an array's alignment does not allow it; every load
//   of an item before its first store, b stored before d; neighbours along
//   the last axis from lanes, along axis ND-2 from shared memory. The
//   dual pass stores b and d evict-first (vec_walk.cuh dual_item_cs), so
//   that the recon lines the next items read again stay in L2. The
//   scalar passes below (one element per thread, each axis loaded,
//   computed and stored before the next) measured 2.0-2.2 TB/s at
//   256^2 x 128^2 on an H100 (80GB HBM3, 700 W; PERF.md section 6), the
//   walk 2.77-2.82.
// - The walk's item order keeps an element's axis-0 and axis-1
//   neighbours in L2 between their two reads (recon at i-1 in the dual
//   pass, b at i+1 in the recon pass): the cube is walked tile by tile,
//   and in each tile the rows go in bands of `band` axis-1 indices, each
//   band along axis 0 with its axis-1 indices fastest (walk_item). Each
//   pass's grid (the wrapper's) is no larger than the blocks that fit on
//   the card at once, each striding over the items, so the items in
//   flight are one contiguous window of that order (a larger grid runs in
//   batches of resident blocks, each batch far apart in it). The passes
//   have grids of their own, so their partial sums are summed by
//   walkfin_kernel.
// - Bitwise equality with the plain PyTorch ops (cytvdn_tpu_torch/ops):
//   the same order of operations, no FMA contraction (built with
//   --fmad=false), fminf(fmaxf(x, -c), c) for the clip, hypot for the iso
//   magnitude with the mag=0 guard.
// - Boundaries by index: Jia-Zhao's backward edge reads its own element,
//   its forward wrap reads b at index 0 (kept zero by the JZ invariant,
//   read rather than assumed); periodic wraps; the corrected mirror reads
//   a_1 backward and its own b_{N-1} forward.
// - Sums: per-block partials in double, reduced in a fixed order by
//   finalize_kernel and cast to the data type. No atomics, so the traces
//   are the same from run to run.
// - 64-bit element offsets (the 256^2 x 128^2 cube has 1.07e9 elements).
// - Scalars (lambda_inv, lam_mu, rho) are read through device pointers, so
//   the host never waits for the momentum schedule or a restart.
// - Seams (the HALO instantiations: out-of-core slabs and mesh shards):
//   the TPU kernel recomputes the +1 neighbour's first updated b slab at a
//   trailing edge from halo operands. Here the dual pass reads only the old
//   recon, so the threads at a halo axis's last index (the block's last row
//   along axis 0, its last column, and on meshes that split axes 2 or 3
//   the threads at that axis's last index, whatever tile they are in) also
//   compute that slab and store it into a one-slab scratch buffer
//   (tv_elem.cuh Halos::bhat). The walk's HALO items do the same for
//   halos on axes 0 and 1 (Jia-Zhao, anisotropic: every out-of-core slab,
//   axis-0, axis-1 and 2D-grid mesh shards): an item at a leading edge
//   loads the -1 neighbour's slab in place of recon at i-1, one at a
//   trailing edge also loads the +1 neighbour's first recon, accumulator
//   and shadow-dual slabs with its other loads and stores the recomputed
//   slab after its b and d (vec_walk.cuh dual_item_cs, ld4_prev,
//   ld4_next). In 4D both axes are row axes, the same for every thread of
//   an item; in 3D axis 1 is the tiled axis, whose seams are a tile row's.
//   The recon pass reads the scratch slab in place of the
//   Jia-Zhao b_0 wrap, which is only right while b_0 is zero, as it is not
//   in an interior block, and in place of the periodic wrap, whose b_0 is
//   another shard's. For a split half-isotropic axis the recompute is the
//   pair's joint projection (hypot and the mag=0 guard in dual_elem's
//   order), from the neighbour's partner accumulator and, at the partner's
//   leading index, the diagonal neighbour's corner. Mirror boundaries: the
//   leading edge reads the halo (the own slab 1 at the cube's edge), the
//   trailing edge the own updated b_{N-1} where the block holds the cube's
//   edge (Halos::edge, set per shard by the caller), else bhat. The
//   leading edges read the halo's prev slab in the dual pass. The sums
//   cover the block's own elements. HALO is a template flag, so the
//   no-halo instantiations are the code they were.
//
// The scalar passes (dual_kernel, recon_kernel: one element per thread)
// run the double launches and the float ones with halos on axes 2 or 3,
// periodic or mirror boundaries or iso pairs:
//
// - Half-isotropic launches (ISO, a template flag of the dual pass, 4D
//   only, picked where iso_r or iso_q is set): each element issues every
//   load first (recon at the element and its four backward neighbours,
//   every b, under FISTA every d), then does the pairs' arithmetic, then
//   stores every b and then every d (tv_elem.cuh dual_elem_iso), as the
//   whole-run walk does (vec_walk.cuh dual_item). With the pair choice at
//   run time inside the axis loop, the iso branch's d stores, whose values
//   do not depend on the old d, were sent while the loads of that d were
//   in flight, and each pair's loads waited for the previous axes'
//   stores: on an H100 (80GB HBM3, 700 W) 164.7 ms at (128,256,128,128)
//   FISTA against 23.2 ms anisotropic; loads first, 22.8 ms (PERF.md
//   section 6). The
//   other instantiations keep the runtime branch and are the code they
//   were.
//
// - Lossy duals (LOSSY, a template flag of the dual pass, picked by the
//   caller's lossy argument; float FISTA Jia-Zhao anisotropic launches
//   with halos, the mode's scope): d is stored as bfloat16, as the TPU
//   kernel stores it under lossy_duals (fused.py:555-566, :1230-1233).
//   Loads widen exactly,
//   stores round to nearest even, the arithmetic stays float
//   (tv_elem.cuh dual_elem_lossy). Each axis stores b before d, so that
//   the 2-byte d store is not sent while the load of the old d at its
//   address is in flight. The recon pass and finalize_kernel never read d
//   and are shared with the exact launches; the HALO seam operand next_d
//   stays float. LOSSY is a template flag, so the exact instantiations are
//   the code they were.
//
// Layout, boundary offsets and the element arithmetic live in tv_elem.cuh,
// shared with the whole-run kernel (resident.cu); the walk's items in
// vec_walk.cuh, shared with the whole-run and K-step kernels. The double
// launches and the other HALO launches keep the scalar passes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tv_elem.cuh"
#include "vec_walk.cuh"

namespace {

template <typename T, int ND, bool FISTA, bool HALO, bool ISO, bool LOSSY>
__global__ void __launch_bounds__(NT) dual_kernel(Args<T> a, Halos<T> h) {
  static_assert(!ISO || ND == 4, "half-isotropic pairs are 4D");
  static_assert(!LOSSY || (std::is_same<T, float>::value && FISTA && !ISO),
                "lossy duals: float, FISTA, anisotropic");
  __shared__ double red[NT];
  T lam[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) lam[k] = a.lambda_inv[k];
  const T rho = FISTA ? *a.rho : T(0);
  const bool iso_r = ND == 4 && a.iso_r;
  const bool iso_q = ND == 4 && a.iso_q;
  double acc = 0.0;
  for_each_element<ND>(a, [&](int64_t idx, const int64_t* c) {
    if constexpr (LOSSY) {
      dual_elem_lossy<ND, HALO>(a, h, idx, c, lam, rho, acc);
    } else if constexpr (ISO) {
      dual_elem_iso<T, FISTA, HALO>(a, h, idx, c, lam, rho, iso_r, iso_q,
                                    acc);
    } else {
      dual_elem<T, ND, FISTA, HALO>(a, h, idx, c, lam, rho, iso_r, iso_q,
                                    acc);
    }
  });
  const double total = block_sum(acc, red);
  if (threadIdx.x == 0 && threadIdx.y == 0) a.partials[blockIdx.x] = total;
}

template <typename T, int ND, bool HALO>
__global__ void __launch_bounds__(NT) recon_kernel(Args<T> a, Halos<T> h) {
  __shared__ double red[NT];
  T lm[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) lm[k] = a.lam_mu[k];
  double dnum = 0.0, dden = 0.0;
  for_each_element<ND>(a, [&](int64_t idx, const int64_t* c) {
    recon_elem<T, ND, HALO>(a, h, idx, c, lm, dnum, dden);
  });
  const double t1 = block_sum(dnum, red);
  const double t2 = block_sum(dden, red);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    a.partials[gridDim.x + blockIdx.x] = t1;
    a.partials[2 * gridDim.x + blockIdx.x] = t2;
  }
}

// One block: each of the three rows of partials summed in a fixed order.
template <typename T>
__global__ void __launch_bounds__(NT) finalize_kernel(const double* partials,
                                                      int nblocks, T* out) {
  __shared__ double red[NT];
  const int t = threadIdx.y * TX + threadIdx.x;
  for (int j = 0; j < 3; ++j) {
    double v = 0.0;
    for (int i = t; i < nblocks; i += NT) v += partials[(int64_t)j * nblocks + i];
    const double total = block_sum(v, red);
    if (t == 0) out[j] = static_cast<T>(total);
  }
}

// The vector walk's tiling and item order (float launches).
struct WalkArgs {
  VecTiles v;         // the walk's tiling (vec_walk.cuh)
  uint32_t rows;      // the leading axes flattened: N0 x r1
  uint32_t n0;        // N0
  uint32_t r1;        // rows per axis-0 index (4D: N1; 3D: 1)
  uint32_t band;      // rows per axis-0 index of a band, 1 .. r1
  uint32_t work;      // rows x tiles of one row
  uint32_t dual_blocks;  // the dual pass's grid: its partials come first
};

// Work item w as (row, tile): tile by tile, and in each tile the rows in
// bands of `band` consecutive axis-1 indices (4D), each band walked along
// axis 0 with its axis-1 indices fastest (the last band ragged). An
// element's axis-0 neighbour is `band` items away, its axis-1 neighbour
// one (or a band's N0 x band items at a band's edge).
__device__ __forceinline__ void walk_item(const WalkArgs& r, uint32_t w,
                                          uint32_t& row, uint32_t& t) {
  t = w / r.rows;
  const uint32_t j = w - t * r.rows;
  const uint32_t span = r.band * r.n0;
  const uint32_t bi = j / span;
  const uint32_t first = bi * r.band;
  const uint32_t left = r.r1 - first;
  const uint32_t width = left < r.band ? left : r.band;
  const uint32_t k = j - bi * span;
  const uint32_t c0 = k / width;
  row = c0 * r.r1 + first + (k - c0 * width);
}

template <int ND, bool FISTA, bool LOSSY, bool VEC, bool HALO>
__device__ __forceinline__ void dual_walk(const Args<float>& a,
                                          const WalkArgs& r, const float* lam,
                                          float rho, bool iso_r, bool iso_q,
                                          float4 (*buf)[NT], double& acc,
                                          const Halos<float>* h) {
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int lw = r.v.lw;
  const int xl = tid & (lw - 1);
  const int y = tid >> r.v.lw_log;
  int parity = 0;
  for (uint32_t w = blockIdx.x; w < r.work; w += gridDim.x) {
    uint32_t row, t;
    walk_item(r, w, row, t);
    const Item<ND> it = item_at<ND>(a, r.v, row, t, y, xl);
    dual_item_cs<ND, FISTA, VEC, LOSSY, HALO>(a, it, lw, xl, y, tid, lam,
                                              rho, iso_r, iso_q, buf, parity,
                                              acc, h);
  }
}

template <int ND, bool VEC, bool HALO>
__device__ __forceinline__ void recon_walk(const Args<float>& a,
                                           const WalkArgs& r, const float* lm,
                                           float4 (*buf)[NT], double* s,
                                           const Halos<float>* h) {
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int lw = r.v.lw;
  const int xl = tid & (lw - 1);
  const int y = tid >> r.v.lw_log;
  const int last_y = (NT >> r.v.lw_log) - 1;
  int parity = 0;
  for (uint32_t w = blockIdx.x; w < r.work; w += gridDim.x) {
    uint32_t row, t;
    walk_item(r, w, row, t);
    const Item<ND> it = item_at<ND>(a, r.v, row, t, y, xl);
    recon_item<ND, false, VEC, HALO>(a, it, lw, xl, y, last_y, tid, lm,
                                     nullptr, buf, parity, s, h);
  }
}

// The dual pass of a float launch as the vector walk: ISO where a 4D
// launch has a half-isotropic pair, LOSSY where d is bfloat16, HALO where
// the launch has seams on axes 0 and 1 (Jia-Zhao, anisotropic; h, which
// the other instantiations take and ignore, so that they are the code
// they were). vec: every array and seam slab aligned for the 128-bit
// (bfloat16 d: 64-bit) accesses and the last extent a multiple of 4. Told that one block per SM will
// do, the compiler gives the 4D FISTA pass 168 registers (one block per
// SM), and the launch at 256^2 x 128^2 took 37.3 ms on an H100 (80GB
// HBM3, 700 W) against 38.4 with its own budget of 80 (two per SM;
// tools/torch_walk_variants.py, PERF.md section 6).
template <int ND, bool FISTA, bool ISO, bool LOSSY, bool HALO = false>
__global__ void __launch_bounds__(NT, 1)
    dualwalk_kernel(Args<float> a, WalkArgs r, int vec, Halos<float> h) {
  static_assert(!ISO || ND == 4, "half-isotropic pairs are 4D");
  static_assert(!LOSSY || (FISTA && !ISO), "lossy duals: FISTA, anisotropic");
  static_assert(!HALO || !ISO, "walk seams: anisotropic");
  __shared__ double red[NT];
  __shared__ float4 buf[2][NT];
  float lam[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) lam[k] = a.lambda_inv[k];
  const float rho = FISTA ? *a.rho : 0.0f;
  const bool iso_r = ISO && a.iso_r;
  const bool iso_q = ISO && a.iso_q;
  double acc = 0.0;
  if (vec) {
    dual_walk<ND, FISTA, LOSSY, true, HALO>(a, r, lam, rho, iso_r, iso_q, buf,
                                            acc, &h);
  } else {
    dual_walk<ND, FISTA, LOSSY, false, HALO>(a, r, lam, rho, iso_r, iso_q,
                                             buf, acc, &h);
  }
  const double total = block_sum(acc, red);
  if (threadIdx.x == 0 && threadIdx.y == 0) a.partials[blockIdx.x] = total;
}

// The recon pass of a float launch as the vector walk (HALO: seams on
// axes 0 and 1).
template <int ND, bool HALO = false>
__global__ void __launch_bounds__(NT) reconwalk_kernel(Args<float> a,
                                                       WalkArgs r, int vec,
                                                       Halos<float> h) {
  __shared__ double red[NT];
  __shared__ float4 buf[2][NT];
  float lm[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) lm[k] = a.lam_mu[k];
  double s[4] = {0.0, 0.0, 0.0, 0.0};
  if (vec) {
    recon_walk<ND, true, HALO>(a, r, lm, buf, s, &h);
  } else {
    recon_walk<ND, false, HALO>(a, r, lm, buf, s, &h);
  }
  const double t1 = block_sum(s[1], red);
  const double t2 = block_sum(s[2], red);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    a.partials[r.dual_blocks + blockIdx.x] = t1;
    a.partials[r.dual_blocks + gridDim.x + blockIdx.x] = t2;
  }
}

// One block: the walk's partials (the dual pass's nd, then two rows of
// the recon pass's nr) summed row by row in a fixed order.
__global__ void __launch_bounds__(NT) walkfin_kernel(const double* partials,
                                                     int nd, int nr,
                                                     float* out) {
  __shared__ double red[NT];
  const int t = threadIdx.y * TX + threadIdx.x;
  for (int j = 0; j < 3; ++j) {
    const int n = j == 0 ? nd : nr;
    const double* p = partials + (j == 0 ? 0 : nd + (j - 1) * nr);
    double v = 0.0;
    for (int i = t; i < n; i += NT) v += p[i];
    const double total = block_sum(v, red);
    if (t == 0) out[j] = static_cast<float>(total);
  }
}

template <int ND, bool FISTA>
const void* dualwalk_for(int iso, int lossy, int halo) {
  if constexpr (FISTA) {
    if (lossy && halo) return reinterpret_cast<const void*>(
        dualwalk_kernel<ND, true, false, true, true>);
    if (lossy) return reinterpret_cast<const void*>(
        dualwalk_kernel<ND, true, false, true>);
  }
  if (halo) return reinterpret_cast<const void*>(
      dualwalk_kernel<ND, FISTA, false, false, true>);
  if constexpr (ND == 4) {
    if (iso) return reinterpret_cast<const void*>(
        dualwalk_kernel<4, FISTA, true, false>);
  }
  return reinterpret_cast<const void*>(
      dualwalk_kernel<ND, FISTA, false, false>);
}

// The walk's dual pass for (ndim, fista, iso, lossy, halo) and its recon
// pass; null where there is none (iso in 3D or with halos, lossy without
// FISTA or with iso).
void walk_kernels(int ndim, int fista, int iso, int lossy, int halo,
                  const void** dual, const void** recon) {
  *dual = *recon = nullptr;
  if ((ndim != 3 && ndim != 4) || (iso && (ndim != 4 || halo)) ||
      (lossy && (!fista || iso)))
    return;
  if (ndim == 4) {
    *dual = fista ? dualwalk_for<4, true>(iso, lossy, halo)
                  : dualwalk_for<4, false>(iso, lossy, halo);
    *recon = halo ? reinterpret_cast<const void*>(reconwalk_kernel<4, true>)
                  : reinterpret_cast<const void*>(reconwalk_kernel<4>);
  } else {
    *dual = fista ? dualwalk_for<3, true>(iso, lossy, halo)
                  : dualwalk_for<3, false>(iso, lossy, halo);
    *recon = halo ? reinterpret_cast<const void*>(reconwalk_kernel<3, true>)
                  : reinterpret_cast<const void*>(reconwalk_kernel<3>);
  }
}

// The dual pass: the LOSSY instantiation where a float FISTA launch stores
// d as bfloat16, the ISO instantiation where a 4D launch has a
// half-isotropic pair.
template <typename T, int ND, bool FISTA, bool HALO>
void launch_dual(const Args<T>& a, const Halos<T>& h, bool lossy, dim3 grid,
                 dim3 block, cudaStream_t stream) {
  if constexpr (FISTA && std::is_same<T, float>::value) {
    if (lossy) {
      dual_kernel<T, ND, FISTA, HALO, false, true>
          <<<grid, block, 0, stream>>>(a, h);
      return;
    }
  }
  if (ND == 4 && (a.iso_r || a.iso_q)) {
    dual_kernel<T, ND, FISTA, HALO, ND == 4, false>
        <<<grid, block, 0, stream>>>(a, h);
  } else {
    dual_kernel<T, ND, FISTA, HALO, false, false>
        <<<grid, block, 0, stream>>>(a, h);
  }
}

// The dual and recon passes of one instantiation of the seams.
template <typename T, bool HALO>
cudaError_t launch_passes(const Args<T>& a, const Halos<T>& h, int ndim,
                          int fista, bool lossy, dim3 grid, dim3 block,
                          cudaStream_t stream) {
  if (ndim == 4 && fista) {
    launch_dual<T, 4, true, HALO>(a, h, lossy, grid, block, stream);
  } else if (ndim == 4) {
    launch_dual<T, 4, false, HALO>(a, h, lossy, grid, block, stream);
  } else if (fista) {
    launch_dual<T, 3, true, HALO>(a, h, lossy, grid, block, stream);
  } else {
    launch_dual<T, 3, false, HALO>(a, h, lossy, grid, block, stream);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (ndim == 4) {
    recon_kernel<T, 4, HALO><<<grid, block, 0, stream>>>(a, h);
  } else {
    recon_kernel<T, 3, HALO><<<grid, block, 0, stream>>>(a, h);
  }
  return cudaGetLastError();
}

// The scalar passes: double launches, and float launches with halos that
// the walk does not take (axes 2 and 3, periodic, mirror, iso).
// halo: null for a whole cube, else the 28 seam pointers of Halos in the
// order prev, next_recon, next_acc, next_d, next_accp, corner, bhat, each
// for axes 0 to 3 (null: no halos on that axis, or no such operand);
// edge: Halos::edge; lossy: the d arrays are bfloat16 (float FISTA
// Jia-Zhao anisotropic launches only; the seam operand next_d stays T).
template <typename T>
int launch(const void* orig, void* recon, void* const b[4], void* const d[4],
           const void* lambda_inv, const void* lam_mu, const void* rho,
           void* partials, void* out, void* const* halo, int edge, int ndim,
           const long long n[4], int fista, int bc, int iso_r, int iso_q,
           int lossy, int nblocks, cudaStream_t stream) {
  if (lossy && (!std::is_same<T, float>::value || !fista || iso_r || iso_q ||
                bc != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  Args<T> a;
  a.orig = static_cast<const T*>(orig);
  a.recon = static_cast<T*>(recon);
  for (int k = 0; k < 4; ++k) {
    a.b[k] = static_cast<T*>(b[k]);
    a.d[k] = static_cast<T*>(d[k]);
  }
  set_shape(a, ndim, n);
  a.lambda_inv = static_cast<const T*>(lambda_inv);
  a.lam_mu = static_cast<const T*>(lam_mu);
  a.rho = static_cast<const T*>(rho);
  a.partials = static_cast<double*>(partials);
  a.out = static_cast<T*>(out);
  a.bc = bc;
  a.iso_r = iso_r;
  a.iso_q = iso_q;
  Halos<T> h{};
  const bool with_halo = halo != nullptr;
  if (with_halo) {
    for (int A = 0; A < 4; ++A) {
      h.prev[A] = static_cast<const T*>(halo[A]);
      h.next_recon[A] = static_cast<const T*>(halo[4 + A]);
      h.next_acc[A] = static_cast<const T*>(halo[8 + A]);
      h.next_d[A] = static_cast<const T*>(halo[12 + A]);
      h.next_accp[A] = static_cast<const T*>(halo[16 + A]);
      h.corner[A] = static_cast<const T*>(halo[20 + A]);
      h.bhat[A] = static_cast<T*>(halo[24 + A]);
    }
    h.edge = edge;
  }

  const dim3 block(TX, TY);
  const dim3 grid(nblocks);
  cudaError_t err;
  if (with_halo) {
    err = launch_passes<T, true>(a, h, ndim, fista, lossy, grid, block,
                                 stream);
  } else {
    if constexpr (std::is_same<T, float>::value) {
      // float launches without halos take the vector walk
      // (tv_fused_walk_f32)
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      err = launch_passes<T, false>(a, h, ndim, fista, lossy, grid, block,
                                    stream);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  finalize_kernel<T><<<1, block, 0, stream>>>(a.partials, nblocks, a.out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define TV_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const void* orig, void* recon, void* b0, void* b1,     \
                      void* b2, void* b3, void* d0, void* d1, void* d2,      \
                      void* d3, const void* lambda_inv, const void* lam_mu,  \
                      const void* rho, void* partials, void* out,            \
                      void* const* halo, int edge, int ndim, long long n0,   \
                      long long n1, long long n2, long long n3, int fista,   \
                      int bc, int iso_r, int iso_q, int lossy,               \
                      int nblocks, void* stream) {                           \
    void* const b[4] = {b0, b1, b2, b3};                                     \
    void* const d[4] = {d0, d1, d2, d3};                                     \
    const long long n[4] = {n0, n1, n2, n3};                                 \
    return launch<T>(orig, recon, b, d, lambda_inv, lam_mu, rho, partials,   \
                     out, halo, edge, ndim, n, fista, bc, iso_r, iso_q,      \
                     lossy, nblocks, static_cast<cudaStream_t>(stream));     \
  }

TV_ENTRY(tv_fused_iteration_f32, float)
TV_ENTRY(tv_fused_iteration_f64, double)

// The resident blocks per SM of the walk's two passes for (ndim, fista,
// iso, lossy, halo) on the current device (their registers and shared
// memory), and its SMs.
extern "C" int tv_walk_occupancy(int ndim, int fista, int iso, int lossy,
                                 int halo, int* dual_per_sm,
                                 int* recon_per_sm, int* sms) {
  const void* fns[2];
  walk_kernels(ndim, fista, iso, lossy, halo, &fns[0], &fns[1]);
  if (fns[0] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(dual_per_sm, fns[0],
                                                      NT, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      recon_per_sm, fns[1], NT, 0));
}

// The seams of a walk launch (halo: the scalar entry's table of 28
// pointers) into h: axes 0 and 1 only, each with prev, next_recon,
// next_acc, bhat and, exactly under FISTA, next_d; no iso operand. Returns
// false where the table holds anything else; clears vec where a seam slab
// is not 16-byte aligned.
static bool walk_seams(void* const* halo, int fista, Halos<float>& h,
                       int& vec) {
  for (int A = 0; A < 4; ++A) {
    if (halo[A] == nullptr) continue;
    if (A > 1 || halo[4 + A] == nullptr || halo[8 + A] == nullptr ||
        halo[24 + A] == nullptr || (halo[12 + A] != nullptr) != (fista != 0) ||
        halo[16 + A] != nullptr || halo[20 + A] != nullptr)
      return false;
    h.prev[A] = static_cast<const float*>(halo[A]);
    h.next_recon[A] = static_cast<const float*>(halo[4 + A]);
    h.next_acc[A] = static_cast<const float*>(halo[8 + A]);
    h.next_d[A] = static_cast<const float*>(halo[12 + A]);
    h.bhat[A] = static_cast<float*>(halo[24 + A]);
    for (const int f : {0, 1, 2, 3, 6}) {  // the fields above
      const void* p = halo[f * 4 + A];
      vec = vec && (p == nullptr || aligned16(p));
    }
  }
  return true;
}

// One iteration of a float32 cube through the vector walk: the dual pass
// on dual_blocks blocks, the recon pass on recon_blocks and
// walkfin_kernel; partials: dual_blocks + 2 recon_blocks doubles;
// halo: null for a whole cube, else the scalar entry's seam table, with
// seams on axes 0 and 1 only (Jia-Zhao, anisotropic; walk_seams);
// band: the item order's axis-1 indices per band (4D: 1 .. N1; 3D: 1);
// lossy: the d arrays are bfloat16 (FISTA, Jia-Zhao, anisotropic).
extern "C" int tv_fused_walk_f32(
    const void* orig, void* recon, void* b0, void* b1, void* b2, void* b3,
    void* d0, void* d1, void* d2, void* d3, const void* lambda_inv,
    const void* lam_mu, const void* rho, void* partials, void* out,
    void* const* halo, int ndim, long long n0, long long n1, long long n2,
    long long n3, int fista, int bc, int iso_r, int iso_q, int lossy,
    long long band, int dual_blocks, int recon_blocks, void* stream) {
  const int iso = ndim == 4 && (iso_r || iso_q);
  const int with_halo = halo != nullptr;
  const void* dual = nullptr;
  const void* rec = nullptr;
  walk_kernels(ndim, fista, iso, lossy, with_halo, &dual, &rec);
  if (dual == nullptr || ((lossy || with_halo) && bc != 2) ||
      dual_blocks < 1 || recon_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args<float> a{};
  a.orig = static_cast<const float*>(orig);
  a.recon = static_cast<float*>(recon);
  void* const bs[4] = {b0, b1, b2, b3};
  void* const dd[4] = {d0, d1, d2, d3};
  // VEC moves four elements per access: 16 bytes of a float array, 8 of a
  // bfloat16 d array
  int vec = aligned16(orig) && aligned16(recon);
  for (int k = 0; k < 4; ++k) {
    a.b[k] = static_cast<float*>(bs[k]);
    a.d[k] = static_cast<float*>(dd[k]);
    vec = vec && aligned16(bs[k]) &&
          (lossy ? aligned8(dd[k]) : aligned16(dd[k]));
  }
  Halos<float> h{};
  if (with_halo && !walk_seams(halo, fista, h, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n[4] = {n0, n1, n2, n3};
  set_shape(a, ndim, n);
  a.lambda_inv = static_cast<const float*>(lambda_inv);
  a.lam_mu = static_cast<const float*>(lam_mu);
  a.rho = static_cast<const float*>(rho);
  a.partials = static_cast<double*>(partials);
  a.out = static_cast<float*>(out);
  a.bc = bc;
  a.iso_r = iso_r;
  a.iso_q = iso_q;
  WalkArgs r;
  const long long per_row = set_tiles(r.v, n[ndim - 2], n[ndim - 1]);
  const long long work = a.rows * per_row;
  const long long r1 = ndim == 4 ? n1 : 1;
  // the wrapper refuses 2^31 work items or more
  if (work >= (1LL << 31) || band < 1 || band > r1)
    return static_cast<int>(cudaErrorInvalidValue);
  r.rows = static_cast<uint32_t>(a.rows);
  r.n0 = static_cast<uint32_t>(n0);
  r.r1 = static_cast<uint32_t>(r1);
  r.band = static_cast<uint32_t>(band);
  r.work = static_cast<uint32_t>(work);
  r.dual_blocks = static_cast<uint32_t>(dual_blocks);
  vec = vec && n[ndim - 1] % VW == 0;

  const dim3 block(TX, TY);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* args[] = {&a, &r, &vec, &h};
  cudaError_t err =
      cudaLaunchKernel(dual, dim3(dual_blocks), block, args, 0, s);
  if (err == cudaSuccess) {
    err = cudaLaunchKernel(rec, dim3(recon_blocks), block, args, 0, s);
  }
  if (err == cudaSuccess) {
    walkfin_kernel<<<1, block, 0, s>>>(a.partials, dual_blocks, recon_blocks,
                                       a.out);
  }
  // reading the last error also clears it, so a refused launch does not
  // surface again at the next launch's check
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

extern "C" const char* tv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
