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
// number of dependent L2 round trips and of L2 requests per element, with
// the vector walk of vec_walk.cuh (shared with the K-step kernel): four
// elements per thread with 128-bit loads, every load of a work item before
// its first store, neighbours along the last axis from lanes and along axis
// ND-2 from shared memory. Work items are (row, tile) pairs, the tile index
// fastest, the leading axes flattened into rows; blocks stride over them,
// and a block visits the same elements in every phase of every iteration.
// Index arithmetic is 32-bit (the wrapper keeps the work-item count below
// 2^31); element offsets are 64-bit.
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
// - So no store of a phase changes what any load of the phase reads, other
//   than a thread's own elements, which it loads first: what vec_walk.cuh's
//   items need to be race-free. Each grid barrier orders one phase's stores
//   before the next phase's loads.
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

#include "vec_walk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NSUM = 4;
constexpr int NWARP = NT / 32;

struct ResidentArgs {
  const float* rhos;  // [T] momentum ratios (FISTA)
  const float* ref;   // reference cube for the SSE trace (REF)
  double* partials;   // [NSUM][gridDim.x] per-block sums of one iteration
  float* traces;      // [NSUM][T]: sum|b|, sum|dR|, sum|R|, SSE
  int n_iters;
  VecTiles v;         // the walk's tiling (vec_walk.cuh)
  uint32_t work;      // rows x tiles_m x tiles_l
};

// The dual phase's walk: every element's b_k (and d_k); adds each new |b_k|
// to acc, element by element in axis order.
template <int ND, bool FISTA, bool VEC>
__device__ __forceinline__ void dual_walk(const Args<float>& a,
                                          const ResidentArgs& r,
                                          const float* lam, float rho,
                                          bool iso_r, bool iso_q, int tid,
                                          float4 (*buf)[NT], double& acc) {
  const int lw = r.v.lw;
  const int xl = tid & (lw - 1);
  const int y = tid >> r.v.lw_log;
  const uint32_t per_row = r.v.tiles_m * r.v.tiles_l;
  int parity = 0;
  for (uint32_t w = blockIdx.x; w < r.work; w += gridDim.x) {
    const uint32_t row = w / per_row;
    const Item<ND> it = item_at<ND>(a, r.v, row, w - row * per_row, y, xl);
    dual_item<ND, FISTA, VEC>(a, it, lw, xl, y, tid, lam, rho, iso_r, iso_q,
                              buf, parity, acc);
  }
}

// The recon phase's walk: every element's recon; adds |R_new - R_old| and
// |R_old| to s[1], s[2] and, with a reference, (R_new - ref)^2 to s[3].
template <int ND, bool REF, bool VEC>
__device__ __forceinline__ void recon_walk(const Args<float>& a,
                                           const ResidentArgs& r,
                                           const float* lm, int tid,
                                           float4 (*buf)[NT], double* s) {
  const int lw = r.v.lw;
  const int xl = tid & (lw - 1);
  const int y = tid >> r.v.lw_log;
  const int last_y = (NT >> r.v.lw_log) - 1;
  const uint32_t per_row = r.v.tiles_m * r.v.tiles_l;
  int parity = 0;
  for (uint32_t w = blockIdx.x; w < r.work; w += gridDim.x) {
    const uint32_t row = w / per_row;
    const Item<ND> it = item_at<ND>(a, r.v, row, w - row * per_row, y, xl);
    recon_item<ND, REF, VEC>(a, it, lw, xl, y, last_y, tid, lm, r.ref, buf,
                             parity, s);
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
  const long long work = a.rows * set_tiles(r.v, n[ndim - 2], n[ndim - 1]);
  // the wrapper refuses 2^31 work items or more
  if (work >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  r.work = static_cast<uint32_t>(work);
  vec = vec && n[ndim - 1] % VW == 0;

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
