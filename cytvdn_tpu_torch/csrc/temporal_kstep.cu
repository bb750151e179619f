// K TV-denoising iterations in one cooperative launch on a Hopper card
// (sm_90a), K in {3, 4, 6, 8}, float32, Jia-Zhao boundaries, anisotropic
// duals, 3D and 4D, FISTA and unaccelerated.
//
// Replaces the TPU kernel cytvdn_tpu/kernels/kstep.py::
// fused_kstep_iteration (entry kstep.py:395, body _make_kstep_kernel
// kstep.py:182, pallas_call kstep.py:499). The TPU kernel keeps levels
// 1..K-1 in VMEM ring carries and walks its grid in order; here the pair
// kernel's wavefront (temporal_pair.cu) is made K levels deep. Each
// element's arithmetic is that of fused_iteration.cu (wavefront.cuh, built
// with --fmad=false), so the state after one launch is bitwise equal to K
// K=1 launches, to K/2 pair launches (K even) and to K plain iterations. It
// returns every level's sums: sum|b|, sum|recon_new - recon|, sum|recon|.
//
// What bounds it on the H100: grid barriers at small rows, HBM bytes at
// large ones. A launch has N0 + 3K - 1 stages for K iterations, so
// (N0 + 3K - 1) / K barriers per iteration against (N0 + 5) / 2 for the pair
// kernel: at N0 = 64, K = 8, 10.9 against 34.5. Where a stage's 2K rows
// stay in the 50 MB L2 (small cubes) the traffic falls toward one pass per
// K iterations, (4n+3)/K traversals per iteration; where they do not (rows
// of MBs), each level's rows are re-read from HBM and the traffic stays near
// K two-pass iterations (5n+4 each), as for the pair kernel.
//
// In-place schedule. One cooperative launch walks a wavefront along axis 0
// in stages s = 0 .. N0 + 3K - 2 with a grid-wide barrier between stages.
// In stage s, level l (l = 1 .. K) runs
//   dual-l   at row s - 3(l-1):     reads R_{l-1} rows r, r-1 (+ in-row
//                                   neighbours), b_{l-1}, d_{l-1} at its own
//                                   element; writes b_l, d_l at row r;
//   recon-l  at row s - 3(l-1) - 2: reads b_l rows r, r+1 (+ in-row
//                                   neighbours), orig, R_{l-1} at its own
//                                   element (for the delta sum); writes R_l
//                                   at row r.
// R_l, b_l, d_l share the storage of recon, b, d. Rows outside [0, N0) are
// skipped. Op 2(l-1) is dual-l and op 2(l-1)+1 is recon-l; their rows
// s, s-2, s-3, s-5, s-6, ... fall strictly with the op index, so the ops
// with a row in [0, N0) are one contiguous range.
// Why it is race-free, for any K:
// - Within a stage the 2K ops write disjoint rows. recon writes R at rows
//   s-2-3(l-1) (= s-2 mod 3), and dual-l reads R across rows at s-3(l-1)
//   and s-3(l-1)-1 (= s, s-1 mod 3). dual writes b, d at rows s-3(l-1)
//   (= s mod 3), and recon-l reads b across rows at s-3(l-1)-2 and
//   s-3(l-1)-1 (= s-2, s-1 mod 3). In-row neighbours lie in the reader's own
//   row. An element that one op both reads and writes is read and written
//   by the same thread.
// - Across stages a value is overwritten only after its last reader:
//   R_l of row r is written by recon-l at stage r+3(l-1)+2, read by
//   dual-(l+1) at stages r+3l (its own row) and r+3l+1 (row r+1's
//   backward neighbour), and overwritten by recon-(l+1) at r+3l+2;
//   R_0 (the input) of row r is last read at stage r+1 and overwritten at
//   r+2. b_l (and d_l) of row r is written by dual-l at stage r+3(l-1),
//   read by recon-l at r+3(l-1)+1 (row r-1's forward neighbour) and
//   r+3(l-1)+2 (its own row), and overwritten by dual-(l+1) at r+3l.
//   Every value is read only after the stage that wrote it: R_{l-1} of
//   rows r and r-1 before dual-l at row r, b_l of rows r and r+1 before
//   recon-l at row r.
// - The one exception is the axis-0 wrap of the Jia-Zhao forward
//   difference: recon-l at row N0-1 reads b_0 at row 0, which by then may
//   hold a deeper level's value. Jia-Zhao keeps b_0's (and d_0's) row 0 at
//   zero in every iteration (SURVEY.md section 8.1), so the value read is
//   the same; that invariant is why this kernel (like the TPU one) is
//   Jia-Zhao only, and why its test states zero each accumulator's leading
//   slab along its own axis.
// - Stale L1: every load of the state goes through L2 (wavefront.cuh); the
//   grid barrier orders each stage's stores before the next stage's loads.
//
// Sums: 3K per launch. A work item's op is the same for the whole block, so
// each thread adds into its own slot of a shared double[3K][NT] array (48 KB
// at K = 8) instead of 3K registers indexed by a runtime level; after the
// last stage each block reduces the slots in a fixed tree into per-block
// partials, and block 0 reduces those in a fixed order after one more grid
// barrier. The grid is fixed by the wrapper (the occupancy of this exact
// (ndim, FISTA, K) instantiation), so the traces repeat exactly from run to
// run; they may differ from K K=1 launches in the last bit after the cast.
//
// Layout and index arithmetic as in temporal_pair.cu: 32 x 8 threads over a
// tile of the two trailing axes, work items numbered op-major, tile fastest,
// 32-bit indices (the wrapper keeps a stage's 2K x rows work items below
// 2^31), 64-bit element offsets.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wavefront.cuh"

namespace cg = cooperative_groups;

namespace {

struct KstepArgs {
  const float* orig;
  float* recon;
  float* b[4];
  float* d[4];
  const float* lambda_inv;
  const float* lam_mu;
  const float* rhos;  // [K] momentum ratios (FISTA)
  double* partials;   // [3K][gridDim.x]
  float* out;         // [3K]: per level sum|b|, sum|dR|, sum|R|
  int64_t n[4];       // extents of the ndim axes
  int64_t s[4];       // element strides of the ndim axes
  int64_t rows1;      // product of the axes between 0 and the tiled pair
  int64_t tiles_m;    // tiles of TY along axis ndim-2
  int64_t tiles_l;    // tiles of TX along axis ndim-1
};

// Dynamic shared memory of the K-level kernel: the 3K x NT double sum
// slots, then the K momentum ratios.
constexpr size_t smem_bytes(int k) {
  return size_t(3 * k) * NT * sizeof(double) + size_t(k) * sizeof(float);
}

template <int ND, bool FISTA, int K>
__global__ void __launch_bounds__(NT) kstep_kernel(KstepArgs a) {
  constexpr int OPS = 2 * K;   // row-operations per stage
  constexpr int SUMS = 3 * K;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ double acc[];  // [SUMS][NT], then float rho[K]
  float* rho = reinterpret_cast<float*>(acc + SUMS * NT);
  const int t = threadIdx.y * TX + threadIdx.x;
  float lam[ND], lm[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    lam[k] = a.lambda_inv[k];
    lm[k] = a.lam_mu[k];
  }
  if (t < K) rho[t] = FISTA ? a.rhos[t] : 0.0f;
#pragma unroll
  for (int j = 0; j < SUMS; ++j) acc[j * NT + t] = 0.0;
  __syncthreads();

  const int64_t N0 = a.n[0];
  const int64_t M = a.n[ND - 2];
  const int64_t L = a.n[ND - 1];
  const uint32_t tiles = static_cast<uint32_t>(a.tiles_m * a.tiles_l);
  const uint32_t tl_n = static_cast<uint32_t>(a.tiles_l);
  const uint32_t per_row = static_cast<uint32_t>(a.rows1) * tiles;
  const int64_t last_stage = N0 + 3 * K - 2;

  for (int64_t st = 0; st <= last_stage; ++st) {
    int first = 0;
    while (first < OPS && op_row(st, first) >= N0) ++first;
    int nact = 0;
    while (first + nact < OPS && op_row(st, first + nact) >= 0) ++nact;
    const uint32_t work = static_cast<uint32_t>(nact) * per_row;
    for (uint32_t w = blockIdx.x; w < work; w += gridDim.x) {
      const uint32_t j = w / per_row;  // the same for the whole block
      const uint32_t rem = w - j * per_row;
      const uint32_t r1 = rem / tiles;
      const uint32_t tt = rem - r1 * tiles;
      const uint32_t tm = tt / tl_n;
      const int64_t m = int64_t(tm) * TY + threadIdx.y;
      const int64_t l = int64_t(tt - tm * tl_n) * TX + threadIdx.x;
      if (m >= M || l >= L) continue;
      const int op = first + static_cast<int>(j);
      const int64_t row = op_row(st, op);
      int64_t c[ND];
      c[0] = row;
      if (ND == 4) c[1] = r1;
      c[ND - 2] = m;
      c[ND - 1] = l;
      const int64_t idx = ((row * a.rows1 + r1) * M + m) * L + l;
      const int lev = op / 2;
      double* slot = acc + 3 * lev * NT + t;
      if (op % 2 == 0) {
        slot[0] += dual_elem<ND, FISTA>(a, idx, c, lam, rho[lev]);
      } else {
        recon_elem<ND>(a, idx, c, lm, slot[NT], slot[2 * NT]);
      }
    }
    grid.sync();
  }

  // fixed-tree reduction of every slot row over the block
  for (int h = NT / 2; h > 0; h >>= 1) {
    if (t < h) {
      for (int j = 0; j < SUMS; ++j) acc[j * NT + t] += acc[j * NT + t + h];
    }
    __syncthreads();
  }
  if (t == 0) {
    for (int j = 0; j < SUMS; ++j)
      a.partials[int64_t(j) * gridDim.x + blockIdx.x] = acc[j * NT];
  }
  grid.sync();
  if (blockIdx.x == 0) {
    for (int j = 0; j < SUMS; ++j) {
      double v = 0.0;
      for (int i = t; i < static_cast<int>(gridDim.x); i += NT)
        v += __ldcg(a.partials + int64_t(j) * gridDim.x + i);
      const double total = block_sum(v, acc);
      if (t == 0) a.out[j] = static_cast<float>(total);
    }
  }
}

template <int ND, bool FISTA>
const void* kernel_for_k(int k) {
  switch (k) {
    case 3: return reinterpret_cast<const void*>(kstep_kernel<ND, FISTA, 3>);
    case 4: return reinterpret_cast<const void*>(kstep_kernel<ND, FISTA, 4>);
    case 6: return reinterpret_cast<const void*>(kstep_kernel<ND, FISTA, 6>);
    case 8: return reinterpret_cast<const void*>(kstep_kernel<ND, FISTA, 8>);
    default: return nullptr;
  }
}

const void* kernel_for(int ndim, int fista, int k) {
  if (ndim == 4) {
    return fista ? kernel_for_k<4, true>(k) : kernel_for_k<4, false>(k);
  }
  return fista ? kernel_for_k<3, true>(k) : kernel_for_k<3, false>(k);
}

// Allows the instantiation its dynamic shared memory (above the 48 KB
// default at K = 8).
cudaError_t prepare(const void* fn, int k) {
  if (fn == nullptr) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes(k)));
}

}  // namespace

// The largest grid a cooperative launch of the (ndim, fista, k) kernel may
// have on the current device: resident blocks per SM of that exact
// instantiation (its registers and shared memory) times SMs.
extern "C" int tv_kstep_max_blocks(int ndim, int fista, int k, int* blocks) {
  const void* fn = kernel_for(ndim, fista, k);
  cudaError_t err = prepare(fn, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, NT,
                                                      smem_bytes(k));
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = per_sm * sms;
  return 0;
}

extern "C" int tv_kstep_iteration_f32(
    const void* orig, void* recon, void* b0, void* b1, void* b2, void* b3,
    void* d0, void* d1, void* d2, void* d3, const void* lambda_inv,
    const void* lam_mu, const void* rhos, void* partials, void* out,
    int ndim, long long n0, long long n1, long long n2, long long n3,
    int fista, int k, int nblocks, void* stream) {
  const void* fn = kernel_for(ndim, fista, k);
  cudaError_t err = prepare(fn, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  KstepArgs a;
  a.orig = static_cast<const float*>(orig);
  a.recon = static_cast<float*>(recon);
  void* const bs[4] = {b0, b1, b2, b3};
  void* const dd[4] = {d0, d1, d2, d3};
  const long long n[4] = {n0, n1, n2, n3};
  for (int q = 0; q < 4; ++q) {
    a.b[q] = static_cast<float*>(bs[q]);
    a.d[q] = static_cast<float*>(dd[q]);
    a.n[q] = q < ndim ? n[q] : 1;
  }
  int64_t stride = 1;
  for (int q = ndim - 1; q >= 0; --q) {
    a.s[q] = stride;
    stride *= a.n[q];
  }
  for (int q = ndim; q < 4; ++q) a.s[q] = 0;
  a.lambda_inv = static_cast<const float*>(lambda_inv);
  a.lam_mu = static_cast<const float*>(lam_mu);
  a.rhos = static_cast<const float*>(rhos);
  a.partials = static_cast<double*>(partials);
  a.out = static_cast<float*>(out);
  a.rows1 = 1;
  for (int q = 1; q < ndim - 2; ++q) a.rows1 *= a.n[q];
  a.tiles_m = (a.n[ndim - 2] + TY - 1) / TY;
  a.tiles_l = (a.n[ndim - 1] + TX - 1) / TX;

  void* args[] = {&a};
  // a grid above the cooperative limit is refused here, not shrunk
  err = cudaLaunchCooperativeKernel(fn, dim3(nblocks), dim3(TX, TY), args,
                                    smem_bytes(k),
                                    static_cast<cudaStream_t>(stream));
  // reading the last error also clears it, so a refused launch does not
  // surface again at the next launch's check
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
