// Two TV-denoising iterations in one cooperative launch on a Hopper card
// (sm_90a), float32, Jia-Zhao boundaries, anisotropic duals, 3D and 4D.
//
// Replaces the TPU kernel cytvdn_tpu/kernels/temporal.py::
// fused_pair_iteration (entry temporal.py:947, body _make_pair_kernel
// temporal.py:230, pallas_call temporal.py:1300). Each element's arithmetic
// is that of csrc/fused_iteration.cu (the same clip form, the same order of
// operations, no FMA contraction), so the state after one launch is bitwise
// equal to two K=1 launches and to two plain iterations. It returns both
// iterations' sums: sum|b|, sum|recon_new - recon|, sum|recon|.
//
// What bounds it on the H100: HBM bytes, as for the K=1 kernel. A "row" here
// is one axis-0 slab (all other axes). At 256^2 x 128^2 a row is 16 MB per
// array and a stage touches ~10 arrays over a reuse distance of 6 rows, far
// beyond the 50 MB L2, so the traffic stays near two K=1 passes (5n+4
// traversals per iteration). Where rows are small (3D cubes, small 4D
// cubes) rows of iteration 1 are re-read from L2, down to the one-pass
// floor of (4n+3)/2 traversals per iteration. A schedule whose frontier
// fits L2 at the large shapes (skewed row x axis-1-band stages) is later
// work.
//
// In-place schedule. The state (recon, b_k, d_k) is updated in place: a
// second copy of it does not fit (10 x 4.29 GB at 256^2 x 128^2 FISTA). One
// cooperative launch walks a wavefront along axis 0 in stages
// s = 0 .. N0 + 3K - 2 (K = 2 levels), with a grid-wide barrier between
// stages. In stage s, level l (l = 1 .. K) runs
//   dual-l   at row s - 3(l-1):     reads R_{l-1} rows r, r-1 (+ in-row
//                                   neighbours), b_{l-1}, d_{l-1} at its own
//                                   element; writes b_l, d_l at row r;
//   recon-l  at row s - 3(l-1) - 2: reads b_l rows r, r+1 (+ in-row
//                                   neighbours), orig, R_{l-1} at its own
//                                   element (for the delta sum); writes R_l
//                                   at row r.
// Rows outside [0, N0) are skipped. For K = 2 in stage s:
//   dual-1 row s, recon-1 row s-2, dual-2 row s-3, recon-2 row s-5.
// Why it is race-free:
// - Within a stage the four sub-stages touch disjoint rows of what they
//   write: R is read at rows s, s-1 (dual-1), s-3, s-4 (dual-2) and written
//   at rows s-2 (recon-1), s-5 (recon-2); b/d are written at rows s (dual-1)
//   and s-3 (dual-2) and read across rows at s-2, s-1 (recon-1) and s-5,
//   s-4 (recon-2). An element read and written by one sub-stage is read and
//   written by the same thread.
// - Across stages a value is overwritten only after its last reader:
//   R_0 of row r is last read by dual-1 at stage r+1 and overwritten at
//   r+2; R_1 of row r is written at r+2, read by dual-2 at r+3 and r+4 and
//   overwritten at r+5; b_1 of row r is written at r, read by recon-1 at
//   r+1 and r+2 and overwritten at r+3; b_2 of row r is written at r+3 and
//   read by recon-2 at r+4 and r+5.
// - The one exception is the axis-0 wrap of the Jia-Zhao forward
//   difference: recon-l at row N0-1 reads b_0 at row 0, which by then may
//   already hold a later level's value. Jia-Zhao keeps b_0's row 0 at zero
//   in every iteration (SURVEY.md section 8.1), so the value read is the
//   same; that invariant is why this kernel (like the TPU one) is
//   Jia-Zhao only, and why its test states zero each accumulator's leading
//   slab along its own axis.
// - L1 is not coherent across SMs, and a block that read a row of R_0 in
//   dual-1 could later read its stale L1 copy after another block rewrote it
//   as R_1. Every load of the state goes through L2 (ld.global.cg); only
//   orig, which nothing writes, is read through the read-only path. The
//   grid barrier orders each stage's stores before the next stage's loads.
// Deeper levels (the K-step kernel) follow the same pattern: dual-l three
// rows behind dual-(l-1), recon-l two rows behind dual-l.
//
// Sums: each thread keeps six double accumulators over all stages; after the
// last stage each block reduces them in a fixed order into per-block
// partials, and block 0 reduces those in a fixed order after one more grid
// barrier. The grid is fixed by the wrapper (the device's cooperative
// occupancy), so the traces repeat exactly from run to run; they may differ
// from two K=1 launches in the last bit after the cast.
//
// Layout: a block is 32 x 8 threads over a tile of the two trailing axes.
// In each stage the active sub-stages' (row-op, axis-1 index, tile) work
// items are numbered op-major, tile fastest, and blocks stride over them.
// Index arithmetic is 32-bit (the wrapper keeps a stage's work items below
// 2^31); element offsets are 64-bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int NT = TX * TY;
constexpr int LEVELS = 2;        // iterations per launch
constexpr int OPS = 2 * LEVELS;  // row-operations per stage
constexpr int SUMS = 3 * LEVELS;

struct PairArgs {
  const float* orig;
  float* recon;
  float* b[4];
  float* d[4];
  const float* lambda_inv;
  const float* lam_mu;
  const float* rho[LEVELS];
  double* partials;  // [SUMS][gridDim.x]
  float* out;        // [SUMS]: per level sum|b|, sum|dR|, sum|R|
  int64_t n[4];      // extents of the ndim axes
  int64_t s[4];      // element strides of the ndim axes
  int64_t rows1;     // product of the axes between 0 and the tiled pair
  int64_t tiles_m;   // tiles of TY along axis ndim-2
  int64_t tiles_l;   // tiles of TX along axis ndim-1
};

// Loads of the state bypass L1 (see the header).
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

// Dual update of one element at level `lev`, as fused_iteration.cu's
// dual_kernel does it for an anisotropic axis; returns sum_k |b_k|.
template <int ND, bool FISTA>
__device__ __forceinline__ double dual_elem(const PairArgs& a, int64_t idx,
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
template <int ND>
__device__ __forceinline__ void recon_elem(const PairArgs& a, int64_t idx,
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

template <int ND, bool FISTA>
__global__ void __launch_bounds__(NT) pair_kernel(PairArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double red[NT];
  float lam[ND], lm[ND], rho[LEVELS];
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    lam[k] = a.lambda_inv[k];
    lm[k] = a.lam_mu[k];
  }
#pragma unroll
  for (int l = 0; l < LEVELS; ++l) rho[l] = FISTA ? *a.rho[l] : 0.0f;
  double acc[SUMS];
#pragma unroll
  for (int j = 0; j < SUMS; ++j) acc[j] = 0.0;

  const int64_t N0 = a.n[0];
  const int64_t M = a.n[ND - 2];
  const int64_t L = a.n[ND - 1];
  const uint32_t tiles = static_cast<uint32_t>(a.tiles_m * a.tiles_l);
  const uint32_t tl_n = static_cast<uint32_t>(a.tiles_l);
  const uint32_t per_row = static_cast<uint32_t>(a.rows1) * tiles;
  const int64_t last_stage = N0 + 3 * LEVELS - 2;

  for (int64_t st = 0; st <= last_stage; ++st) {
    // op 2l is dual-(l+1) at row st - 3l, op 2l+1 is recon-(l+1) two rows
    // behind it; rows fall with op, so the ops with a row in [0, N0) are
    // the contiguous range first .. first + nact - 1
    int first = 0;
    while (first < OPS && op_row(st, first) >= N0) ++first;
    int nact = 0;
    while (first + nact < OPS && op_row(st, first + nact) >= 0) ++nact;
    const uint32_t work = static_cast<uint32_t>(nact) * per_row;
    for (uint32_t w = blockIdx.x; w < work; w += gridDim.x) {
      const uint32_t j = w / per_row;  // the same for the whole block
      const uint32_t rem = w - j * per_row;
      const uint32_t r1 = rem / tiles;
      const uint32_t t = rem - r1 * tiles;
      const uint32_t tm = t / tl_n;
      const int64_t m = int64_t(tm) * TY + threadIdx.y;
      const int64_t l = int64_t(t - tm * tl_n) * TX + threadIdx.x;
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
      if (op % 2 == 0) {
        const double v = dual_elem<ND, FISTA>(a, idx, c, lam, rho[lev]);
        if (lev == 0) acc[0] += v; else acc[3] += v;
      } else if (lev == 0) {
        recon_elem<ND>(a, idx, c, lm, acc[1], acc[2]);
      } else {
        recon_elem<ND>(a, idx, c, lm, acc[4], acc[5]);
      }
    }
    grid.sync();
  }

  const int t = threadIdx.y * TX + threadIdx.x;
#pragma unroll
  for (int j = 0; j < SUMS; ++j) {
    const double total = block_sum(acc[j], red);
    if (t == 0) a.partials[int64_t(j) * gridDim.x + blockIdx.x] = total;
  }
  grid.sync();
  if (blockIdx.x == 0) {
    for (int j = 0; j < SUMS; ++j) {
      double v = 0.0;
      for (int i = t; i < static_cast<int>(gridDim.x); i += NT)
        v += __ldcg(a.partials + int64_t(j) * gridDim.x + i);
      const double total = block_sum(v, red);
      if (t == 0) a.out[j] = static_cast<float>(total);
    }
  }
}

const void* kernel_for(int ndim, int fista) {
  if (ndim == 4) {
    return fista ? reinterpret_cast<const void*>(pair_kernel<4, true>)
                 : reinterpret_cast<const void*>(pair_kernel<4, false>);
  }
  return fista ? reinterpret_cast<const void*>(pair_kernel<3, true>)
               : reinterpret_cast<const void*>(pair_kernel<3, false>);
}

}  // namespace

// The largest grid a cooperative launch of the (ndim, fista) kernel may
// have on the current device: resident blocks per SM times SMs.
extern "C" int tv_pair_max_blocks(int ndim, int fista, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel_for(ndim, fista), NT, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = per_sm * sms;
  return 0;
}

extern "C" int tv_pair_iteration_f32(
    const void* orig, void* recon, void* b0, void* b1, void* b2, void* b3,
    void* d0, void* d1, void* d2, void* d3, const void* lambda_inv,
    const void* lam_mu, const void* rho1, const void* rho2, void* partials,
    void* out, int ndim, long long n0, long long n1, long long n2,
    long long n3, int fista, int nblocks, void* stream) {
  PairArgs a;
  a.orig = static_cast<const float*>(orig);
  a.recon = static_cast<float*>(recon);
  void* const bs[4] = {b0, b1, b2, b3};
  void* const dd[4] = {d0, d1, d2, d3};
  const long long n[4] = {n0, n1, n2, n3};
  for (int k = 0; k < 4; ++k) {
    a.b[k] = static_cast<float*>(bs[k]);
    a.d[k] = static_cast<float*>(dd[k]);
    a.n[k] = k < ndim ? n[k] : 1;
  }
  int64_t stride = 1;
  for (int k = ndim - 1; k >= 0; --k) {
    a.s[k] = stride;
    stride *= a.n[k];
  }
  for (int k = ndim; k < 4; ++k) a.s[k] = 0;
  a.lambda_inv = static_cast<const float*>(lambda_inv);
  a.lam_mu = static_cast<const float*>(lam_mu);
  a.rho[0] = static_cast<const float*>(rho1);
  a.rho[1] = static_cast<const float*>(rho2);
  a.partials = static_cast<double*>(partials);
  a.out = static_cast<float*>(out);
  a.rows1 = 1;
  for (int k = 1; k < ndim - 2; ++k) a.rows1 *= a.n[k];
  a.tiles_m = (a.n[ndim - 2] + TY - 1) / TY;
  a.tiles_l = (a.n[ndim - 1] + TX - 1) / TX;

  void* args[] = {&a};
  // a grid above the cooperative limit is refused here, not shrunk
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel_for(ndim, fista), dim3(nblocks), dim3(TX, TY), args, 0,
      static_cast<cudaStream_t>(stream));
  // reading the last error also clears it, so a refused launch does not
  // surface again at the next launch's check
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
