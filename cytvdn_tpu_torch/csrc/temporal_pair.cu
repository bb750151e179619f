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
// What bounds it on the H100. A "row" here is one axis-0 slab (all other
// axes). Walking whole rows, a stage keeps about 50 row-tiles alive across
// its six-stage reuse window (6 of R, 6 of each b_k, 4 of each d_k and 4 of
// orig): 800 MB at 256^2 x 128^2 (16 MB rows), against the 50 MB L2, so
// iteration 1's rows go out to HBM and come back (the two-pass traffic,
// 5n+4 traversals per iteration). The launch can instead walk the rows in
// strips of W axis-1 indices (the TPU kernel's axis-1 strips, `pair_plan`'s
// b1), whose window fits the L2, so that iteration 1's values are re-read
// from there. On the H100 that does not pay: the walk is bound by its L2
// requests (4-byte loads and stores, ~256 bytes per element per pair), not
// by HBM, and each strip adds N0+5 grid barriers. Whole rows were the
// fastest or within 4% at every row size swept, 2 to 16 MiB (PERF.md
// section 6, the strip sweep), so the wrapper (kernels/temporal.py::
// fused_pair_iteration) walks whole rows, W = N1 (one strip), unless a
// strip is forced.
//
// The dual element sends every load before its first store
// (dual_elem_loads_first, below). A store of d_k sent while the load of
// its old value by the same thread was still in flight made the kernel
// 2.6x slower in 4D, and 6x in 3D where the compiler scheduled
// wavefront.cuh's dual_elem that way; storing b_k first, whose value needs
// that load, removes it.
//
// In-place schedule. The state (recon, b_k, d_k) is updated in place: a
// second copy of it does not fit (10 x 4.29 GB at 256^2 x 128^2 FISTA). One
// cooperative launch runs strips j = 0 .. ceil(N1/W) - 1 one after another;
// each strip walks a wavefront along axis 0 in stages
// s = 0 .. N0 + 3K - 2 (K = 2 levels), with a grid-wide barrier after every
// stage. In stage s, level l (l = 1 .. K) runs
//   dual-l   at row s - 3(l-1):     reads R_{l-1} rows r, r-1 (+ in-row
//                                   neighbours), b_{l-1}, d_{l-1} at its own
//                                   element; writes b_l, d_l at row r;
//   recon-l  at row s - 3(l-1) - 2: reads b_l rows r, r+1 (+ in-row
//                                   neighbours), orig, R_{l-1} at its own
//                                   element (for the delta sum); writes R_l
//                                   at row r.
// Rows outside [0, N0) are skipped. For K = 2 in stage s:
//   dual-1 row s, recon-1 row s-2, dual-2 row s-3, recon-2 row s-5.
// Axis 1 is the axis after the leading one: r1 in 4D, the tiled axis ND-2
// in 3D. In strip j a row operation covers the axis-1 indices
// [max(0, jW - lag), (j+1)W - lag), shifted left by its lag: dual-1 0,
// recon-1 1, dual-2 1, recon-2 2 (the staircase of the rows, along axis 1);
// in the last strip every operation runs up to N1. Each element of each
// operation is computed once.
// Why it is race-free:
// - Within a stage the four sub-stages touch disjoint rows of what they
//   write: R is read at rows s, s-1 (dual-1), s-3, s-4 (dual-2) and written
//   at rows s-2 (recon-1), s-5 (recon-2); b/d are written at rows s (dual-1)
//   and s-3 (dual-2) and read across rows at s-2, s-1 (recon-1) and s-5,
//   s-4 (recon-2). An element read and written by one sub-stage is read and
//   written by the same thread. Along axis 1 a sub-stage reads R at c-1
//   (dual) or b at c+1 (recon) and writes neither.
// - Across stages of a strip a value is overwritten only after its last
//   reader: R_0 of row r is last read by dual-1 at stage r+1 and overwritten
//   at r+2; R_1 of row r is written at r+2, read by dual-2 at r+3 and r+4
//   and overwritten at r+5; b_1 of row r is written at r, read by recon-1 at
//   r+1 and r+2 and overwritten at r+3; b_2 of row r is written at r+3 and
//   read by recon-2 at r+4 and r+5. Within a strip the lags keep each
//   reader's columns inside what its producer wrote: recon-1 at c reads b_1
//   at c+1 <= (j+1)W-1, written by dual-1; dual-2 reads R_1 at c-1 >=
//   jW-2, written by recon-1 of this strip or the one before; recon-2 reads
//   b_2 at c+1 <= (j+1)W-2, written by dual-2.
// - Across strips a value at a seam is overwritten only after its last
//   reader, since strip j+1 starts after strip j's last barrier. recon-1 of
//   strip j reads b_1 at (j+1)W-1 and stops at (j+1)W-2. dual-1 of strip j+1
//   reads R_0 at (j+1)W-1, which strip j's recon-1 left untouched. dual-2 of
//   strip j+1 reads R_1 at (j+1)W-2, which strip j's recon-2 (ending at
//   (j+1)W-3) left untouched. b_1 at (j+1)W-1 is still b_1 when strip j+1's
//   recon-1 reads it, because strip j's dual-2 stops at (j+1)W-2.
// - The one exception is the wrap of the Jia-Zhao forward difference:
//   recon-l at the last index of axis k reads b_k at index 0 of axis k,
//   which by then may already hold a later level's value (along axis 0:
//   row 0; along axis 1: column 0, written by strip 0). Jia-Zhao keeps each
//   b_k's leading slab along axis k at zero in every iteration (SURVEY.md
//   section 8.1), so the value read is the same at every level; that
//   invariant is why this kernel (like the TPU one) is Jia-Zhao only, and
//   why its test states zero each accumulator's leading slab along its own
//   axis.
// - L1 is not coherent across SMs, and a block that read a row of R_0 in
//   dual-1 could later read its stale L1 copy after another block rewrote it
//   as R_1. Every load of the state goes through L2 (ld.global.cg); only
//   orig, which nothing writes, is read through the read-only path. The
//   grid barrier orders each stage's stores before the next stage's loads.
// Deeper levels (csrc/temporal_kstep.cu) follow the same pattern along
// axis 0 with whole rows: dual-l three rows behind dual-(l-1), recon-l two
// rows behind dual-l. The stage layout and recon_elem live in
// wavefront.cuh, shared by both; the dual element here is
// dual_elem_loads_first (below), wavefront.cuh's dual_elem with its loads
// moved ahead of its stores.
//
// Sums: each thread keeps six double accumulators over all stages; after the
// last stage each block reduces them in a fixed order into per-block
// partials, and block 0 reduces those in a fixed order after one more grid
// barrier. The grid and the strip are fixed by the wrapper (the device's
// cooperative occupancy, the shape), so the traces repeat exactly from run
// to run; they may differ from two K=1 launches in the last bit after the
// cast.
//
// Layout: a block is 32 x 8 threads over a tile of the two trailing axes.
// In each stage the active sub-stages' (row-op, axis-1 index, tile) work
// items are numbered op-major, then axis-1 index, tile fastest (in 3D the
// tiles of an op start at its axis-1 index lo), and blocks stride over
// them. Index arithmetic is 32-bit (the wrapper keeps a stage's work items
// below 2^31); element offsets are 64-bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wavefront.cuh"

namespace cg = cooperative_groups;

namespace {

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
  int64_t strip;     // W, axis-1 indices per strip, 1 .. n[1]
};

// The axis-1 range [lo, hi) of row-operation `op` in strip `j` of
// `strips`: [jW, (j+1)W) shifted left by the op's lag (dual-1 0, recon-1 1,
// dual-2 1, recon-2 2), clipped at 0; the last strip runs up to n1.
__device__ __forceinline__ void op_range(int op, int64_t j, int64_t strips,
                                         int64_t w, int64_t n1, int64_t& lo,
                                         int64_t& hi) {
  const int64_t lag = (op + 1) / 2;
  lo = j * w - lag > 0 ? j * w - lag : 0;
  hi = j == strips - 1 ? n1 : (j + 1) * w - lag;
  if (hi < lo) hi = lo;
}

// wavefront.cuh's dual_elem with every load of the element sent before
// its first store: recon at the element and its backward neighbours, then
// each axis's b and d. The element waits one L2 round trip instead of one
// per axis (a store to b_k or d_k could alias the next axis's loads, so the
// compiler keeps them in program order). Race-free as dual_elem: the
// element's own b, d are read and written by this thread only, and recon,
// which a dual reads around the element, no dual writes. The arithmetic and
// its order are dual_elem's.
template <int ND, bool FISTA>
__device__ __forceinline__ double dual_elem_loads_first(
    const PairArgs& a, int64_t idx, const int64_t* c, const float* lam,
    float rho) {
  const float x = ld(a.recon + idx);
  float xb[ND], bo[ND], dold[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    xb[k] = ld(a.recon + bwd(idx, c[k], a.s[k]));
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
    // d's old value, and never goes out while that load is in flight
    a.b[k][idx] = bn;
    if (FISTA) a.d[k][idx] = dn;
    acc += static_cast<double>(fabsf(bn));
  }
  return acc;
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
  const int64_t N1 = a.n[1];
  const int64_t M = a.n[ND - 2];
  const int64_t L = a.n[ND - 1];
  const uint32_t tl_n = static_cast<uint32_t>(a.tiles_l);
  // work items per axis-1 index (4D: the tiles of axes 2 and 3) or per TY
  // of them (3D: one row of tiles along the last axis)
  const uint32_t per1 = static_cast<uint32_t>(ND == 4 ? a.tiles_m * a.tiles_l
                                                      : a.tiles_l);
  const int64_t W = a.strip;
  const int64_t strips = (N1 + W - 1) / W;
  const int64_t last_stage = N0 + 3 * LEVELS - 2;

  for (int64_t sj = 0; sj < strips; ++sj) {
    // each op's work items in this strip
    uint32_t cnt[OPS];
#pragma unroll
    for (int op = 0; op < OPS; ++op) {
      int64_t lo, hi;
      op_range(op, sj, strips, W, N1, lo, hi);
      const int64_t n1 = ND == 4 ? hi - lo : (hi - lo + TY - 1) / TY;
      cnt[op] = static_cast<uint32_t>(n1) * per1;
    }
    for (int64_t st = 0; st <= last_stage; ++st) {
      // op 2l is dual-(l+1) at row st - 3l, op 2l+1 is recon-(l+1) two rows
      // behind it; rows fall with op, so the ops with a row in [0, N0) are
      // the contiguous range first .. first + nact - 1
      int first = 0;
      while (first < OPS && op_row(st, first) >= N0) ++first;
      int nact = 0;
      while (first + nact < OPS && op_row(st, first + nact) >= 0) ++nact;
      uint32_t work = 0;
#pragma unroll
      for (int op = 0; op < OPS; ++op)
        if (op >= first && op < first + nact) work += cnt[op];
      for (uint32_t w = blockIdx.x; w < work; w += gridDim.x) {
        // the op and the item within it, the same for the whole block
        int op = first;
        uint32_t rem = w;
#pragma unroll
        for (int j = 0; j < OPS - 1; ++j) {
          if (j == op && rem >= cnt[j]) {
            rem -= cnt[j];
            ++op;
          }
        }
        int64_t lo, hi;
        op_range(op, sj, strips, W, N1, lo, hi);
        const int64_t row = op_row(st, op);
        int64_t c[ND];
        c[0] = row;
        int64_t r1 = 0, m, l;
        if (ND == 4) {
          const uint32_t q = rem / per1;
          const uint32_t t = rem - q * per1;
          const uint32_t tm = t / tl_n;
          r1 = lo + q;
          m = int64_t(tm) * TY + threadIdx.y;
          l = int64_t(t - tm * tl_n) * TX + threadIdx.x;
          if (m >= M || l >= L) continue;
          c[1] = r1;
        } else {
          const uint32_t tm = rem / tl_n;
          m = lo + int64_t(tm) * TY + threadIdx.y;
          l = int64_t(rem - tm * tl_n) * TX + threadIdx.x;
          if (m >= hi || l >= L) continue;
        }
        c[ND - 2] = m;
        c[ND - 1] = l;
        const int64_t idx = ((row * a.rows1 + r1) * M + m) * L + l;
        const int lev = op / 2;
        if (op % 2 == 0) {
          const double v =
              dual_elem_loads_first<ND, FISTA>(a, idx, c, lam, rho[lev]);
          if (lev == 0) acc[0] += v; else acc[3] += v;
        } else if (lev == 0) {
          recon_elem<ND>(a, idx, c, lm, acc[1], acc[2]);
        } else {
          recon_elem<ND>(a, idx, c, lm, acc[4], acc[5]);
        }
      }
      grid.sync();
    }
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
    long long n3, long long strip, int fista, int nblocks, void* stream) {
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
  a.strip = strip < 1 ? 1 : (strip > a.n[1] ? a.n[1] : strip);

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
