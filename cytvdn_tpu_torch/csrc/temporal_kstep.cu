// K TV-denoising iterations in one cooperative launch on a Hopper card
// (sm_90a), K in {3, 4, 6, 8}, float32, Jia-Zhao boundaries, anisotropic
// duals, 3D and 4D, FISTA and unaccelerated, and FISTA with bfloat16 shadow
// duals (LOSSY).
//
// Replaces the TPU kernel cytvdn_tpu/kernels/kstep.py::
// fused_kstep_iteration (entry kstep.py:395, body _make_kstep_kernel
// kstep.py:182, pallas_call kstep.py:499). The TPU kernel keeps levels
// 1..K-1 in VMEM ring carries and walks its grid in order; here the pair
// kernel's wavefront (temporal_pair.cu) is made K levels deep. Each
// element's arithmetic is that of fused_iteration.cu (vec_walk.cuh, built
// with --fmad=false), so the state after one launch is bitwise equal to K
// K=1 launches, to K/2 pair launches (K even) and to K plain iterations. It
// returns every level's sums: sum|b|, sum|recon_new - recon|, sum|recon|.
//
// What bounds it on the H100: a launch has N0 + 3K - 1 stages for K
// iterations, each closed by a grid barrier (~2.4 us), so (N0 + 3K - 1) / K
// barriers per iteration against (N0 + 5) / 2 for the pair kernel: at N0 =
// 64, K = 8, 10.9 against 34.5. Within a stage, the latency and then the
// throughput of the walk's L2 requests, as for the whole-run kernel, whose
// walk (vec_walk.cuh) it shares. Where a stage's 2K rows stay in the 50 MB
// L2 the HBM traffic falls toward one pass per K iterations, (4n+3)/K
// traversals per iteration; where they do not (rows of MBs), each level's
// rows are re-read from HBM and the traffic stays near K two-pass
// iterations (5n+4 each), as for the pair kernel.
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
// - Stale L1: every load of the state goes through L2 (vec_walk.cuh); the
//   grid barrier orders each stage's stores before the next stage's loads.
//
// Rows per stage. The wrapper may take R consecutive axis-0 rows as one
// super-row (kernels/kstep.py::kstep_stages mirrors the schedule): every
// row above is then a super-row, op_row counts in super-rows, an op covers
// the R rows of its super-row (fewer in the last), and a launch has
// ceil(N0 / R) + 3K - 1 stages, so ceil(N0 / R) + 3K - 1 barriers for K
// iterations. The argument carries over unchanged. Neighbours along axis
// 0 are +-1 row, so a value an op reads across rows lies in its own
// super-row or in the one before (a dual's R at r-1) or after (a recon's b
// at r+1), exactly where R = 1 puts a row's neighbours: a row of the op's
// own super-row holds the value an earlier stage wrote, as the op's own row
// does at R = 1 (no op writes what it reads across rows: a dual writes b,
// d and reads R; a recon writes R and reads b). Within a stage the ops
// still write disjoint super-rows. R = 1 is the schedule above, item for
// item.
//
// The walk (vec_walk.cuh, the whole-run kernel's): a work item is one tile
// of NT / lw rows of axis ND-2 by 4 lw elements of axis ND-1 of one row
// operation's row, four elements per thread with 128-bit loads where VEC,
// every load of the item before its first store and b stored before d,
// last-axis neighbours from lanes and axis ND-2 neighbours from the tile's
// neighbouring row in shared memory. The axis-0 neighbours (rows r-1 for a
// dual, r+1 for a recon) and in 4D the axis-1 ones stay loads. The schedule
// above stays race-free with it:
// - Each stage's ops still write disjoint rows, and every value an item
//   loads (directly, from a lane or from shared memory) lies in its own row
//   or in row r-1 (dual) or r+1 (recon), which no op of the stage writes,
//   except the item's own elements of what it updates (b, d of a dual; R of
//   a recon), read and written by the same thread, which loads them first.
//   So an item may issue every load before its first store.
// - An item's shared-memory row exchange is block-local: every thread of
//   the block takes part in every item (an op is the same for the whole
//   block), and the two buffers used in turns keep item i's reads apart
//   from item i+2's writes by item i+1's block barrier.
//
// Sums: 3K per launch. A work item's op is the same for the whole block,
// so each thread adds its item's sums into its own slot of a shared
// double[3K][NT] array instead of 3K registers indexed by a runtime level
// (one slot per warp, each item's sums reduced over the warp first, was
// no faster, PERF.md section 6, PR 9); after the last stage each block
// reduces its slots in a fixed order into
// per-block partials, and block 0 reduces those in a fixed order after one
// more grid barrier. The grid is fixed by the wrapper (the occupancy of
// this exact (ndim, FISTA, K, LOSSY) instantiation), so the traces repeat
// exactly from run to run; they may differ from K K=1 launches in the last
// bit after the cast.
//
// Lossy duals (LOSSY, FISTA only; the TPU kernel's bfloat16 ds, its qd
// rounding of every intermediate level's d and the last level's bfloat16
// store, cytvdn_tpu/kernels/kstep.py:251-254, :329, :339-340, :480-482):
// the d arrays are bfloat16. Every level keeps its d in the d array, in
// place, so each level's dual store of d is itself that rounding: dual-l
// stores d_l rounded to nearest even, and dual-(l+1) reads it back widened,
// as the K=1 kernel's next launch reads its d (vec_walk.cuh's LOSSY
// dual_item, the element of tv_elem.cuh dual_elem_lossy). So a LOSSY
// launch is bitwise K LOSSY K=1 launches and (K even) K/2 LOSSY pairs, d
// included. Without LOSSY the instantiations compile to the code they were.
//
// Index arithmetic is 32-bit (the wrapper keeps a stage's 2K x rows work
// items below 2^31 and the rows below 2^32); element offsets are 64-bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec_walk.cuh"
#include "wavefront.cuh"

namespace cg = cooperative_groups;

namespace {

struct KstepArgs {
  const float* rhos;  // [K] momentum ratios (FISTA)
  double* partials;   // [3K][gridDim.x]
  float* out;         // [3K]: per level sum|b|, sum|dR|, sum|R|
  uint32_t rows1;     // product of the axes between 0 and the tiled pair
  uint32_t rps;       // R: axis-0 rows per super-row, 1 .. N0
  VecTiles v;         // the walk's tiling (vec_walk.cuh)
};

// Dynamic shared memory of the K-level kernel: its sum slots, one double
// per thread and sum, [3K][NT] (48 KB at K = 8).
constexpr size_t smem_bytes(int k) {
  return size_t(3 * k) * NT * sizeof(double);
}

// The ceil(N0 / R) + 3K - 1 stages of the wavefront, with a grid barrier
// after each.
template <int ND, bool FISTA, int K, bool VEC, bool LOSSY>
__device__ __forceinline__ void walk(const Args<float>& a, const KstepArgs& r,
                                     const float* lam, const float* lm,
                                     const float* rho, double* slots,
                                     float4 (*buf)[NT]) {
  constexpr int OPS = 2 * K;  // row-operations per stage
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int lw = r.v.lw;
  const int xl = tid & (lw - 1);
  const int y = tid >> r.v.lw_log;
  const int last_y = (NT >> r.v.lw_log) - 1;
  const int64_t N0 = a.n[0];
  const int64_t supers = (N0 + r.rps - 1) / r.rps;
  const uint32_t tiles = r.v.tiles_m * r.v.tiles_l;
  const uint32_t per_row = r.rows1 * tiles;
  const uint32_t per_op = r.rps * per_row;
  const int64_t last_stage = supers + 3 * K - 2;
  int parity = 0;
  for (int64_t st = 0; st <= last_stage; ++st) {
    int first = 0;
    while (first < OPS && op_row(st, first) >= supers) ++first;
    int nact = 0;
    while (first + nact < OPS && op_row(st, first + nact) >= 0) ++nact;
    const uint32_t work = static_cast<uint32_t>(nact) * per_op;
    for (uint32_t w = blockIdx.x; w < work; w += gridDim.x) {
      // items numbered op-major, then the row of the super-row, then the
      // axis-1 row (4D), tile fastest; the same op and row for the block
      const uint32_t j = w / per_op;
      uint32_t rem = w - j * per_op;
      const uint32_t q = rem / per_row;
      rem -= q * per_row;
      const uint32_t r1 = rem / tiles;
      const int op = first + static_cast<int>(j);
      const int64_t row0 = op_row(st, op) * r.rps + q;
      if (row0 >= N0) continue;  // past the end of the last super-row
      const uint32_t row = static_cast<uint32_t>(row0) * r.rows1 + r1;
      const Item<ND> it = item_at<ND>(a, r.v, row, rem - r1 * tiles, y, xl);
      const int lev = op / 2;
      if (op % 2 == 0) {
        double acc = 0.0;
        dual_item<ND, FISTA, VEC, LOSSY>(a, it, lw, xl, y, tid, lam, rho[lev],
                                         false, false, buf, parity, acc);
        slots[3 * lev * NT + tid] += acc;
      } else {
        double s[4] = {0.0, 0.0, 0.0, 0.0};
        recon_item<ND, false, VEC>(a, it, lw, xl, y, last_y, tid, lm,
                                   nullptr, buf, parity, s);
        slots[(3 * lev + 1) * NT + tid] += s[1];
        slots[(3 * lev + 2) * NT + tid] += s[2];
      }
    }
    grid.sync();
  }
}

// One launch: the walk, then the 3K sums. kstep_kernel and kstepcap_kernel
// are its entry points.
template <int ND, bool FISTA, int K, bool LOSSY>
__device__ __forceinline__ void kstep_body(const Args<float>& a,
                                           const KstepArgs& r, int vec) {
  constexpr int SUMS = 3 * K;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ double slots[];  // [SUMS][NT]
  __shared__ float4 buf[2][NT];
  __shared__ double red[NT];
  __shared__ float rho[K];
  const int t = threadIdx.y * TX + threadIdx.x;
  float lam[ND], lm[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    lam[k] = a.lambda_inv[k];
    lm[k] = a.lam_mu[k];
  }
  if (t < K) rho[t] = FISTA ? r.rhos[t] : 0.0f;
#pragma unroll
  for (int j = 0; j < SUMS; ++j) slots[j * NT + t] = 0.0;
  __syncthreads();
  if (vec) {
    walk<ND, FISTA, K, true, LOSSY>(a, r, lam, lm, rho, slots, buf);
  } else {
    walk<ND, FISTA, K, false, LOSSY>(a, r, lam, lm, rho, slots, buf);
  }

  // fixed-tree reduction of every slot row over the block
  for (int h = NT / 2; h > 0; h >>= 1) {
    if (t < h) {
      for (int j = 0; j < SUMS; ++j) slots[j * NT + t] += slots[j * NT + t + h];
    }
    __syncthreads();
  }
  if (t == 0) {
    for (int j = 0; j < SUMS; ++j)
      r.partials[int64_t(j) * gridDim.x + blockIdx.x] = slots[j * NT];
  }
  grid.sync();
  if (blockIdx.x == 0) {
    for (int j = 0; j < SUMS; ++j) {
      double v = 0.0;
      for (int i = t; i < static_cast<int>(gridDim.x); i += NT)
        v += __ldcg(r.partials + int64_t(j) * gridDim.x + i);
      const double total = block_sum(v, red);
      if (t == 0) r.out[j] = static_cast<float>(total);
    }
  }
}

template <int ND, bool FISTA, int K, bool LOSSY>
__global__ void __launch_bounds__(NT) kstep_kernel(Args<float> a,
                                                   KstepArgs r, int vec) {
  static_assert(!LOSSY || FISTA, "lossy duals: FISTA only");
  kstep_body<ND, FISTA, K, LOSSY>(a, r, vec);
}

// The 4D FISTA launch, capped at 128 registers, 2 blocks per SM. Uncapped
// it takes 235 registers, one block per SM, and was 5-6% slower at
// 128^2 x 64^2 and 256^2 x 128^2 (PERF.md section 6, PR 9). The other
// instantiations keep __launch_bounds__(NT): given (NT, 1) they took more
// registers and lost 2-5% at 64 x 64 x 512. The 4D LOSSY launch keeps the
// cap.
template <int K, bool LOSSY>
__global__ void __launch_bounds__(NT, 2) kstepcap_kernel(Args<float> a,
                                                         KstepArgs r,
                                                         int vec) {
  kstep_body<4, true, K, LOSSY>(a, r, vec);
}

template <int ND, bool FISTA, int K, bool LOSSY>
const void* entry() {
  if constexpr (ND == 4 && FISTA) {
    return reinterpret_cast<const void*>(kstepcap_kernel<K, LOSSY>);
  } else {
    return reinterpret_cast<const void*>(kstep_kernel<ND, FISTA, K, LOSSY>);
  }
}

template <int ND, bool FISTA, bool LOSSY>
const void* kernel_for_k(int k) {
  switch (k) {
    case 3: return entry<ND, FISTA, 3, LOSSY>();
    case 4: return entry<ND, FISTA, 4, LOSSY>();
    case 6: return entry<ND, FISTA, 6, LOSSY>();
    case 8: return entry<ND, FISTA, 8, LOSSY>();
    default: return nullptr;
  }
}

template <int ND>
const void* kernel_for_nd(int fista, int k, int lossy) {
  if (lossy) return kernel_for_k<ND, true, true>(k);
  return fista ? kernel_for_k<ND, true, false>(k)
               : kernel_for_k<ND, false, false>(k);
}

// The instantiation for (ndim, fista, k, lossy); lossy needs fista (the
// callers check).
const void* kernel_for(int ndim, int fista, int k, int lossy) {
  return ndim == 4 ? kernel_for_nd<4>(fista, k, lossy)
                   : kernel_for_nd<3>(fista, k, lossy);
}

// Allows the instantiation its dynamic shared memory (above the 48 KB
// default with [3K][NT] slots at K = 8).
cudaError_t prepare(const void* fn, int k) {
  if (fn == nullptr) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes(k)));
}

}  // namespace

// The largest grid a cooperative launch of the (ndim, fista, k, lossy)
// kernel may have on the current device: resident blocks per SM of that
// exact instantiation (its registers and shared memory) times SMs. lossy
// (bfloat16 d) takes fista.
extern "C" int tv_kstep_max_blocks(int ndim, int fista, int k, int lossy,
                                   int* blocks) {
  if (lossy && !fista) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel_for(ndim, fista, k, lossy);
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
    int fista, int lossy, int k, int rows_per_stage, int nblocks,
    void* stream) {
  // lossy: the d arrays are bfloat16 (an unaccelerated launch has none)
  if (lossy && !fista) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel_for(ndim, fista, k, lossy);
  cudaError_t err = prepare(fn, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args<float> a{};
  a.orig = static_cast<const float*>(orig);
  a.recon = static_cast<float*>(recon);
  void* const bs[4] = {b0, b1, b2, b3};
  void* const dd[4] = {d0, d1, d2, d3};
  // VEC moves four elements per access: 16 bytes of a float array, 8 of a
  // bfloat16 d array
  int vec = aligned16(orig) && aligned16(recon);
  for (int q = 0; q < 4; ++q) {
    a.b[q] = static_cast<float*>(bs[q]);
    a.d[q] = static_cast<float*>(dd[q]);
    vec = vec && aligned16(bs[q]) &&
          (lossy ? aligned8(dd[q]) : aligned16(dd[q]));
  }
  const long long n[4] = {n0, n1, n2, n3};
  set_shape(a, ndim, n);
  a.lambda_inv = static_cast<const float*>(lambda_inv);
  a.lam_mu = static_cast<const float*>(lam_mu);
  a.bc = 2;  // Jia-Zhao
  KstepArgs r;
  r.rhos = static_cast<const float*>(rhos);
  r.partials = static_cast<double*>(partials);
  r.out = static_cast<float*>(out);
  long long rows1 = 1;
  for (int q = 1; q < ndim - 2; ++q) rows1 *= n[q];
  const long long tiles = set_tiles(r.v, n[ndim - 2], n[ndim - 1]);
  // the wrapper keeps R in 1 .. N0 and refuses a stage of 2^31 work items
  // or more, and 2^32 rows
  if (rows_per_stage < 1 || rows_per_stage > n0 ||
      2LL * k * rows_per_stage * rows1 * tiles >= (1LL << 31) ||
      n0 * rows1 >= (1LL << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  r.rows1 = static_cast<uint32_t>(rows1);
  r.rps = static_cast<uint32_t>(rows_per_stage);
  vec = vec && n[ndim - 1] % VW == 0;

  void* args[] = {&a, &r, &vec};
  // a grid above the cooperative limit is refused here, not shrunk
  err = cudaLaunchCooperativeKernel(fn, dim3(nblocks), dim3(TX, TY), args,
                                    smem_bytes(k),
                                    static_cast<cudaStream_t>(stream));
  // reading the last error also clears it, so a refused launch does not
  // surface again at the next launch's check
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
