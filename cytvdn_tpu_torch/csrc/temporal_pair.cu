// Two TV-denoising iterations in one cooperative launch on a Hopper card
// (sm_90a), float32, Jia-Zhao boundaries, anisotropic duals, 3D and 4D.
//
// Replaces the TPU kernel cytvdn_tpu/kernels/temporal.py::
// fused_pair_iteration (entry temporal.py:947, body _make_pair_kernel
// temporal.py:230, pallas_call temporal.py:1300). Each element's arithmetic
// is that of csrc/fused_iteration.cu (the same clip form, the same order of
// operations, no FMA contraction), so the state after one launch is bitwise
// equal to two K=1 launches and to two plain iterations. It returns both
// iterations' sums: sum|b|, sum|recon_new - recon|, sum|recon| and, with a
// reference cube (REF, the TPU kernel's `ref` operand, SSE at
// temporal.py:890-897), each iteration's sum (recon - ref)^2. Both squared
// errors come from the recon-2 element, which holds iteration 1's recon
// (for the delta sum) and iteration 2's at its own element: one extra load
// per element and pair.
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
// The dual element (wavefront.cuh's dual_elem) sends every load before its
// first store. A store of d_k sent while the load of its old value by the
// same thread was still in flight made the kernel 2.6x slower in 4D, and
// 6x in 3D where the compiler scheduled an element with per-axis loads
// that way; storing b_k first, whose value needs that load, removes it.
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
// - The reference cube is never written.
// - L1 is not coherent across SMs, and a block that read a row of R_0 in
//   dual-1 could later read its stale L1 copy after another block rewrote it
//   as R_1. Every load of the state goes through L2 (ld.global.cg); only
//   orig and ref, which nothing writes, are read through the read-only
//   path. The grid barrier orders each stage's stores before the next
//   stage's loads.
// Deeper levels (csrc/temporal_kstep.cu) follow the same pattern along
// axis 0 with whole rows: dual-l three rows behind dual-(l-1), recon-l two
// rows behind dual-l. The stage layout (op_row) lives in wavefront.cuh,
// with the scalar elements dual_elem and recon_elem that this kernel uses.
//
// Sums: each thread keeps six (REF: eight) double accumulators over all
// stages; after the last stage each block reduces them in a fixed order
// into per-block partials, and block 0 reduces those in a fixed order after
// one more grid barrier. The grid and the strip are fixed by the wrapper
// (the device's cooperative occupancy, the shape), so the traces repeat
// exactly from run to run; they may differ from two K=1 launches in the
// last bit after the cast.
//
// HALO0 (a shard of a mesh split along axis 0; the TPU kernel's halos0,
// temporal.py:230-249, 600-640, 810-832): the shard's rows are rows
// [a, a + N0) of a larger cube, and the Jia-Zhao row edges at its seams give
// way to the neighbour shards' pre-update bands (kernels/temporal.py::
// HALO0_KEYS): from the -1 shard its recon rows [-2, -1] and row -1 of
// orig, b_k, d_k; from the +1 shard its recon rows [0, 1], row 0 of orig,
// b_k, d_k and row 1 of b_0, d_0. first0/last0 mark the shards that hold
// the cube's first and last rows, where the Jia-Zhao edge stays. The
// iteration-1 values the seams need are recomputed from the bands, with the
// neighbour's own arithmetic (seam_dual, seam_recon1; the order of
// dual_elem and recon_elem, no FMA), never read from rows another block may
// have rewritten:
// - dual-1 at row 0 reads the -1 shard's row -1 of recon from its band;
// - dual-2 at row 0 reads the -1 shard's row -1 of iteration 1's recon,
//   recomputed from its bands and this shard's own row-0 b_0 at level 1
//   (the thread's own element, still b_1 until it writes b_2);
// - recon-1 at row N0-1 reads the +1 shard's row-0 b_0 at level 1,
//   recomputed from its bands and this row's recon, and leaves it (and
//   d_0) in a two-row scratch (`stash`) for recon-2, since recon-1
//   overwrites the recon it came from;
// - recon-2 at row N0-1 reads the +1 shard's row-0 b_0 at level 2,
//   recomputed from the +1 shard's iteration-1 recon at row 0 (its bands and
//   the stash) and this row's iteration-1 recon.
// At the cube's last row (last0) the forward neighbour is a literal zero,
// the value of Jia-Zhao's wrap: a shard's own row 0 is not the cube's and
// holds no zero there. The sums cover the shard's own rows only. Without
// HALO0 the instantiations compile to the code they were.
//
// HALO1 (a shard of a mesh split along axis 1; the TPU kernel's halos1,
// temporal.py:321-334, :450-457, :649-688, :704-711, :765-775, :816-869):
// the shard's columns are columns [j, j + N1) of a larger cube, and the
// Jia-Zhao column edges at its seams give way to the neighbour shards'
// pre-update column slabs (N0 x 1 x the trailing axes; kernels/
// temporal.py::HALO1_KEYS): from the -1 shard its recon columns [-2, -1]
// and column -1 of orig, b_k, d_k; from the +1 shard its recon columns
// [0, 1], column 0 of orig, b_k, d_k and column 1 of b_1, d_1. first1/
// last1 mark the shards that hold the cube's first and last columns. Each
// stage is one axis-0 row of the whole axis-1 extent, so the seam work is
// per row, at the first column (the duals) and the last (the recons):
// - dual-1 at column 0 reads the -1 shard's column -1 of recon;
// - dual-2 at column 0 reads the -1 shard's column -1 of iteration 1's
//   recon, recomputed from its bands (col_recon1: its b_0 from the band's
//   rows r-1, r, r+1, its b_1 from columns -2 and -1, the trailing axes
//   within the band) and this shard's own column-0 b_1 at level 1 (the
//   thread's own element, still b_1 until it writes b_2);
// - recon-1 at column N1-1 reads the +1 shard's column-0 b_1 at level 1,
//   recomputed from its bands and this column's recon, and leaves it and
//   d_1 in the stash for recon-2 (the row's slot of a [2][N0 x column]
//   scratch: recon-1 overwrites the recon it came from);
// - recon-2 at column N1-1 reads the +1 shard's column-0 b_1 at level 2,
//   recomputed from the +1 shard's iteration-1 recon at column 0 (its
//   bands, the stash and its column-1 b_1 from columns 0 and 1) and this
//   column's iteration-1 recon.
// The stash, not the K=1 kernel's in-place recompute (tv_elem.cuh
// seam_b), because recon-2 needs the +1 shard's level-1 b_1 and d_1 three
// stages after the recon they came from is gone; HALO0's stash already
// does this for one row, and here every row's last column needs it, so
// the stash holds a column slab per value (2 x 16.8 MB at config 4's
// (1, 2, 1, 1) shard, against the 4.3 GB state arrays). At the cube's
// last column (last1) the forward neighbour is a literal zero: the port's
// Jia-Zhao wrap reads b_1 at column 0 (fwd), which on any shard but the
// first is not the cube's column 0 and not zero. So a HALO1 launch never
// reads its own column 0 through the wrap, and the axis-1 wrap hazard
// below does not arise. Stash entries are written once per launch by
// recon-1 and read by recon-2 three stages later, through L2. The sums
// cover the shard's own columns only. JAX never takes both halo modes in
// one launch (temporal.py:995); 2D grids pair there, and in the port,
// with HALO0 and a seam repair after the launch (parallel/pairfix.py),
// which knows that this kernel's wrap reads the shard's own column 0.
// Without HALO1 the instantiations compile to the code they were.
//
// LOSSY (lossy duals, FISTA only; the TPU kernel's bfloat16 d0 operands
// and its mid-pair rounding qd1, temporal.py:414-424, :474-482, :621-625):
// PairArgs::d holds bfloat16 arrays. The dual elements load the old d
// widened, compute in float, store b from the unrounded d_new and then d
// rounded to nearest even (wavefront.cuh dual_elem). Dual-1's bfloat16
// store of d_1 is qd1 for the shard's own rows: dual-2 reads the rounded
// value back, as the K=1 kernel's second launch reads it from its d. The
// one d_1 value that does not go through the d array is HALO0's stash of
// the +1 shard's recomputed row-0 d_0 at level 1, which recon-2 reads as
// the old d of level 2: it is rounded with round_bf16 (the TPU kernel's
// s_d1n0 = qd1(cv)). The bands p_d, n_d and n_d0_r1 hold pre-pair values,
// float32 (the neighbour's bfloat16 rows widened exactly); the stash stays
// float. HALO1's stash of the +1 shard's recomputed column-0 d_1 goes
// through round_bf16 the same way, and its column bands are float32 too.
// Without LOSSY the instantiations compile to the code they were.
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
constexpr int MAX_SUMS = 3 * LEVELS + 2;

struct PairArgs {
  const float* orig;
  float* recon;
  float* b[4];
  float* d[4];       // LOSSY: bfloat16 arrays
  const float* lambda_inv;
  const float* lam_mu;
  const float* rho[LEVELS];
  const float* ref;  // reference cube for the SSE (REF)
  double* partials;  // [SUMS][gridDim.x]
  float* out;        // [SUMS]: per level sum|b|, sum|dR|, sum|R|; (REF)
                     // per level sum (R - ref)^2
  int64_t n[4];      // extents of the ndim axes
  int64_t s[4];      // element strides of the ndim axes
  int64_t rows1;     // product of the axes between 0 and the tiled pair
  int64_t tiles_m;   // tiles of TY along axis ndim-2
  int64_t tiles_l;   // tiles of TX along axis ndim-1
  int64_t strip;     // W, axis-1 indices per strip, 1 .. n[1]
  // HALO0: the neighbour shards' pre-update bands (rows of s[0] elements)
  const float* p_r0;       // -1 shard: recon rows [-2, -1]
  const float* p_orig;     // -1 shard: orig row -1
  const float* p_acc[4];   // -1 shard: b_k row -1
  const float* p_d[4];     // -1 shard: d_k row -1 (FISTA)
  const float* n_r0;       // +1 shard: recon rows [0, 1]
  const float* n_orig;     // +1 shard: orig row 0
  const float* n_acc[4];   // +1 shard: b_k row 0
  const float* n_d[4];     // +1 shard: d_k row 0 (FISTA)
  const float* n_acc0_r1;  // +1 shard: b_0 row 1
  const float* n_d0_r1;    // +1 shard: d_0 row 1 (FISTA)
  float* stash;            // [2][row]: the +1 shard's row-0 b_0, d_0 at level 1
                           // (HALO1: [2][column slab], its column-0 b_1, d_1)
  int first0;              // this shard holds the cube's first row
  int last0;               // this shard holds the cube's last row
  // HALO1: the neighbour shards' pre-update column slabs (N0 x s[1]
  // elements each); p_orig, p_acc, p_d hold the -1 shard's column -1 and
  // n_orig, n_acc, n_d the +1 shard's column 0
  const float* p_c[2];     // -1 shard: recon columns [-2, -1]
  const float* n_c[2];     // +1 shard: recon columns [0, 1]
  const float* n_acc1_c1;  // +1 shard: b_1 column 1
  const float* n_d1_c1;    // +1 shard: d_1 column 1 (FISTA)
  int first1;              // this shard holds the cube's first column
  int last1;               // this shard holds the cube's last column
};

// One dual update of one element along one axis from the values it reads,
// in dual_elem's order of operations: returns b_new and sets dn (d_new).
template <bool FISTA>
__device__ __forceinline__ float seam_dual(float x, float xb, float bo,
                                           float dold, float lam, float rho,
                                           float& dn) {
  const float diff = x - xb;
  dn = fminf(fmaxf(diff + bo, -lam), lam);
  return FISTA ? dn + rho * (dn - dold) : dn;
}

// Iteration 1's recon of the element at in-row offset `off` of a
// neighbour's band row, in recon_elem's order of operations: `x` is that
// row's recon before the pair, `acc`/`d` its b_k/d_k rows, `og` its orig;
// b0 is its b_0 at level 1 at the element and b0f that of the row after it.
// The in-row b_k (k >= 1) at the element and at its forward neighbour are
// recomputed from the row (Jia-Zhao: the wrap's b_k at index 0 is zero,
// and the recompute gives that zero).
template <int ND, bool FISTA>
__device__ __forceinline__ float seam_recon1(
    const float* x, const float* const* acc, const float* const* d, float og,
    float b0, float b0f, int64_t off, const int64_t* c, const int64_t* n,
    const int64_t* s, const float* lam, const float* lm, float rho) {
  float div = 0.0f;
  div = div + lm[0] * (b0 - b0f);
  const float xo = __ldg(x + off);
#pragma unroll
  for (int k = 1; k < ND; ++k) {
    const bool wrap = c[k] == n[k] - 1;
    const int64_t f = wrap ? off - (n[k] - 1) * s[k] : off + s[k];
    const int64_t b = c[k] > 0 ? off - s[k] : off;
    const float xf = __ldg(x + f);
    float dn;
    const float bk = seam_dual<FISTA>(xo, __ldg(x + b), __ldg(acc[k] + off),
                                      FISTA ? __ldg(d[k] + off) : 0.0f,
                                      lam[k], rho, dn);
    const float bf = seam_dual<FISTA>(xf, wrap ? xf : xo, __ldg(acc[k] + f),
                                      FISTA ? __ldg(d[k] + f) : 0.0f, lam[k],
                                      rho, dn);
    div = div + lm[k] * (bk - bf);
  }
  return og - div;
}

// Iteration 1's recon of the element at offset `off` of a neighbour's
// column band (N0 x 1 x the trailing axes, axis-0 stride s[1]), in
// recon_elem's order of operations: `x` is that column's recon before the
// pair, `acc`/`d` its b_k/d_k columns, `og` its orig; b1 is its b_1 at
// level 1 at the element and b1f that of the column after it. Its b_0 and
// the trailing axes' b_k at the element and at its forward neighbour are
// recomputed from the band (Jia-Zhao: the wrap's b_k at index 0 is zero,
// and the recompute gives that zero). The column band spans all of axis
// 0: an axis-1 mesh does not split axis 0.
template <int ND, bool FISTA>
__device__ __forceinline__ float col_recon1(
    const float* x, const float* const* acc, const float* const* d, float og,
    float b1, float b1f, int64_t off, const int64_t* c, const int64_t* n,
    const int64_t* s, const float* lam, const float* lm, float rho) {
  float div = 0.0f;
  const float xo = __ldg(x + off);
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    if (k == 1) {
      div = div + lm[1] * (b1 - b1f);
      continue;
    }
    const int64_t sk = k == 0 ? s[1] : s[k];
    const bool wrap = c[k] == n[k] - 1;
    const int64_t f = wrap ? off - (n[k] - 1) * sk : off + sk;
    const int64_t b = c[k] > 0 ? off - sk : off;
    const float xf = __ldg(x + f);
    float dn;
    const float bk = seam_dual<FISTA>(xo, __ldg(x + b), __ldg(acc[k] + off),
                                      FISTA ? __ldg(d[k] + off) : 0.0f,
                                      lam[k], rho, dn);
    const float bf = seam_dual<FISTA>(xf, wrap ? xf : xo, __ldg(acc[k] + f),
                                      FISTA ? __ldg(d[k] + f) : 0.0f, lam[k],
                                      rho, dn);
    div = div + lm[k] * (bk - bf);
  }
  return og - div;
}

// The momentum of level `lev` (0 or 1). Indexing rho[] at run time puts the
// array in local memory (one 8-byte stack slot, an LDL per dual element);
// the LOSSY instantiations pick it from registers instead. The exact ones
// keep the indexed load, and so the code they compiled to.
template <bool LOSSY>
__device__ __forceinline__ float level_rho(const float* rho, int lev) {
  return LOSSY ? (lev == 0 ? rho[0] : rho[1]) : rho[lev];
}

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

// The halo mode of an instantiation: no bands, axis-0 bands (a shard of an
// axis-0 mesh) or axis-1 bands (a shard of an axis-1 mesh).
constexpr int NO_HALO = 0, HALO_AXIS0 = 1, HALO_AXIS1 = 2;

template <int ND, bool FISTA, bool REF, int HALO, bool LOSSY>
__global__ void __launch_bounds__(NT) pair_kernel(PairArgs a) {
  static_assert(!LOSSY || FISTA, "lossy duals: FISTA only");
  constexpr bool HALO0 = HALO == HALO_AXIS0;
  constexpr bool HALO1 = HALO == HALO_AXIS1;
  constexpr int SUMS = REF ? MAX_SUMS : 3 * LEVELS;
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
  double acc[MAX_SUMS];
#pragma unroll
  for (int j = 0; j < MAX_SUMS; ++j) acc[j] = 0.0;

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
        const int64_t R = a.s[0];  // elements per row
        if (op % 2 == 0) {
          double v;
          if (HALO0 && row == 0 && !a.first0) {
            // the -1 shard's last row of the recon this level reads
            float xb0;
            if (lev == 0) {
              xb0 = __ldg(a.p_r0 + R + idx);
            } else {
              float dn;
              const float b0p = seam_dual<FISTA>(
                  __ldg(a.p_r0 + R + idx), __ldg(a.p_r0 + idx),
                  __ldg(a.p_acc[0] + idx),
                  FISTA ? __ldg(a.p_d[0] + idx) : 0.0f, lam[0], rho[0], dn);
              xb0 = seam_recon1<ND, FISTA>(
                  a.p_r0 + R, a.p_acc, a.p_d, __ldg(a.p_orig + idx), b0p,
                  ld(a.b[0] + idx), idx, c, a.n, a.s, lam, lm, rho[0]);
            }
            v = dual_elem<ND, FISTA, 0, LOSSY>(
                a, idx, c, lam, level_rho<LOSSY>(rho, lev), xb0);
          } else if (HALO1 && c[1] == 0 && !a.first1) {
            // the -1 shard's last column of the recon this level reads
            const int64_t co = idx - c[0] * (a.s[0] - a.s[1]) - c[1] * a.s[1];
            float xb1;
            if (lev == 0) {
              xb1 = __ldg(a.p_c[1] + co);
            } else {
              float dn;
              const float b1p = seam_dual<FISTA>(
                  __ldg(a.p_c[1] + co), __ldg(a.p_c[0] + co),
                  __ldg(a.p_acc[1] + co),
                  FISTA ? __ldg(a.p_d[1] + co) : 0.0f, lam[1], rho[0], dn);
              xb1 = col_recon1<ND, FISTA>(
                  a.p_c[1], a.p_acc, a.p_d, __ldg(a.p_orig + co), b1p,
                  ld(a.b[1] + idx), co, c, a.n, a.s, lam, lm, rho[0]);
            }
            v = dual_elem<ND, FISTA, 1, LOSSY>(
                a, idx, c, lam, level_rho<LOSSY>(rho, lev), xb1);
          } else {
            v = dual_elem<ND, FISTA, -1, LOSSY>(
                a, idx, c, lam, level_rho<LOSSY>(rho, lev), 0.0f);
          }
          if (lev == 0) acc[0] += v; else acc[3] += v;
        } else if (HALO0 && row == N0 - 1) {
          // the +1 shard's first row of b_0 at this level; Jia-Zhao's zero
          // at the cube's last row
          float bf0 = 0.0f;
          if (!a.last0) {
            const int64_t off = idx - row * R;
            const float ro = ld(a.recon + idx);
            float dn;
            if (lev == 0) {
              bf0 = seam_dual<FISTA>(__ldg(a.n_r0 + off), ro,
                                     __ldg(a.n_acc[0] + off),
                                     FISTA ? __ldg(a.n_d[0] + off) : 0.0f,
                                     lam[0], rho[0], dn);
              a.stash[off] = bf0;
              // LOSSY: the +1 shard stores this d_1 as bfloat16, and its
              // dual-2 reads it rounded (qd1)
              if (FISTA) a.stash[R + off] = LOSSY ? round_bf16(dn) : dn;
            } else {
              const float b1n = __ldcg(a.stash + off);
              const float d1n = FISTA ? __ldcg(a.stash + R + off) : 0.0f;
              const float b1n_r1 = seam_dual<FISTA>(
                  __ldg(a.n_r0 + R + off), __ldg(a.n_r0 + off),
                  __ldg(a.n_acc0_r1 + off),
                  FISTA ? __ldg(a.n_d0_r1 + off) : 0.0f, lam[0], rho[0], dn);
              const float r1n = seam_recon1<ND, FISTA>(
                  a.n_r0, a.n_acc, a.n_d, __ldg(a.n_orig + off), b1n, b1n_r1,
                  off, c, a.n, a.s, lam, lm, rho[0]);
              bf0 = seam_dual<FISTA>(r1n, ro, b1n, d1n, lam[0], rho[1], dn);
            }
          }
          if (lev == 0) {
            recon_elem<ND, false, 0>(a, idx, c, lm, acc[1], acc[2], acc[6],
                                     acc[7], bf0);
          } else {
            recon_elem<ND, REF, 0>(a, idx, c, lm, acc[4], acc[5], acc[6],
                                   acc[7], bf0);
          }
        } else if (HALO1 && c[1] == N1 - 1) {
          // the +1 shard's first column of b_1 at this level; Jia-Zhao's
          // zero at the cube's last column
          float bf1 = 0.0f;
          if (!a.last1) {
            const int64_t co = idx - c[0] * (a.s[0] - a.s[1]) - c[1] * a.s[1];
            const int64_t CS = N0 * a.s[1];  // elements per column slab
            const float ro = ld(a.recon + idx);
            float dn;
            if (lev == 0) {
              bf1 = seam_dual<FISTA>(__ldg(a.n_c[0] + co), ro,
                                     __ldg(a.n_acc[1] + co),
                                     FISTA ? __ldg(a.n_d[1] + co) : 0.0f,
                                     lam[1], rho[0], dn);
              a.stash[co] = bf1;
              // LOSSY: the +1 shard stores this d_1 as bfloat16, and its
              // dual-2 reads it rounded (qd1)
              if (FISTA) a.stash[CS + co] = LOSSY ? round_bf16(dn) : dn;
            } else {
              const float b1n = __ldcg(a.stash + co);
              const float d1n = FISTA ? __ldcg(a.stash + CS + co) : 0.0f;
              const float b1n_c1 = seam_dual<FISTA>(
                  __ldg(a.n_c[1] + co), __ldg(a.n_c[0] + co),
                  __ldg(a.n_acc1_c1 + co),
                  FISTA ? __ldg(a.n_d1_c1 + co) : 0.0f, lam[1], rho[0], dn);
              const float r1n = col_recon1<ND, FISTA>(
                  a.n_c[0], a.n_acc, a.n_d, __ldg(a.n_orig + co), b1n,
                  b1n_c1, co, c, a.n, a.s, lam, lm, rho[0]);
              bf1 = seam_dual<FISTA>(r1n, ro, b1n, d1n, lam[1], rho[1], dn);
            }
          }
          if (lev == 0) {
            recon_elem<ND, false, 1>(a, idx, c, lm, acc[1], acc[2], acc[6],
                                     acc[7], bf1);
          } else {
            recon_elem<ND, REF, 1>(a, idx, c, lm, acc[4], acc[5], acc[6],
                                   acc[7], bf1);
          }
        } else if (lev == 0) {
          recon_elem<ND, false, -1>(a, idx, c, lm, acc[1], acc[2], acc[6],
                                    acc[7], 0.0f);
        } else {
          recon_elem<ND, REF, -1>(a, idx, c, lm, acc[4], acc[5], acc[6],
                                  acc[7], 0.0f);
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

template <int ND, bool FISTA, int HALO, bool LOSSY>
const void* kernel_for_ref(int ref) {
  return ref ? reinterpret_cast<const void*>(
                   pair_kernel<ND, FISTA, true, HALO, LOSSY>)
             : reinterpret_cast<const void*>(
                   pair_kernel<ND, FISTA, false, HALO, LOSSY>);
}

template <int ND, bool FISTA, bool LOSSY>
const void* kernel_for_halo(int ref, int halo) {
  if (halo == HALO_AXIS1)
    return kernel_for_ref<ND, FISTA, HALO_AXIS1, LOSSY>(ref);
  return halo == HALO_AXIS0 ? kernel_for_ref<ND, FISTA, HALO_AXIS0, LOSSY>(ref)
                            : kernel_for_ref<ND, FISTA, NO_HALO, LOSSY>(ref);
}

template <int ND>
const void* kernel_for_nd(int fista, int ref, int halo, int lossy) {
  if (lossy) return kernel_for_halo<ND, true, true>(ref, halo);
  return fista ? kernel_for_halo<ND, true, false>(ref, halo)
               : kernel_for_halo<ND, false, false>(ref, halo);
}

// The instantiation for (ndim, fista, ref, halo, lossy); lossy needs fista
// and halo is NO_HALO, HALO_AXIS0 or HALO_AXIS1 (the callers check).
const void* kernel_for(int ndim, int fista, int ref, int halo, int lossy) {
  return ndim == 4 ? kernel_for_nd<4>(fista, ref, halo, lossy)
                   : kernel_for_nd<3>(fista, ref, halo, lossy);
}

}  // namespace

// The largest grid a cooperative launch of the (ndim, fista, ref, halo,
// lossy) kernel may have on the current device: resident blocks per SM
// times SMs. halo: 0 none, 1 axis-0 bands, 2 axis-1 bands; lossy (bfloat16
// d) takes fista.
extern "C" int tv_pair_max_blocks(int ndim, int fista, int ref, int halo,
                                  int lossy, int* blocks) {
  if (lossy && !fista) return static_cast<int>(cudaErrorInvalidValue);
  if (halo < NO_HALO || halo > HALO_AXIS1)
    return static_cast<int>(cudaErrorInvalidValue);
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
      &per_sm, kernel_for(ndim, fista, ref, halo, lossy), NT, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = per_sm * sms;
  return 0;
}

extern "C" int tv_pair_iteration_f32(
    const void* orig, void* recon, void* b0, void* b1, void* b2, void* b3,
    void* d0, void* d1, void* d2, void* d3, const void* lambda_inv,
    const void* lam_mu, const void* rho1, const void* rho2, const void* ref,
    void* partials, void* out, const void* const* bands, int halo,
    int at_first, int at_last, int ndim, long long n0, long long n1,
    long long n2, long long n3, long long strip, int fista, int lossy,
    int nblocks, void* stream) {
  // lossy: the d arrays are bfloat16 (an unaccelerated launch has none)
  if (lossy && !fista) return static_cast<int>(cudaErrorInvalidValue);
  // halo: 0 none, 1 axis-0 bands (HALO0), 2 axis-1 bands (HALO1, which
  // needs two columns)
  if (halo < NO_HALO || halo > HALO_AXIS1 ||
      (halo != NO_HALO) != (bands != nullptr) ||
      (halo == HALO_AXIS1 && n1 < 2))
    return static_cast<int>(cudaErrorInvalidValue);
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
  a.ref = static_cast<const float*>(ref);
  a.partials = static_cast<double*>(partials);
  a.out = static_cast<float*>(out);
  a.rows1 = 1;
  for (int k = 1; k < ndim - 2; ++k) a.rows1 *= a.n[k];
  a.tiles_m = (a.n[ndim - 2] + TY - 1) / TY;
  a.tiles_l = (a.n[ndim - 1] + TX - 1) / TX;
  a.strip = strip < 1 ? 1 : (strip > a.n[1] ? a.n[1] : strip);
  // the bands, in kernels/temporal.py's order (HALO0_KEYS or HALO1_KEYS),
  // then the stash. HALO0: p_r0, p_orig, p_acc0..3, p_d0..3, n_r0, n_orig,
  // n_acc0..3, n_d0..3, n_acc0_r1, n_d0_r1; HALO1: p_r0_m2, p_r0_m1,
  // p_orig_m1, p_acc0..3_m1, p_d0..3_m1, n_r0_c0, n_r0_c1, n_orig_c0,
  // n_acc0..3_c0, n_d0..3_c0, n_acc1_c1, n_d1_c1
  const void* const* h = bands;
  auto hp = [h](int i) {
    return h != nullptr ? static_cast<const float*>(h[i]) : nullptr;
  };
  const bool cols = halo == HALO_AXIS1;
  const int o = cols ? 1 : 0;  // HALO1 has one more recon band per side
  a.p_r0 = cols ? nullptr : hp(0);
  a.n_r0 = cols ? nullptr : hp(10);
  a.p_c[0] = cols ? hp(0) : nullptr;
  a.p_c[1] = cols ? hp(1) : nullptr;
  a.n_c[0] = cols ? hp(11) : nullptr;
  a.n_c[1] = cols ? hp(12) : nullptr;
  a.p_orig = hp(1 + o);
  a.n_orig = hp(11 + 2 * o);
  for (int k = 0; k < 4; ++k) {
    a.p_acc[k] = hp(2 + o + k);
    a.p_d[k] = hp(6 + o + k);
    a.n_acc[k] = hp(12 + 2 * o + k);
    a.n_d[k] = hp(16 + 2 * o + k);
  }
  a.n_acc0_r1 = cols ? nullptr : hp(20);
  a.n_d0_r1 = cols ? nullptr : hp(21);
  a.n_acc1_c1 = cols ? hp(22) : nullptr;
  a.n_d1_c1 = cols ? hp(23) : nullptr;
  a.stash = const_cast<float*>(hp(22 + 2 * o));
  a.first0 = halo == HALO_AXIS0 ? at_first : 1;
  a.last0 = halo == HALO_AXIS0 ? at_last : 1;
  a.first1 = cols ? at_first : 1;
  a.last1 = cols ? at_last : 1;

  void* args[] = {&a};
  // a grid above the cooperative limit is refused here, not shrunk
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel_for(ndim, fista, ref != nullptr, halo, lossy),
      dim3(nblocks), dim3(TX, TY),
      args, 0, static_cast<cudaStream_t>(stream));
  // reading the last error also clears it, so a refused launch does not
  // surface again at the next launch's check
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
