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
//   (a) dual_kernel writes every axis's b and d at each element and reads
//       only the old recon, which no block writes in this launch;
//   (b) recon_kernel reads the new b (read-only by then) and reads and
//       writes recon at the same element only.
//   Double-buffering the state instead would not fit: the 256^2 x 128^2
//   FISTA state is 10 arrays of 4.29 GB. The price is 5n+4 traversals per
//   FISTA iteration (24 in 4D) against 4n+3 (19) for one pass; fusing the
//   two passes back into one is left to a later change.
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
//
// Layout: a block is 32 x 8 threads over a tile of the two trailing axes
// (x along the contiguous last axis). Work items are (row, tile) pairs, the
// tile index fastest, the leading axes (one in 3D, two in 4D) flattened into
// rows; blocks stride over them, so blocks in flight together cover
// neighbouring tiles of a row and stream through memory. Index arithmetic is
// 32-bit (the wrapper keeps the work-item count below 2^31); element offsets
// are 64-bit. The rank is a template parameter, so the per-axis scalars live
// in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int NT = TX * TY;

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
  double* partials;  // [3][gridDim.x]
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

// Fixed-order tree sum over the block; thread 0 gets the total.
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

// Walk this block's (row, tile) work items and call body(idx, c) with each
// element's offset and coordinates. Threads past the ragged edge of a tile
// skip it.
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

template <typename T, int ND, bool FISTA>
__global__ void __launch_bounds__(NT) dual_kernel(Args<T> a) {
  __shared__ double red[NT];
  T lam[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) lam[k] = a.lambda_inv[k];
  const T rho = FISTA ? *a.rho : T(0);
  const bool iso_r = ND == 4 && a.iso_r;
  const bool iso_q = ND == 4 && a.iso_q;
  double acc = 0.0;
  for_each_element<ND>(a, [&](int64_t idx, const int64_t* c) {
    const T x = a.recon[idx];
    // Unrolled in 4D only: unrolled in 3D, this loop measured 3x slower on
    // an H100 at 256x256x2048 FISTA (13.1 vs 4.3 ms, rolled), in 4D 12%
    // faster at 256^2 x 128^2 (48.7 vs 55.6 ms).
#pragma unroll (ND == 4 ? 4 : 1)
    for (int k = 0; k < ND; ++k) {
      if ((k == 1 && iso_r) || (k == 3 && iso_q)) continue;  // done with k-1
      if ((k == 0 && iso_r) || (k == 2 && iso_q)) {
        // the pair shares axis k's clip radius (reference cyTVDN.py:160-162)
        const T e1 = x - a.recon[bwd(idx, c[k], a.n[k], a.s[k], a.bc)] + a.b[k][idx];
        const T e2 = x - a.recon[bwd(idx, c[k + 1], a.n[k + 1], a.s[k + 1], a.bc)]
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
      } else {
        const T diff = x - a.recon[bwd(idx, c[k], a.n[k], a.s[k], a.bc)];
        const T dn = clip_(diff + a.b[k][idx], lam[k]);
        T bn = dn;
        if (FISTA) {
          bn = dn + rho * (dn - a.d[k][idx]);
          a.d[k][idx] = dn;
        }
        a.b[k][idx] = bn;
        acc += static_cast<double>(abs_(bn));
      }
    }
  });
  const double total = block_sum(acc, red);
  if (threadIdx.x == 0 && threadIdx.y == 0) a.partials[blockIdx.x] = total;
}

template <typename T, int ND>
__global__ void __launch_bounds__(NT) recon_kernel(Args<T> a) {
  __shared__ double red[NT];
  T lm[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) lm[k] = a.lam_mu[k];
  double dnum = 0.0, dden = 0.0;
  for_each_element<ND>(a, [&](int64_t idx, const int64_t* c) {
    T div = T(0);
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      const T bk = a.b[k][idx];
      const T bf = a.b[k][fwd(idx, c[k], a.n[k], a.s[k], a.bc)];
      div = div + lm[k] * (bk - bf);
    }
    const T rn = a.orig[idx] - div;
    const T ro = a.recon[idx];
    dnum += static_cast<double>(abs_(rn - ro));
    dden += static_cast<double>(abs_(ro));
    a.recon[idx] = rn;
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

template <typename T>
int launch(const void* orig, void* recon, void* const b[4], void* const d[4],
           const void* lambda_inv, const void* lam_mu, const void* rho,
           void* partials, void* out, int ndim, const long long n[4],
           int fista, int bc, int iso_r, int iso_q, int nblocks,
           cudaStream_t stream) {
  Args<T> a;
  a.orig = static_cast<const T*>(orig);
  a.recon = static_cast<T*>(recon);
  for (int k = 0; k < 4; ++k) {
    a.b[k] = static_cast<T*>(b[k]);
    a.d[k] = static_cast<T*>(d[k]);
    a.n[k] = k < ndim ? n[k] : 1;
  }
  int64_t stride = 1;
  for (int k = ndim - 1; k >= 0; --k) {
    a.s[k] = stride;
    stride *= a.n[k];
  }
  for (int k = ndim; k < 4; ++k) a.s[k] = 0;
  a.lambda_inv = static_cast<const T*>(lambda_inv);
  a.lam_mu = static_cast<const T*>(lam_mu);
  a.rho = static_cast<const T*>(rho);
  a.partials = static_cast<double*>(partials);
  a.out = static_cast<T*>(out);
  a.rows = 1;
  for (int k = 0; k < ndim - 2; ++k) a.rows *= a.n[k];
  a.tiles_m = (a.n[ndim - 2] + TY - 1) / TY;
  a.tiles_l = (a.n[ndim - 1] + TX - 1) / TX;
  a.bc = bc;
  a.iso_r = iso_r;
  a.iso_q = iso_q;

  const dim3 block(TX, TY);
  const dim3 grid(nblocks);
  if (ndim == 4 && fista) {
    dual_kernel<T, 4, true><<<grid, block, 0, stream>>>(a);
  } else if (ndim == 4) {
    dual_kernel<T, 4, false><<<grid, block, 0, stream>>>(a);
  } else if (fista) {
    dual_kernel<T, 3, true><<<grid, block, 0, stream>>>(a);
  } else {
    dual_kernel<T, 3, false><<<grid, block, 0, stream>>>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ndim == 4) {
    recon_kernel<T, 4><<<grid, block, 0, stream>>>(a);
  } else {
    recon_kernel<T, 3><<<grid, block, 0, stream>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finalize_kernel<T><<<1, block, 0, stream>>>(a.partials, nblocks, a.out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define TV_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const void* orig, void* recon, void* b0, void* b1,     \
                      void* b2, void* b3, void* d0, void* d1, void* d2,      \
                      void* d3, const void* lambda_inv, const void* lam_mu,  \
                      const void* rho, void* partials, void* out, int ndim,  \
                      long long n0, long long n1, long long n2, long long n3, \
                      int fista, int bc, int iso_r, int iso_q, int nblocks,  \
                      void* stream) {                                        \
    void* const b[4] = {b0, b1, b2, b3};                                     \
    void* const d[4] = {d0, d1, d2, d3};                                     \
    const long long n[4] = {n0, n1, n2, n3};                                 \
    return launch<T>(orig, recon, b, d, lambda_inv, lam_mu, rho, partials,   \
                     out, ndim, n, fista, bc, iso_r, iso_q, nblocks,         \
                     static_cast<cudaStream_t>(stream));                     \
  }

TV_ENTRY(tv_fused_iteration_f32, float)
TV_ENTRY(tv_fused_iteration_f64, double)

extern "C" const char* tv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
