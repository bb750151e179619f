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
// - Seams (the HALO instantiations: out-of-core slabs and mesh shards):
//   the TPU kernel recomputes the +1 neighbour's first updated b slab at a
//   trailing edge from halo operands. Here the dual pass reads only the old
//   recon, so the threads at a halo axis's last index (the block's last row
//   along axis 0, its last column, and on meshes that split axes 2 or 3
//   the threads at that axis's last index, whatever tile they are in) also
//   compute that slab and store it into a one-slab scratch buffer
//   (tv_elem.cuh Halos::bhat); the recon pass reads it in place of the
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
//   caller's lossy argument; float FISTA Jia-Zhao anisotropic launches, the
//   mode's scope): d is stored as bfloat16, as the TPU kernel stores it
//   under lossy_duals (fused.py:555-566, :1230-1233). Loads widen exactly,
//   stores round to nearest even, the arithmetic stays float
//   (tv_elem.cuh dual_elem_lossy). Each axis stores b before d, so that
//   the 2-byte d store is not sent while the load of the old d at its
//   address is in flight. The recon pass and finalize_kernel never read d
//   and are shared with the exact launches; the HALO seam operand next_d
//   stays float. LOSSY is a template flag, so the exact instantiations are
//   the code they were.
//
// Layout, boundary offsets and the element arithmetic live in tv_elem.cuh,
// shared with the whole-run kernel (resident.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tv_elem.cuh"

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
  const cudaError_t err =
      with_halo
          ? launch_passes<T, true>(a, h, ndim, fista, lossy, grid, block, stream)
          : launch_passes<T, false>(a, h, ndim, fista, lossy, grid, block,
                                    stream);
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

extern "C" const char* tv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
