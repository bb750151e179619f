// The thread block every kernel of this package launches: 32 x 8 threads,
// and the block's fixed-order tree sum. tv_elem.cuh (the one-iteration and
// whole-run kernels) and wavefront.cuh (the pair and K-step kernels) both
// build on it, so a source may include both.

#pragma once

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int NT = TX * TY;

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

}  // namespace
