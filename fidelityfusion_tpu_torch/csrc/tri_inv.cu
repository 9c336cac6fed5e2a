// K3b: W = L^{-1} for lower-triangular L, batched, from the diagonal-block
// inverses W_kk that the factorization's leaf already produced.
//
// Replaces benchmarks/retired/pallas_batched.py:tri_inv_vmem (pallas_call at
// :190, body _tri_inv_vmem_kernel :139, _tri_inv_recursive :94): the
// row-block recurrence
//   W[k, k] = W_kk,   W[k, j] = -W_kk (sum_{i=j}^{k-1} L[k, i] W[i, j])  (j < k),
//   W[k, j] = 0  (j > k).
// One launch per block row k (rows depend on earlier block rows); one CTA per
// (column block j, matrix) chains the 64x64 tile GEMMs of the sum in
// registers, stages the sum in shared memory and multiplies by W_kk.  The
// upper triangle is written as zeros, so every element of W is written once.
//
// Bound on the H100: operations, n^3/3 per matrix at the fp32 rate.  This
// simple version balances work badly (CTA j of row k does k - j tile GEMMs)
// and launches n/64 times; both are later work.
#include "common.cuh"

using ff::NTHREADS;
using ff::TB;
using ff::TPAD;

namespace {

__global__ void tri_inv_row_kernel(const float* __restrict__ L,
                                   const float* __restrict__ Wd,
                                   float* __restrict__ W, int n, int k) {
  __shared__ float As[TB][TPAD];
  __shared__ float Bs[TB][TPAD];
  const int j = blockIdx.x;
  const int nb = n / TB;
  const size_t b = blockIdx.y;
  const float* Lb = L + b * n * n;
  float* Wb = W + b * n * n;
  const float* Wk = Wd + (b * nb + k) * TB * TB;
  float* out = Wb + (size_t)k * TB * n + (size_t)j * TB;
  if (j >= k) {
    for (int e = threadIdx.x; e < TB * TB; e += NTHREADS) {
      out[(size_t)(e / TB) * n + e % TB] = j == k ? Wk[e] : 0.f;
    }
    return;
  }
  float acc[4][4] = {};
  for (int i = j; i < k; ++i) {
    ff::load_tile(As, Lb + (size_t)k * TB * n + (size_t)i * TB, n);  // L[k, i]
    ff::load_tile(Bs, Wb + (size_t)i * TB * n + (size_t)j * TB, n);  // W[i, j]
    __syncthreads();
    ff::tile_fma(As, Bs, acc);
    __syncthreads();
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) Bs[ty + 16 * i][tx + 16 * q] = acc[i][q];
  ff::load_tile(As, Wk, TB);
  __syncthreads();
  float res[4][4] = {};
  ff::tile_fma(As, Bs, res);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      out[(size_t)(ty + 16 * i) * n + tx + 16 * q] = -res[i][q];
}

}  // namespace

// L (B, n, n) lower-triangular, Wd (B, n/64, 64, 64) its diagonal-block
// inverses, W (B, n, n) receives L^{-1}.  n % 64 == 0.
extern "C" int ff_tri_inv(const float* L, const float* Wd, float* W, int B,
                          int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = n / TB;
  for (int k = 0; k < nb; ++k) {
    tri_inv_row_kernel<<<dim3(nb, B), NTHREADS, 0, st>>>(L, Wd, W, n, k);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
