// K2 + K3a: blocked right-looking Cholesky with the diagonal-block inverses,
// for one matrix (K2, B = 1) or a batch of restarts (K3a, B = R).
//
// Replaces benchmarks/retired/pallas_cholesky.py:cholesky_blocked (K2;
// pallas_call at :213, body _chol_kernel :96, helpers _chol_unblocked :41 and
// _tri_inv_lower :72) and benchmarks/retired/pallas_batched.py:cholesky_vmem
// (K3a; pallas_call at :175, body _chol_vmem_kernel :107).  On the TPU, K3a
// kept a whole n <= 1024 matrix in 16 MB of VMEM; a CTA here has 227 KB, so
// both become the same factorization with a batch dimension, in the order of
// fidelityfusion_tpu/ops/blocked.py:blocked_chol_inv_v2.  Host loop over
// panels of 64 columns; per panel k:
//   1. chol_leaf_kernel, one CTA per matrix: the 64x64 diagonal block in
//      shared memory, factored by a rank-1 column sweep that builds its
//      inverse W_kk in the same sweep (ops/blocked.py:_leaf_chol_inv);
//      writes L_kk over A_kk, W_kk to Wd, and zeros the column strip above;
//   2. chol_panel_kernel: L21 = A21 W_kk^T, one 64-row tile per CTA, in place;
//   3. chol_trailing_kernel: A22 -= L21 L21^T on lower-triangle tiles only.
// Steps 2 and 3 are tiled SIMT GEMMs in fp32 FMA.
//
// Bound on the H100: operations, n^3/3 per matrix at the fp32 rate (67
// TFLOP/s without tensor cores).  What this simple version does about it:
// nothing beyond 64x64 shared-memory tiles with 4x4 register blocking; the
// leaf is a serial 64-step chain per panel and each panel costs three
// launches, so small n is launch- and latency-bound.  Larger register
// tiles and a persistent trailing update are later work (wgmma has no
// full-fp32 mode, so the tensor cores stay out of reach at this precision).
#include "common.cuh"

using ff::NTHREADS;
using ff::TB;
using ff::TPAD;

namespace {

__global__ void chol_leaf_kernel(float* __restrict__ Lw, float* __restrict__ Wd,
                                 int n, int k) {
  __shared__ float a[TB][TPAD];
  __shared__ float w[TB][TPAD];
  __shared__ float col[TB];
  __shared__ float wj[TB];
  const int tid = threadIdx.x;
  const int nb = n / TB;
  const size_t s = (size_t)k * TB;
  float* A = Lw + (size_t)blockIdx.x * n * n;
  float* Wk = Wd + ((size_t)blockIdx.x * nb + k) * TB * TB;
  for (int e = tid; e < TB * TB; e += NTHREADS) {
    const int r = e / TB, c = e % TB;
    a[r][c] = A[(s + r) * n + s + c];
    w[r][c] = r == c ? 1.f : 0.f;
  }
  __syncthreads();
  for (int j = 0; j < TB; ++j) {
    // a NaN or negative pivot propagates (training rolls the step back)
    const float d = sqrtf(a[j][j]);
    if (tid < TB) {
      col[tid] = tid > j ? a[tid][j] / d : 0.f;
      wj[tid] = w[j][tid] / d;
    }
    __syncthreads();
    for (int e = tid; e < TB * TB; e += NTHREADS) {
      const int r = e / TB, c = e % TB;
      if (c == j) {
        if (r > j) a[r][j] = col[r];
        else if (r == j) a[j][j] = d;
      } else if (c > j && r > j) {
        a[r][c] -= col[r] * col[c];
      }
      // W <- inv(E_j) W: row j scaled, rows below get -L_rj / d * row j
      if (r == j) w[j][c] = wj[c];
      else if (r > j) w[r][c] -= col[r] * wj[c];
    }
    __syncthreads();
  }
  for (int e = tid; e < TB * TB; e += NTHREADS) {
    const int r = e / TB, c = e % TB;
    A[(s + r) * n + s + c] = r >= c ? a[r][c] : 0.f;
    Wk[e] = w[r][c];
  }
  for (size_t e = tid; e < s * TB; e += NTHREADS) {
    A[(e / TB) * n + s + e % TB] = 0.f;  // strictly upper strip of column block k
  }
}

__global__ void chol_panel_kernel(float* __restrict__ Lw,
                                  const float* __restrict__ Wd, int n, int k) {
  __shared__ float As[TB][TPAD];
  __shared__ float Bs[TB][TPAD];
  const int nb = n / TB;
  const size_t s = (size_t)k * TB;
  const size_t r0 = s + TB + (size_t)blockIdx.x * TB;
  float* A = Lw + (size_t)blockIdx.y * n * n;
  const float* Wk = Wd + ((size_t)blockIdx.y * nb + k) * TB * TB;
  ff::load_tile(As, A + r0 * n + s, n);
  ff::load_tile_t(Bs, Wk, TB);
  __syncthreads();
  float acc[4][4] = {};
  ff::tile_fma(As, Bs, acc);
  // in place: this CTA alone reads rows r0..r0+63 of the panel, and it has
  // them in shared memory already
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      A[(r0 + ty + 16 * i) * n + s + tx + 16 * j] = acc[i][j];
}

__global__ void chol_trailing_kernel(float* __restrict__ Lw, int n, int k) {
  const int tj = blockIdx.x, ti = blockIdx.y;
  if (tj > ti) return;  // lower-triangle tiles only
  __shared__ float As[TB][TPAD];
  __shared__ float Bs[TB][TPAD];
  const size_t s = (size_t)k * TB;
  const size_t ri = s + TB + (size_t)ti * TB, rj = s + TB + (size_t)tj * TB;
  float* A = Lw + (size_t)blockIdx.z * n * n;
  ff::load_tile(As, A + ri * n + s, n);
  ff::load_tile_t(Bs, A + rj * n + s, n);
  __syncthreads();
  float acc[4][4] = {};
  ff::tile_fma(As, Bs, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      A[(ri + ty + 16 * i) * n + rj + tx + 16 * j] -= acc[i][j];
}

}  // namespace

// L: (B, n, n) holding A on entry and L (upper triangle zero) on exit;
// Wd: (B, n/64, 64, 64) receives the diagonal-block inverses.  n % 64 == 0.
extern "C" int ff_chol_inv(float* L, float* Wd, int B, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = n / TB;
  for (int k = 0; k < nb; ++k) {
    chol_leaf_kernel<<<B, NTHREADS, 0, st>>>(L, Wd, n, k);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int t = nb - k - 1;
    if (t > 0) {
      chol_panel_kernel<<<dim3(t, B), NTHREADS, 0, st>>>(L, Wd, n, k);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      chol_trailing_kernel<<<dim3(t, t, B), NTHREADS, 0, st>>>(L, n, k);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}
