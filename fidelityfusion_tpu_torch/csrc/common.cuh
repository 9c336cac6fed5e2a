// Shared pieces of the port's hand-written Hopper kernels (sm_90a, fp32).
//
// Every file here is compiled on its own into a shared library with a plain
// C interface (see fidelityfusion_tpu_torch/ops/cuda.py).  All arithmetic is
// full fp32 FMA on the CUDA cores: no TF32 anywhere, because the Gram's
// expansion and the factorization GEMMs cancel catastrophically at reduced
// precision.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

extern "C" const char* ff_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace ff {

// Panel width of the blocked factorization and tile width of the SIMT GEMMs.
constexpr int TB = 64;
constexpr int TPAD = TB + 1;  // padded shared-memory row: no bank conflicts
constexpr int NTHREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

// S = G[0:64, 0:64] (row-major global tile with leading dimension ld).
__device__ __forceinline__ void load_tile(float (*S)[TPAD], const float* G,
                                          size_t ld) {
  for (int e = threadIdx.x; e < TB * TB; e += NTHREADS) {
    int r = e / TB, c = e % TB;
    S[r][c] = G[r * ld + c];
  }
}

// S = G[0:64, 0:64]^T.
__device__ __forceinline__ void load_tile_t(float (*S)[TPAD], const float* G,
                                            size_t ld) {
  for (int e = threadIdx.x; e < TB * TB; e += NTHREADS) {
    int r = e / TB, c = e % TB;
    S[c][r] = G[r * ld + c];
  }
}

// acc[i][j] += sum_k A[ty + 16 i][k] * B[k][tx + 16 j] over one 64-deep tile,
// with tx = threadIdx.x % 16 and ty = threadIdx.x / 16.
__device__ __forceinline__ void tile_fma(const float (*A)[TPAD],
                                         const float (*B)[TPAD],
                                         float acc[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 8
  for (int k = 0; k < TB; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[ty + 16 * i][k];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[k][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

}  // namespace ff
