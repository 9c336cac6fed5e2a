// K1: the fused SE / ARD Gram with its nugget, batched over restarts.
//
// Replaces benchmarks/retired/pallas_gram.py:gram_se (pallas_call at :85,
// body _gram_kernel :34; gram_sigma_ard :102 wraps it):
//
//   out[b, i, j] = sv[b] * exp(-0.5 * sum_k ((x1[i,k] - x2[j,k]) * inv_ls[b,k])^2)
//                  + (i == j) * (diag_add[b] + y_var[b, i])
//
// so Sigma = K + (noise + jitter) I + diag(y_var) comes out of one pass.
//
// Bound on the H100: the n1 x n2 fp32 write (16.8 MB at B=4, n=1024); the
// O(n1 n2 d) arithmetic is small for GP inputs.  Design: one CTA per 32x32
// output tile and restart (blockIdx.z), the tile's rows of x1 and x2 staged
// in shared memory already scaled by the restart's 1/length-scale, the d
// loop in registers, and warps writing whole 128-byte rows of the output.
// Distances are taken as direct differences, not the quadratic expansion
// the TPU kernel used: d is small, nothing cancels, and the diagonal is
// exactly sv.  Ragged n1 and n2 (the n x m cross-Gram of predict) are masked
// here.
#include "common.cuh"

namespace {

constexpr int T = 32;   // output tile
constexpr int DC = 32;  // input-dimension chunk staged per pass
constexpr int ROWS = 4; // rows per thread: blockDim = (32, 8)

__global__ void gram_kernel(const float* __restrict__ x1,
                            const float* __restrict__ x2,
                            const float* __restrict__ inv_ls,
                            const float* __restrict__ sv,
                            const float* __restrict__ diag_add,
                            const float* __restrict__ y_var,
                            float* __restrict__ out, int n1, int n2, int d) {
  __shared__ float s1[T][DC + 1];
  __shared__ float s2[T][DC + 1];
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * T, col0 = blockIdx.x * T;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * T + tx;
  const float* ls = inv_ls + (size_t)b * d;
  float acc[ROWS] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < d; k0 += DC) {
    const int kc = min(DC, d - k0);
    for (int e = tid; e < T * DC; e += T * 8) {
      const int r = e / DC, k = e % DC;
      float v1 = 0.f, v2 = 0.f;
      if (k < kc) {
        const float s = ls[k0 + k];
        if (row0 + r < n1) v1 = x1[(size_t)(row0 + r) * d + k0 + k] * s;
        if (col0 + r < n2) v2 = x2[(size_t)(col0 + r) * d + k0 + k] * s;
      }
      s1[r][k] = v1;
      s2[r][k] = v2;
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      const float c = s2[tx][k];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float diff = s1[ty + 8 * i][k] - c;
        acc[i] = fmaf(diff, diff, acc[i]);
      }
    }
    __syncthreads();
  }
  const float svb = sv[b];
  const int c = col0 + tx;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = row0 + ty + 8 * i;
    if (r < n1 && c < n2) {
      float v = svb * expf(-0.5f * acc[i]);
      if (r == c) {
        if (diag_add) v += diag_add[b];
        if (y_var) v += y_var[(size_t)b * n1 + r];
      }
      out[((size_t)b * n1 + r) * n2 + c] = v;
    }
  }
}

}  // namespace

// x1 (n1, d), x2 (n2, d) shared by all B restarts; inv_ls (B, d); sv (B);
// diag_add (B) or null; y_var (B, n1) or null; out (B, n1, n2).
extern "C" int ff_gram(const float* x1, const float* x2, const float* inv_ls,
                       const float* sv, const float* diag_add,
                       const float* y_var, float* out, int B, int n1, int n2,
                       int d, void* stream) {
  dim3 grid((n2 + T - 1) / T, (n1 + T - 1) / T, B);
  dim3 block(T, 8);
  gram_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, x2, inv_ls, sv, diag_add, y_var, out, n1, n2, d);
  return static_cast<int>(cudaGetLastError());
}
