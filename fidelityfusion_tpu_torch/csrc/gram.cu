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
// Bound on the H100: the n1 x n2 fp32 write (16.8 MB at B=4, n=1024: 5.0 us
// at 3.35 TB/s); the O(n1 n2 d) arithmetic is small for GP inputs.  The
// register path takes 7.5 us there by device time on an H100 80GB HBM3 at
// 700 W (the chunked path below took 23.7 us).
// Both paths are templated on the scalar: float (`ff_gram`, every caller
// but one) and double (`ff_gram_f64`: the Kronecker path's Grams, whose
// small eigenvalues the Kronecker product multiplies by up to ~1e6, past
// what a float32 Gram's rounding leaves of them; models/hogp.py).
// Distances are taken as direct differences, not the quadratic expansion
// the TPU kernel used: d is small, nothing cancels, and the diagonal is
// exactly sv.  Ragged n1 and n2 (the n x m cross-Gram of predict) are
// masked.  Two paths:
//   * the d of the port's callers (d = 1: the main path, the unbatched
//     fits and every other cascade's stages; d = 2: NAR's stages i >= 1,
//     whose input is [x, y_low]; d = 4: the Poisson source parameters of
//     every HOGP, GAR and CIGAR stage): templated on d, no shared memory and no
//     barrier; a caller with another small d adds its instantiation in
//     ff_gram.  A CTA of 256 threads owns 32 x 128 output tiles in turn
//     (a grid of one wave, 8 CTAs per SM, or one CTA a tile if fewer); a
//     thread keeps its 4 columns of x2, scaled by 1 / length-scale, in
//     registers, reads a row of x1 at a time (one broadcast per warp), and
//     writes 4 outputs of a row as one 16-byte store: a warp writes 512
//     contiguous bytes.  The diagonal terms are looked at only in tiles
//     that straddle the diagonal.
//   * any other d: one CTA per 32 x 32 tile and restart, the tile's rows of
//     x1 and x2 staged in shared memory in chunks of 32 dimensions, already
//     scaled, the d loop in registers.
#include "common.cuh"

namespace {

__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float exp_(float a) { return expf(a); }
__device__ __forceinline__ double exp_(double a) { return exp(a); }

// four consecutive outputs of a row, 16-byte aligned, as wide stores
__device__ __forceinline__ void store4(float* o, const float* v) {
  *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* o, const double* v) {
  reinterpret_cast<double2*>(o)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(o)[1] = make_double2(v[2], v[3]);
}

// the chunked path
constexpr int T = 32;   // output tile
constexpr int DC = 32;  // input-dimension chunk staged per pass
constexpr int ROWS = 4; // rows per thread: blockDim = (32, 8)

// the register path
constexpr int SMALL_TR = 32, SMALL_TC = 128, SMALL_THREADS = 256;
constexpr int SMALL_CTAS_PER_SM = 2048 / SMALL_THREADS;

template <typename F>
__global__ void gram_kernel(const F* __restrict__ x1,
                            const F* __restrict__ x2,
                            const F* __restrict__ inv_ls,
                            const F* __restrict__ sv,
                            const F* __restrict__ diag_add,
                            const F* __restrict__ y_var,
                            F* __restrict__ out, int n1, int n2, int d) {
  __shared__ F s1[T][DC + 1];
  __shared__ F s2[T][DC + 1];
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * T, col0 = blockIdx.x * T;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * T + tx;
  const F* ls = inv_ls + (size_t)b * d;
  F acc[ROWS] = {0, 0, 0, 0};
  for (int k0 = 0; k0 < d; k0 += DC) {
    const int kc = min(DC, d - k0);
    for (int e = tid; e < T * DC; e += T * 8) {
      const int r = e / DC, k = e % DC;
      F v1 = 0, v2 = 0;
      if (k < kc) {
        const F s = ls[k0 + k];
        if (row0 + r < n1) v1 = x1[(size_t)(row0 + r) * d + k0 + k] * s;
        if (col0 + r < n2) v2 = x2[(size_t)(col0 + r) * d + k0 + k] * s;
      }
      s1[r][k] = v1;
      s2[r][k] = v2;
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      const F c = s2[tx][k];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const F diff = s1[ty + 8 * i][k] - c;
        acc[i] = fma_(diff, diff, acc[i]);
      }
    }
    __syncthreads();
  }
  const F svb = sv[b];
  const int c = col0 + tx;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = row0 + ty + 8 * i;
    if (r < n1 && c < n2) {
      F v = svb * exp_(F(-0.5) * acc[i]);
      if (r == c) {
        if (diag_add) v += diag_add[b];
        if (y_var) v += y_var[(size_t)b * n1 + r];
      }
      out[((size_t)b * n1 + r) * n2 + c] = v;
    }
  }
}

// The register path: see the header.  tiles_r x tiles_c tiles per restart.
template <typename F, int D>
__global__ void __launch_bounds__(SMALL_THREADS) gram_small_d_kernel(
    const F* __restrict__ x1, const F* __restrict__ x2, const F* __restrict__ inv_ls,
    const F* __restrict__ sv, const F* __restrict__ diag_add,
    const F* __restrict__ y_var, F* __restrict__ out, int B, int n1, int n2,
    int tiles_r, int tiles_c) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const bool vec = (n2 & 3) == 0;  // rows of out start 16-byte aligned
  const long long per_b = static_cast<long long>(tiles_r) * tiles_c, tiles = per_b * B;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int b = static_cast<int>(t / per_b), u = static_cast<int>(t % per_b);
    const int row0 = u / tiles_c * SMALL_TR, col0 = u % tiles_c * SMALL_TC;
    const int c0 = col0 + 4 * tx;
    F ls[D], xc[4][D];
#pragma unroll
    for (int k = 0; k < D; ++k) ls[k] = __ldg(inv_ls + b * D + k);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < D; ++k)
        xc[j][k] = c0 + j < n2 ? __ldg(x2 + static_cast<size_t>(c0 + j) * D + k) * ls[k] : F(0);
    const F s = __ldg(sv + b);
    const bool diag = (diag_add || y_var) && row0 < col0 + SMALL_TC && col0 < row0 + SMALL_TR;
    const F da = diag_add ? __ldg(diag_add + b) : F(0);
#pragma unroll
    for (int i = 0; i < SMALL_TR / 8; ++i) {
      const int r = row0 + ty + 8 * i;
      if (r >= n1) break;
      F xr[D];
#pragma unroll
      for (int k = 0; k < D; ++k) xr[k] = __ldg(x1 + static_cast<size_t>(r) * D + k) * ls[k];
      F v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        F d2 = 0;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const F diff = xr[k] - xc[j][k];
          d2 = fma_(diff, diff, d2);
        }
        v[j] = s * exp_(F(-0.5) * d2);
      }
      if (diag) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (r == c0 + j) {
            v[j] += da;
            if (y_var) v[j] += __ldg(y_var + static_cast<size_t>(b) * n1 + r);
          }
        }
      }
      F* o = out + (static_cast<size_t>(b) * n1 + r) * n2 + c0;
      if (vec && c0 + 3 < n2) {
        store4(o, v);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < n2) o[j] = v[j];
      }
    }
  }
}

template <typename F, int D>
cudaError_t launch_small_d(const F* x1, const F* x2, const F* inv_ls, const F* sv,
                           const F* diag_add, const F* y_var, F* out, int B, int n1,
                           int n2, cudaStream_t stream) {
  int dev = 0, sms = 0;
  const cudaError_t err = ff::device_sms(&dev, &sms);
  if (err != cudaSuccess) return err;
  const int tiles_r = (n1 + SMALL_TR - 1) / SMALL_TR, tiles_c = (n2 + SMALL_TC - 1) / SMALL_TC;
  const long long tiles = static_cast<long long>(B) * tiles_r * tiles_c;
  const long long wave = static_cast<long long>(sms) * SMALL_CTAS_PER_SM;
  const long long grid = tiles < wave ? tiles : wave;  // one wave; each CTA loops over tiles
  gram_small_d_kernel<F, D><<<static_cast<unsigned>(grid), SMALL_THREADS, 0, stream>>>(
      x1, x2, inv_ls, sv, diag_add, y_var, out, B, n1, n2, tiles_r, tiles_c);
  return cudaGetLastError();
}

template <typename F>
int gram(const F* x1, const F* x2, const F* inv_ls, const F* sv, const F* diag_add,
         const F* y_var, F* out, int B, int n1, int n2, int d, cudaStream_t st) {
  if (d == 1)
    return static_cast<int>(
        launch_small_d<F, 1>(x1, x2, inv_ls, sv, diag_add, y_var, out, B, n1, n2, st));
  if (d == 2)
    return static_cast<int>(
        launch_small_d<F, 2>(x1, x2, inv_ls, sv, diag_add, y_var, out, B, n1, n2, st));
  if (d == 4)
    return static_cast<int>(
        launch_small_d<F, 4>(x1, x2, inv_ls, sv, diag_add, y_var, out, B, n1, n2, st));
  dim3 grid((n2 + T - 1) / T, (n1 + T - 1) / T, B);
  dim3 block(T, 8);
  gram_kernel<F><<<grid, block, 0, st>>>(x1, x2, inv_ls, sv, diag_add, y_var, out, n1, n2, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x1 (n1, d), x2 (n2, d) shared by all B restarts; inv_ls (B, d); sv (B);
// diag_add (B) or null; y_var (B, n1) or null; out (B, n1, n2).
extern "C" int ff_gram(const float* x1, const float* x2, const float* inv_ls,
                       const float* sv, const float* diag_add,
                       const float* y_var, float* out, int B, int n1, int n2,
                       int d, void* stream) {
  return gram<float>(x1, x2, inv_ls, sv, diag_add, y_var, out, B, n1, n2, d,
                     static_cast<cudaStream_t>(stream));
}

// the same in double
extern "C" int ff_gram_f64(const double* x1, const double* x2, const double* inv_ls,
                           const double* sv, const double* diag_add,
                           const double* y_var, double* out, int B, int n1, int n2,
                           int d, void* stream) {
  return gram<double>(x1, x2, inv_ls, sv, diag_add, y_var, out, B, n1, n2, d,
                      static_cast<cudaStream_t>(stream));
}
