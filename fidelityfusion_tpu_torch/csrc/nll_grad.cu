// K4: the NLML's gradient with respect to Sigma, batched over restarts,
//
//   dSigma[b, i, j] = s_b (d sum_{k >= max(i, j)} W[b, k, i] W[b, k, j]
//                          - sum_c alpha[b, i, c] alpha[b, j, c])
//
// with W = inv(L) lower-triangular, alpha = Sigma^{-1} y (n x d) and
// s_b = 0.5 g_b, g the NLML's incoming gradient: the closed-form backward of
// fidelityfusion_tpu_torch/ops/linalg.py:_MvnNll.
//
// Replaces no TPU kernel: the JAX package left W^T W to XLA's dense GEMM.
// It was added because the library GEMM (a SIMT fp32 cutlass kernel on the
// H100) did 2 n^3 FLOPs a matrix where the model needs n^3 / 3: W^T W is
// symmetric, so only its lower triangle is needed, and W is zero above its
// diagonal, so C_ij only sums over k >= max(i, j).  Together six times the
// work, and the largest device operation of a restart step at n = 4096.
//
// Bound on the H100: operations, n^3 / 3 FLOPs a matrix at the fp32 rate
// (67 TFLOP/s; full fp32 FFMA, no TF32): 1.37 ms at (4, 4096), where it
// takes 2.30 ms (the library GEMM 10.5) on an H100 80GB HBM3 at 700 W.
// What the design does about it:
//   * only output tiles on or below the diagonal are computed; each one's
//     K chain starts at its own row tile, so tiles of W above the diagonal
//     are never read, and entries above the diagonal inside the diagonal
//     tiles are zero-filled at the copy, never read either: sum over tiles
//     (I + 1)(nt - I), 5,984 of a dense GEMM's 32,768 128-wide tile
//     products at n = 4096;
//   * the epilogue subtracts alpha alpha^T, applies d and s, and stores the
//     tile and its mirror, so dSigma is written once, full, and no
//     n x n temporary is made;
//   * 8 x 8 outputs a thread in registers, fed from shared memory by
//     16-byte reads (W's rows are read along i and j, so both operands are
//     k-major as they lie in memory: no transpose); W's rows stream in by
//     cp.async, the next stage loading while the current one is multiplied;
//   * a persistent grid takes (matrix, output tile) items from a counter,
//     longest K chain first (chains run from 1 to nt tiles), so no SM idles
//     at the tail while another finishes a long chain;
//   * 128 x 128 tiles (256 threads, two CTAs an SM) where they give every
//     SM an item, else 64 x 64 (64 threads, eight an SM): with fewer items
//     than SMs the longest chain sets the time, and a 64-wide chain is a
//     quarter of the work.
// Ragged n, and W as a cropped view of a padded inverse (leading dimension
// ld >= n), are masked at the copy (rows k >= n and columns past k read as
// zero) and at the store.
#include "common.cuh"

namespace {

// One instance per output tile width TM (128 or 64): (TM / 8)^2 threads,
// 8 x 8 outputs each; a warp owns 32 x 64 outputs as 4 x 8 threads.  W's
// rows stream in by cp.async in STAGES stages of BK rows (the best of
// BK 8-64 and 2-6 stages measured at n = 256-4096).
template <int TM>
struct Tile {
  static constexpr int THREADS = (TM / 8) * (TM / 8);
  static constexpr int MIN_CTAS = 65536 / (THREADS * 128);  // 128 registers a thread
  static constexpr int BK = TM == 128 ? 32 : 16;
  static constexpr int STAGES = TM == 128 ? 2 : 3;
  struct Smem {
    float a[STAGES][BK][TM];  // W[k, I tile]
    float b[STAGES][BK][TM];  // W[k, J tile] (unused on diagonal tiles: a serves both)
    int item;
  };
  static constexpr int SMEM_BYTES = static_cast<int>(sizeof(Smem));  // 65,540 at TM = 128
};

// Rows k0 .. k0 + BK - 1 and columns c0 .. c0 + TM - 1 of one matrix of W
// into S, element (k, c) copied only where c <= k < n (W's lower triangle;
// c < n follows), zeros elsewhere.
template <int TM>
__device__ __forceinline__ void load_stage(float (*S)[TM], const float* Wb, int ld, int n, int k0,
                                           int c0) {
  constexpr int BK = Tile<TM>::BK;
#pragma unroll
  for (int e = threadIdx.x; e < BK * TM / 4; e += Tile<TM>::THREADS) {
    const int r = e / (TM / 4), c = (e % (TM / 4)) * 4;
    const int k = k0 + r, col = c0 + c;
    const int valid = k < n ? min(4, max(0, k + 1 - col)) : 0;
    const float* src = valid ? Wb + static_cast<size_t>(k) * ld + col : Wb;
    ff::cp_async16_zfill(&S[r][c], src, 4 * valid);
  }
}

// acc[i][j] += sum_k A[k][row_i] B[k][col_j] over one stage; row_i = 4 ty + i
// (i < 4), TM / 2 + 4 ty + i - 4 (i >= 4), col_j likewise with tx.
template <int TM>
__device__ __forceinline__ void mma_stage(const float (*A)[TM], const float (*Bm)[TM],
                                          float acc[8][8], int ty, int tx) {
  constexpr int H = TM / 2, BK = Tile<TM>::BK;
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&A[k][4 * ty]);
    const float4 a1 = *reinterpret_cast<const float4*>(&A[k][H + 4 * ty]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bm[k][4 * tx]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Bm[k][H + 4 * tx]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// W (B, n, n) with batch stride w_bs and row stride ld, read only below
// its diagonal; alpha (B, n, d) contiguous; g (B,) with stride g_stride;
// out (B, n, n) contiguous, every element written; counter one int, zero at
// launch.
template <int TM>
__global__ void __launch_bounds__(Tile<TM>::THREADS, Tile<TM>::MIN_CTAS)
    nll_grad_kernel(const float* __restrict__ W, long long w_bs, int ld,
                    const float* __restrict__ alpha, int d, const float* __restrict__ g,
                    int g_stride, float* __restrict__ out, int* counter, int B, int n) {
  using Smem = typename Tile<TM>::Smem;
  constexpr int H = TM / 2, BK = Tile<TM>::BK, STAGES = Tile<TM>::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = (warp / (TM / 64)) * 4 + (lane >> 3), tx = (warp % (TM / 64)) * 8 + (lane & 7);
  const int nt = (n + TM - 1) / TM;
  const int total = B * (nt * (nt + 1) / 2);

  for (;;) {
    if (threadIdx.x == 0) sm.item = atomicAdd(counter, 1);
    __syncthreads();
    const int p = sm.item;
    // every thread has read the item, and has finished the previous one's
    // reads of the stages, before either is written again
    __syncthreads();
    if (p >= total) break;
    // items in order of row tile I (chain nt - I tiles: longest first), then
    // matrix b, then column tile J <= I
    int I = 0;
    while (B * ((I + 1) * (I + 2) / 2) <= p) ++I;
    const int r = p - B * (I * (I + 1) / 2), b = r / (I + 1), J = r % (I + 1);
    const bool diag = I == J;
    const float* Wb = W + b * w_bs;
    const int k0 = I * TM, steps = (n - k0 + BK - 1) / BK;

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < steps) {
        load_stage<TM>(sm.a[s], Wb, ld, n, k0 + s * BK, I * TM);
        if (!diag) load_stage<TM>(sm.b[s], Wb, ld, n, k0 + s * BK, J * TM);
      }
      ff::cp_async_commit();
    }
    for (int t = 0; t < steps; ++t) {
      ff::cp_async_wait<STAGES - 2>();
      // stage t has landed for every thread, and every thread is done with
      // stage t - 1, which the next copy refills
      __syncthreads();
      const int nx = t + STAGES - 1;
      if (nx < steps) {
        load_stage<TM>(sm.a[nx % STAGES], Wb, ld, n, k0 + nx * BK, I * TM);
        if (!diag) load_stage<TM>(sm.b[nx % STAGES], Wb, ld, n, k0 + nx * BK, J * TM);
      }
      ff::cp_async_commit();
      const int st = t % STAGES;
      mma_stage<TM>(sm.a[st], diag ? sm.a[st] : sm.b[st], acc, ty, tx);
    }
    ff::cp_async_wait<0>();

    // epilogue: s (d C - alpha_i alpha_j^T), the tile and, off the diagonal, its mirror
    const int i0 = I * TM + 4 * ty, j0 = J * TM + 4 * tx;
    auto row_of = [&](int q) { return i0 + (q < 4 ? q : H - 4 + q); };
    auto col_of = [&](int q) { return j0 + (q < 4 ? q : H - 4 + q); };
    const float df = static_cast<float>(d), sc = 0.5f * g[static_cast<size_t>(b) * g_stride];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= df;
    const float* ab = alpha + static_cast<size_t>(b) * n * d;
    for (int c = 0; c < d; ++c) {
      float ai[8], aj[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        ai[q] = row_of(q) < n ? __ldg(ab + static_cast<size_t>(row_of(q)) * d + c) : 0.f;
        aj[q] = col_of(q) < n ? __ldg(ab + static_cast<size_t>(col_of(q)) * d + c) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(-ai[i], aj[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= sc;

    // rows and columns of a thread come in aligned quads; with n % 4 == 0
    // a quad is wholly inside or outside, and is one 16-byte store
    float* ob = out + static_cast<size_t>(b) * n * n;
    const bool vec = (n & 3) == 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (row_of(i) >= n) continue;
      float* row = ob + static_cast<size_t>(row_of(i)) * n;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c0 = col_of(4 * h);
        if (vec) {
          if (c0 < n)
            *reinterpret_cast<float4*>(row + c0) =
                make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (c0 + q < n) row[c0 + q] = acc[i][4 * h + q];
        }
      }
    }
    if (!diag) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (col_of(j) >= n) continue;
        float* row = ob + static_cast<size_t>(col_of(j)) * n;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r0 = row_of(4 * h);
          if (vec) {
            if (r0 < n)
              *reinterpret_cast<float4*>(row + r0) = make_float4(
                  acc[4 * h][j], acc[4 * h + 1][j], acc[4 * h + 2][j], acc[4 * h + 3][j]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (r0 + q < n) row[r0 + q] = acc[4 * h + q][j];
          }
        }
      }
    }
  }
}

// Launch the TM instance: a persistent grid of as many CTAs as fit the
// card, at most one an item.
template <int TM>
cudaError_t launch(const float* W, long long w_bs, int ld, const float* alpha, int d,
                   const float* g, int g_stride, float* out, int* counter, int B, int n,
                   cudaStream_t s) {
  static int per_sm[ff::MAX_DEVICES];  // resident CTAs an SM, after the shared-memory opt-in
  constexpr int SMEM = Tile<TM>::SMEM_BYTES;
  int dev = 0, sms = 0;
  cudaError_t err = ff::device_sms(&dev, &sms);
  int ctas = dev < ff::MAX_DEVICES ? per_sm[dev] : 0;
  if (err == cudaSuccess && ctas == 0) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(nll_grad_kernel<TM>),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, nll_grad_kernel<TM>,
                                                          Tile<TM>::THREADS, SMEM);
    if (err == cudaSuccess && ctas == 0) err = cudaErrorInvalidConfiguration;
    if (err == cudaSuccess && dev < ff::MAX_DEVICES) per_sm[dev] = ctas;
  }
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(counter, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  const long long nt = (n + TM - 1) / TM, items = B * (nt * (nt + 1) / 2);
  const long long cap = static_cast<long long>(ctas) * sms;
  const unsigned grid = static_cast<unsigned>(items < cap ? items : cap);
  nll_grad_kernel<TM><<<grid, Tile<TM>::THREADS, SMEM, s>>>(W, w_bs, ld, alpha, d, g, g_stride,
                                                             out, counter, B, n);
  return cudaGetLastError();
}

}  // namespace

// W (B, n, n): batch stride w_bs and row stride ld in floats (both multiples
// of 4, W 16-byte aligned), its entries above the diagonal never read;
// alpha (B, n, d) contiguous; g (B,) with stride g_stride (0 broadcasts);
// out (B, n, n) contiguous receives dSigma, every element written; counter
// one int of scratch, zeroed here before the launch.  A refused launch
// returns its error.
extern "C" int ff_nll_grad(const float* W, long long w_bs, int ld, const float* alpha, int d,
                           const float* g, int g_stride, float* out, int* counter, int B, int n,
                           void* stream) {
  if (B <= 0 || n <= 0) return 0;
  int dev = 0, sms = 0;
  const cudaError_t err = ff::device_sms(&dev, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 128-wide tiles once they give every SM an item; below that a chain of
  // 128-wide products is the critical path, and 64-wide tiles, a quarter of
  // the work a chain, finish first (measured: (4, 1024) and (1, 2048) take
  // 128, (4, 768) and (1, 1024) 64)
  const long long nt = (n + 127) / 128;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      B * (nt * (nt + 1) / 2) >= sms
          ? launch<128>(W, w_bs, ld, alpha, d, g, g_stride, out, counter, B, n, s)
          : launch<64>(W, w_bs, ld, alpha, d, g, g_stride, out, counter, B, n, s));
}
