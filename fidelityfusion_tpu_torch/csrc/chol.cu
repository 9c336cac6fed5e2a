// K2 + K3a: blocked right-looking Cholesky with the diagonal-block inverses,
// for one matrix (K2, B = 1) or a batch of restarts (K3a, B = R).
//
// Replaces benchmarks/retired/pallas_cholesky.py:199 cholesky_blocked (K2;
// pallas_call at :213) and benchmarks/retired/pallas_batched.py:166
// cholesky_vmem (K3a; pallas_call at :175, body _chol_vmem_kernel :107, its
// diagonal blocks by _chol_recursive :80 and _tri_inv_recursive :94).  On the
// TPU, K3a kept a whole n <= 1024 matrix in 16 MB of VMEM and walked the
// panels in order on one core; a CTA here has 227 KB, so both become one
// factorization with a batch dimension, spread over the SMs.
//
// Bound on the H100: by operations, n^3/3 FLOPs (n^3/6 FMAs) per matrix at
// the fp32 rate (67 TFLOP/s; every product here is full fp32, no TF32),
// 21-43 us at the main path's sizes.  In practice it is bound by the chain
// of n/64 dependent panels: each panel's 64x64 diagonal block must be
// updated and factored before anything below it can move, so one panel
// costs a tile product, the leaf, a second tile product and two grid
// barriers whatever n is.  What this design does about it:
//   * one persistent cooperative launch per factorization (one CTA per SM,
//     capped by the work, so that the CTA on the chain has its SM alone),
//     phases separated by grid barriers, instead of three launches per panel;
//   * the leaf is written for warps and recursive as _chol_recursive is: the
//     64x64 block is split 2x2; each 32x32 diagonal block is factored by one
//     warp in registers with no block barrier (leaf32), and the three 32x32
//     products of the recursion run on all four warps;
//   * look-ahead: while the grid applies panel k's trailing update, the CTA
//     that owns matrix b's next diagonal block updates that block first and
//     factors it, so the leaf overlaps the widest phase;
//   * the panel solve L21 = A21 W_kk^T and the lower-triangle trailing update
//     are 64x64x64 tile products, 4x8 outputs a thread, operands staged in
//     shared memory by cp.async in two stages over the 64-deep product.
// The factor is written to a separate output, so no copy precedes the launch.
// Every barrier is reached by every thread whatever the data: a negative or
// NaN pivot propagates as NaN (training rolls such a step back).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int P = 64;         // panel = tile = leaf width (Wd's blocks)
constexpr int H = 32;         // leaf base case, one warp
constexpr int LD = P + 4;     // 16-byte rows; 8 consecutive rows' float4s hit distinct banks
constexpr int LDH = H + 4;
constexpr int THREADS = 128;  // 4 warps
constexpr unsigned FULL = 0xffffffffu;

struct Smem {
  float a[P][LD];    // operand A; the leaf's block, becoming L
  float b[P][LD];    // operand B; the leaf's inverse W
  float wt[H][LDH];  // leaf: W11 transposed
  float tt[H][LDH];  // leaf: (L21 W11) transposed
  float col[2][H];   // leaf32: the current step's column, by parity of the step
  float inv_d[H];    // leaf32: 1 / L_jj
};

// Each kernel's shared memory, named here so that the functions below
// (not inlined, to keep the code small) address it as shared.
__shared__ __align__(16) Smem sm;

using ff::cp_async16;
using ff::cp_async_commit;
using ff::cp_async_wait;

// S[0:64, h*32 : h*32+32] <- G (row-major, leading dimension ld), asynchronously.
__device__ __forceinline__ void load_half(float (*S)[LD], const float* G, size_t ld, int h) {
  for (int e = threadIdx.x; e < P * 8; e += THREADS) {
    const int r = e >> 3, c = h * 32 + (e & 7) * 4;
    cp_async16(&S[r][c], G + r * ld + c);
  }
}

// acc[i][j] += sum_{q in [q0, q0+32)} A[tr + 16i][q] B[tc + 8j][q],
// tr = thread / 8, tc = thread % 8.
__device__ __forceinline__ void nt64_half(const float (*A)[LD], const float (*B)[LD], int q0,
                                          float acc[4][8]) {
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
#pragma unroll 2
  for (int q = q0; q < q0 + 32; q += 4) {
    float4 a[4], b[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(&A[tr + 16 * i][q]);
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = *reinterpret_cast<const float4*>(&B[tc + 8 * j][q]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

enum Epilogue { STORE, SUB, SUB_TO_SMEM };

// acc = Ag Bg^T for 64x64 row-major tiles (Ag with leading dimension ld, Bg
// with ldb; Bg == Ag reads the operand once), then by `mode`:
//   STORE: out = acc;   SUB: out = C - acc;   SUB_TO_SMEM: sm.a = C - acc
// (C and out with leading dimension ld).  Not inlined: one copy of the code
// serves every phase, which keeps the kernel small.
__device__ __noinline__ void gemm_tile(const float* Ag, const float* Bg, size_t ldb,
                                       size_t ld, const float* C, float* out, int mode) {
  const bool same = Ag == Bg;
  __syncthreads();  // the previous user of sm is done
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    load_half(sm.a, Ag, ld, h);
    if (!same) load_half(sm.b, Bg, ldb, h);
    cp_async_commit();
  }
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
  float acc[4][8], cv[4][8];
  if (mode != STORE) {  // C's loads fly while the product runs
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) cv[i][j] = __ldcg(C + (tr + 16 * i) * ld + tc + 8 * j);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const float(*B)[LD] = same ? sm.a : sm.b;
  cp_async_wait<1>();
  __syncthreads();
  nt64_half(sm.a, B, 0, acc);
  cp_async_wait<0>();
  __syncthreads();
  nt64_half(sm.a, B, 32, acc);
  if (mode == STORE) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) out[(tr + 16 * i) * ld + tc + 8 * j] = acc[i][j];
  } else if (mode == SUB) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) out[(tr + 16 * i) * ld + tc + 8 * j] = cv[i][j] - acc[i][j];
  } else {
    __syncthreads();  // every thread is done with the operand in sm.a
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sm.a[tr + 16 * i][tc + 8 * j] = cv[i][j] - acc[i][j];
    __syncthreads();
  }
}

// One warp: L, W = L^{-1} of the 32x32 SPD block S (lower part read), with
// no block barrier.  Writes L and W with zeros above the diagonal, and W^T
// to Wt if given.  S may be Lo; LT (32 x LDH) is scratch.  A pivot that is
// not positive makes everything after it NaN.
//
// L: the 32 column steps of ops/blocked.py:_leaf_chol_inv.  Lane r keeps
// in registers row r of the block's trailing columns, shifted left by one at
// every step so that column j is always a[0]: every step is the same short
// branch-free body.  At step j each lane publishes its raw entry a_rj in
// sm.col (rotated, so that the warp reads the trailing ones as aligned
// float4 broadcasts) and subtracts t_r = a_rj / a_jj times them, so
// 1/sqrt(a_jj) (rsqrtf and one Newton step) is not waited for before the
// publication.  Column j of L also goes to LT[j], rotated the same way.
//
// W: forward substitution L W = I after the sweep, lane c computing column
// c of W with the right-hand sides of the rows not yet done in registers
// (shifted as a is).  The JAX leaf builds W in the sweep by row updates;
// here that puts a broadcast of row j of W on every step of the sweep,
// while the substitution's loads do not depend on the lanes' results.
__device__ __forceinline__ void leaf32(const float* S, float* Lo, float* Wo, float* Wt,
                                       float (*LT)[LDH]) {
  const int r = threadIdx.x & 31;
  float a[H];
#pragma unroll
  for (int c = 0; c < H; ++c) a[c] = S[r * LD + c];
#pragma unroll 2
  for (int j = 0; j < H; ++j) {
    const float p = __shfl_sync(FULL, a[0], j);
    float* col = sm.col[j & 1];
    col[(r - j) & 31] = r > j ? a[0] : 0.f;  // col[c]: a_{j+c, j}
    float inv_d = rsqrtf(p);
    inv_d *= fmaf(-0.5f * p * inv_d, inv_d, 1.5f);
    const float t = r > j ? a[0] * (inv_d * inv_d) : 0.f;
    const float l = r == j ? p * inv_d : (r > j ? a[0] * inv_d : 0.f);
    Lo[r * LD + j] = l;
    LT[j][(r - j) & 31] = l;  // LT[j][q]: L_{j+q, j}, zero past the last row
    if (r == j) sm.inv_d[j] = inv_d;
    __syncwarp();
    float4 m[H / 4];  // all loads first: one latency per step, not eight
#pragma unroll
    for (int c = 0; c < H; c += 4) m[c / 4] = *reinterpret_cast<const float4*>(&col[c]);
#pragma unroll
    for (int c = 0; c < H; c += 4) {
      if (c) a[c - 1] = fmaf(-t, m[c / 4].x, a[c]);
      a[c] = fmaf(-t, m[c / 4].y, a[c + 1]);
      a[c + 1] = fmaf(-t, m[c / 4].z, a[c + 2]);
      a[c + 2] = fmaf(-t, m[c / 4].w, a[c + 3]);
    }
  }
  __syncwarp();
  // rows of L W = I in order: W_ic = b_i / L_ii, then b_q -= L_qi W_ic below
  const int c = r;
  float b[H];  // b[q]: the right-hand side of row i + q at row step i
#pragma unroll
  for (int q = 0; q < H; ++q) b[q] = q == c ? 1.f : 0.f;
  float4 m[H / 4];  // row i of LT; row i + 1 is loaded while row i is used
  float id = sm.inv_d[0];
#pragma unroll
  for (int q = 0; q < H; q += 4) m[q / 4] = *reinterpret_cast<const float4*>(&LT[0][q]);
#pragma unroll 1
  for (int i = 0; i < H; ++i) {
    const int in = (i + 1) & (H - 1);
    float4 mn[H / 4];
#pragma unroll
    for (int q = 0; q < H; q += 4) mn[q / 4] = *reinterpret_cast<const float4*>(&LT[in][q]);
    const float idn = sm.inv_d[in];
    const float x = b[0] * id;
    Wo[i * LD + c] = c <= i ? x : 0.f;
    if (Wt) Wt[c * LDH + i] = c <= i ? x : 0.f;
#pragma unroll
    for (int q = 0; q < H; q += 4) {
      if (q) b[q - 1] = fmaf(-m[q / 4].x, x, b[q]);
      b[q] = fmaf(-m[q / 4].y, x, b[q + 1]);
      b[q + 1] = fmaf(-m[q / 4].z, x, b[q + 2]);
      b[q + 2] = fmaf(-m[q / 4].w, x, b[q + 3]);
    }
#pragma unroll
    for (int q = 0; q < H / 4; ++q) m[q] = mn[q];
    id = idn;
  }
}

// acc[i][j] = sum_{q < 32} A[r0 + i][q] B[c0 + 8j][q] for a 32x32 output,
// r0 = 2 (thread / 8), c0 = thread % 8.
__device__ __forceinline__ void nt32(const float* A, int lda, const float* B, int ldb,
                                     float acc[2][4]) {
  const int r0 = (threadIdx.x >> 3) * 2, c0 = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int q = 0; q < H; q += 4) {
    float4 a[2], b[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) a[i] = *reinterpret_cast<const float4*>(&A[(r0 + i) * lda + q]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(&B[(c0 + 8 * j) * ldb + q]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// The 64x64 SPD block in sm.a (lower part) becomes L in sm.a (zeros above)
// and W = L^{-1} in sm.b, by the recursion of _chol_recursive /
// _tri_inv_recursive with 32-wide warp leaves:
//   L11, W11 = leaf(A11);  L21 = A21 W11^T;  L22, W22 = leaf(A22 - L21 L21^T);
//   W21 = -W22 (L21 W11).
// Call with the block loaded and the CTA synchronized; returns synchronized.
__device__ __noinline__ void leaf64() {
  const int warp = threadIdx.x >> 5;
  const int r0 = (threadIdx.x >> 3) * 2, c0 = threadIdx.x & 7;
  float acc[2][4], t[2][4];
  if (warp == 0) {
    leaf32(&sm.a[0][0], &sm.a[0][0], &sm.b[0][0], &sm.wt[0][0], sm.tt);
  } else {  // the upper quadrants of L and W
    for (int e = threadIdx.x - 32; e < H * H; e += THREADS - 32) {
      sm.a[e / H][H + e % H] = 0.f;
      sm.b[e / H][H + e % H] = 0.f;
    }
  }
  __syncthreads();
  nt32(&sm.a[H][0], LD, &sm.b[0][0], LD, acc);  // L21 = A21 W11^T
  __syncthreads();                               // A21 read by all
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sm.a[H + r0 + i][c0 + 8 * j] = acc[i][j];
  __syncthreads();
  nt32(&sm.a[H][0], LD, &sm.a[H][0], LD, acc);  // L21 L21^T
  nt32(&sm.a[H][0], LD, &sm.wt[0][0], LDH, t);  // T = L21 W11
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sm.a[H + r0 + i][H + c0 + 8 * j] -= acc[i][j];
      sm.tt[c0 + 8 * j][r0 + i] = t[i][j];
    }
  __syncthreads();
  if (warp == 0) leaf32(&sm.a[H][H], &sm.a[H][H], &sm.b[H][H], nullptr, sm.wt);
  __syncthreads();
  nt32(&sm.b[H][H], LD, &sm.tt[0][0], LDH, acc);  // W22 T
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sm.b[H + r0 + i][c0 + 8 * j] = -acc[i][j];
  __syncthreads();
}

// G[0:64, 0:64] <- S (leading dimensions ld and LD).
__device__ __forceinline__ void store_tile(float* G, size_t ld, const float (*S)[LD]) {
  for (int e = threadIdx.x; e < P * 16; e += THREADS) {
    const int r = e >> 4, c = (e & 15) * 4;
    *reinterpret_cast<float4*>(G + r * ld + c) = *reinterpret_cast<const float4*>(&S[r][c]);
  }
}

// sm.a <- G[0:64, 0:64] and wait.
__device__ __forceinline__ void load_tile(const float* G, size_t ld) {
  __syncthreads();
  load_half(sm.a, G, ld, 0);
  load_half(sm.a, G, ld, 1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// Factor the block in sm.a; write L to G (leading dimension ld) and W to Wk (64x64).
__device__ __forceinline__ void leaf_and_store(float* G, size_t ld, float* Wk) {
  leaf64();
  store_tile(G, ld, sm.a);
  store_tile(Wk, P, sm.b);
}

// src (B, n, n) SPD, read only; dst (B, n, n) receives L (zeros above the
// diagonal); Wd (B, n/64, 64, 64) the inverses of L's diagonal blocks.
// Until panel k has updated a tile, its value is read from src, afterwards
// from dst.  Launched cooperatively: every CTA reaches every grid.sync().
__global__ void __launch_bounds__(THREADS) chol_kernel(const float* src, float* dst, float* Wd,
                                                       int B, int n) {
  cg::grid_group grid = cg::this_grid();
  const int nb = n / P, G = gridDim.x, g = blockIdx.x;
  const size_t nn = static_cast<size_t>(n) * n;
  auto tile = [&](auto* base, int b, int i, int j) {
    return base + b * nn + static_cast<size_t>(i) * P * n + static_cast<size_t>(j) * P;
  };
  auto wdk = [&](int b, int k) { return Wd + (static_cast<size_t>(b) * nb + k) * P * P; };

  for (int b = g; b < B; b += G) {  // the leaf of panel 0
    load_tile(tile(src, b, 0, 0), n);
    leaf_and_store(tile(dst, b, 0, 0), n, wdk(b, 0));
  }
  for (int k = 0; k + 1 < nb; ++k) {
    const float* cur = k == 0 ? src : dst;  // where panel k's trailing matrix lives
    const int m = nb - k - 1;              // block rows below panel k
    grid.sync();
    // panel k: L21 = A21 W_kk^T in place, and zeros over the upper tiles of row k
    for (int t = g; t < 2 * B * m; t += G) {
      const int b = (t / m) % B, i = k + 1 + t % m;
      if (t < B * m) {
        gemm_tile(tile(cur, b, i, k), wdk(b, k), P, n, nullptr, tile(dst, b, i, k), STORE);
      } else {
        float* out = tile(dst, b, k, i);
        for (int e = threadIdx.x; e < P * 16; e += THREADS)
          *reinterpret_cast<float4*>(out + (e >> 4) * static_cast<size_t>(n) + (e & 15) * 4) =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    grid.sync();
    // trailing update of panel k.  Look-ahead: the CTA of matrix b updates
    // block (k+1, k+1) first and factors it (panel k+1's leaf) ...
    for (int b = g; b < B; b += G) {
      const float* l = tile(dst, b, k + 1, k);
      gemm_tile(l, l, n, n, tile(cur, b, k + 1, k + 1), nullptr, SUB_TO_SMEM);
      leaf_and_store(tile(dst, b, k + 1, k + 1), n, wdk(b, k + 1));
    }
    // ... while the other CTAs (all of them if the grid is not larger than
    // the batch) take the other lower tiles A_ij -= L_ik L_jk^T, k < j <= i.
    const int per = m * (m + 1) / 2 - 1;
    const int w0 = G > B ? B : 0, nw = G - w0;
    if (g >= w0) {
      for (int t = g - w0; t < B * per; t += nw) {
        const int b = t / per, u = t % per + 1;
        int ii = static_cast<int>((sqrtf(8.f * u + 1.f) - 1.f) * 0.5f);
        while (ii * (ii + 1) / 2 > u) --ii;
        while ((ii + 1) * (ii + 2) / 2 <= u) ++ii;
        const int i = k + 1 + ii, j = k + 1 + u - ii * (ii + 1) / 2;
        gemm_tile(tile(dst, b, i, k), tile(dst, b, j, k), n, n, tile(cur, b, i, j),
                  tile(dst, b, i, j), SUB);
      }
    }
  }
}

// The leaf alone on (B, 64, 64) blocks, one CTA each, repeated reps times
// (reps > 1 times the leaf without the launch).
__global__ void __launch_bounds__(THREADS) chol_leaf_kernel(const float* D, float* L, float* W,
                                                            int reps) {
  const size_t off = static_cast<size_t>(blockIdx.x) * P * P;
  for (int it = 0; it < reps; ++it) {
    load_tile(D + off, P);
    leaf_and_store(L + off, P, W + off);
  }
}

}  // namespace

// A (B, n, n) SPD; L (B, n, n) receives the factor, zeros above the diagonal;
// Wd (B, n/64, 64, 64) the diagonal-block inverses.  n % 64 == 0.  One
// cooperative launch of one CTA per SM, fewer if the work is smaller: at two
// per SM the CTA on the chain shares its SM, and on an H100 80GB HBM3 (700 W)
// K2 at n = 2048 took 0.81 ms against 0.70 and K3a at (4, 1024) 0.40 against
// 0.35, equal below n = 1024.  A refused launch returns its error.
extern "C" int ff_chol_inv(const float* A, float* L, float* Wd, int B, int n, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = ff::device_sms(&dev, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nb = n / P;
  const long long work = B * (nb * (nb - 1) / 2 > 1 ? nb * (nb - 1) / 2 : 1);
  const long long grid = sms < work ? sms : work;
  void* args[] = {&A, &L, &Wd, &B, &n};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(chol_kernel),
                                    dim3(static_cast<unsigned>(grid)), dim3(THREADS), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// D (B, 64, 64) SPD blocks; L, W (B, 64, 64) receive the leaf's factor and inverse.
extern "C" int ff_chol_leaf(const float* D, float* L, float* W, int B, int reps, void* stream) {
  chol_leaf_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(D, L, W, reps);
  return static_cast<int>(cudaGetLastError());
}
