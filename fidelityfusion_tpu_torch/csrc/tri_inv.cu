// K3b: W = L^{-1} for lower-triangular L, batched, from the inverses W_kk of
// L's 64x64 diagonal blocks that the factorization's leaf already produced.
//
// Replaces benchmarks/retired/pallas_batched.py:186 tri_inv_vmem (pallas_call
// at :190, body _tri_inv_vmem_kernel :139, _tri_inv_recursive :94).  The TPU
// kernel walked the block rows in order on one core with the whole matrix
// in VMEM; here the same inverse is the halving recursion of
// _tri_inv_recursive and of fidelityfusion_tpu/ops/blocked.py:97
// _tri_inv_assemble (hb = nb // 2 blocks on the left; nb need not be a
// power of two), computed level by level, deepest first, in one persistent
// cooperative launch:
//   level 0:  W_kk = Wd[k]; every tile above the diagonal is zero;
//   a node [s, s + m) at each level, m1 = m / 2 blocks left and m2 = m - m1
//   right, once both halves are inverted:
//     phase 1:  T   =  L21 W11     (grid barrier)
//     phase 2:  W21 = -W22 T       (grid barrier)
// W11 and W22 are lower-triangular, so their zero tiles are skipped: output
// tile (i, j) of phase 1 chains m1 - j 64x64x64 products, of phase 2 i + 1
// (local i, j), and one inverse costs n^3/6 FMAs, as the row recurrence does.
// T lives in a scratch the size of W (phase 2 reads T's column tiles while
// it writes W21); diagonal tiles of W are read from Wd, so level 0 has no
// reader and needs no barrier: 2 ceil(log2 nb) - 1 barriers in all.
//
// Bound on the H100: operations, n^3/3 FLOPs per matrix at the fp32 rate
// (67 TFLOP/s; full fp32, no TF32): 21 us at (4, 1024).  In practice it is
// bound by the longest chain of a level, m1 tile products in phase 1 at
// the top level, whatever the grid: 0.108 ms at (4, 1024) and 0.193 ms at
// (1, 2048) on an H100 80GB HBM3 at 700 W, about 3 us per chained product.
// What the design does about that:
//   * one launch per inverse (one CTA per SM, capped by the work), instead
//     of one per block row whose CTAs waited on the longest row's chain;
//   * in each phase, all (matrix, node, output tile) items of the level
//     are spread over the grid statically, longest chains first, in a snake
//     order (pass 1 gives CTA g item g, pass 2 item 2G - 1 - g, ...) so that
//     a CTA with a long chain gets a short one next: deterministic, no
//     atomics;
//   * the chain's operands are staged by cp.async in two stages: the next
//     tile pair loads while the current product runs (4x8 outputs a
//     thread, 64-deep, all in shared memory; the product is A B, so B's
//     rows are read as float4 along the output's columns).
// Every CTA reaches every barrier whatever the data; a NaN in one matrix's
// L or Wd only reaches that matrix's W.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int P = 64;         // tile = Wd's block width
constexpr int LD = P + 4;     // 16-byte rows; the four rows a warp reads of A hit distinct banks
constexpr int THREADS = 128;  // 4 warps; thread (tr, tc) = (tid / 8, tid % 8)

struct Stage {
  float a[P][LD];
  float b[P][LD];
};
constexpr int SMEM_BYTES = 2 * static_cast<int>(sizeof(Stage));  // 69632: dynamic

// The kernel's two stages, declared here so that `chain` (not inlined)
// addresses them as shared.
extern __shared__ __align__(16) Stage st[];

// A chain's operand: tile t is at p + t * step (leading dimension ld), except
// tile diag_at, which is the 64x64 block diag (leading dimension P).
struct Operand {
  const float* p;
  size_t step, ld;
  const float* diag;
  int diag_at;
};

__device__ __forceinline__ void load_tile_async(float (*S)[LD], const Operand& o, int t) {
  const bool d = t == o.diag_at;
  const float* G = d ? o.diag : o.p + t * o.step;
  const size_t ld = d ? P : o.ld;
  for (int e = threadIdx.x; e < P * 16; e += THREADS) {
    const int r = e >> 4, c = (e & 15) * 4;
    ff::cp_async16(&S[r][c], G + r * ld + c);
  }
}

// acc[i][j] += sum_q A[tr + 16i][q] B[q][col_j], col_j = 4 tc + j (j < 4),
// 32 + 4 tc + j - 4 (j >= 4).
__device__ __forceinline__ void nn64(const float (*A)[LD], const float (*B)[LD], float acc[4][8]) {
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
#pragma unroll 2
  for (int q = 0; q < P; q += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(&A[tr + 16 * i][q]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 b0 = *reinterpret_cast<const float4*>(&B[q + u][4 * tc]);
      const float4 b1 = *reinterpret_cast<const float4*>(&B[q + u][32 + 4 * tc]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = u == 0 ? a[i].x : u == 1 ? a[i].y : u == 2 ? a[i].z : a[i].w;
        acc[i][0] = fmaf(x, b0.x, acc[i][0]);
        acc[i][1] = fmaf(x, b0.y, acc[i][1]);
        acc[i][2] = fmaf(x, b0.z, acc[i][2]);
        acc[i][3] = fmaf(x, b0.w, acc[i][3]);
        acc[i][4] = fmaf(x, b1.x, acc[i][4]);
        acc[i][5] = fmaf(x, b1.y, acc[i][5]);
        acc[i][6] = fmaf(x, b1.z, acc[i][6]);
        acc[i][7] = fmaf(x, b1.w, acc[i][7]);
      }
    }
  }
}

// out = sign * sum_{t < len} A_t B_t (64x64 tiles; out with leading
// dimension ld).  Two stages: tile pair t + 1 loads while pair t is
// multiplied.  Not inlined: one copy serves both phases.
__device__ __noinline__ void chain(const Operand& A, const Operand& B, int len,
                                   float sign, float* out, size_t ld) {
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  load_tile_async(st[0].a, A, 0);
  load_tile_async(st[0].b, B, 0);
  ff::cp_async_commit();
  for (int t = 0; t < len; ++t) {
    if (t + 1 < len) {  // the stage it fills was released by the barrier ending step t - 1
      load_tile_async(st[(t + 1) & 1].a, A, t + 1);
      load_tile_async(st[(t + 1) & 1].b, B, t + 1);
      ff::cp_async_commit();
      ff::cp_async_wait<1>();
    } else {
      ff::cp_async_wait<0>();
    }
    __syncthreads();
    nn64(st[t & 1].a, st[t & 1].b, acc);
    __syncthreads();
  }
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = out + (tr + 16 * i) * ld;
    *reinterpret_cast<float4*>(row + 4 * tc) =
        make_float4(sign * acc[i][0], sign * acc[i][1], sign * acc[i][2], sign * acc[i][3]);
    *reinterpret_cast<float4*>(row + 32 + 4 * tc) =
        make_float4(sign * acc[i][4], sign * acc[i][5], sign * acc[i][6], sign * acc[i][7]);
  }
}

// Node `i` of the 2^depth at that depth of the halving recursion over nb
// blocks (hb = m / 2 on the left): start s and size m (0 or a repeated
// leaf past the bottom; only m >= 2 is ever used).
__device__ __forceinline__ void node_of(int nb, int depth, int i, int& s, int& m) {
  s = 0;
  m = nb;
  for (int l = depth - 1; l >= 0; --l) {
    const int h = m >> 1;
    if ((i >> l) & 1) {
      s += h;
      m -= h;
    } else {
      m = h;
    }
  }
}

// L (B, n, n) lower-triangular, read only; Wd (B, nb, 64, 64); W (B, n, n)
// receives L^{-1}; T (B, n, n) scratch (its strictly lower tiles are used).
// Launched cooperatively: every CTA reaches every grid.sync().
__global__ void __launch_bounds__(THREADS) tri_inv_kernel(const float* L, const float* Wd,
                                                          float* W, float* T, int B, int n) {
  cg::grid_group grid = cg::this_grid();
  const int nb = n / P, G = gridDim.x, g = blockIdx.x;
  const size_t nn = static_cast<size_t>(n) * n, row_step = static_cast<size_t>(P) * n;
  auto tile = [&](auto* base, int b, int i, int j) {
    return base + b * nn + i * row_step + static_cast<size_t>(j) * P;
  };
  auto wd = [&](int b, int k) { return Wd + (static_cast<size_t>(b) * nb + k) * P * P; };

  // level 0: the diagonal tiles from Wd and zeros above them
  for (int t = g; t < B * nb * nb; t += G) {
    const int b = t / (nb * nb), i = t / nb % nb, j = t % nb;
    if (j < i) continue;
    float* out = tile(W, b, i, j);
    const float* src = wd(b, i);
    for (int e = threadIdx.x; e < P * 16; e += THREADS) {
      const int r = e >> 4, c = (e & 15) * 4;
      *reinterpret_cast<float4*>(out + r * static_cast<size_t>(n) + c) =
          j == i ? __ldg(reinterpret_cast<const float4*>(src + r * P + c))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  int depth = 0;  // levels: depths D - 1 .. 0, D = ceil(log2 nb)
  while ((1 << depth) < nb) ++depth;
  for (--depth; depth >= 0; --depth) {
    const int M = (nb + (1 << depth) - 1) >> depth;  // the largest node at this depth
    const int M1 = M >> 1, M2 = M - M1, nodes = 1 << depth;
    // phase 1: item (o, node, b, il) -> T tile (s + m1 + il, s + o), chain m1 - o
    {
      const long long per_o = static_cast<long long>(nodes) * B * M2, total = per_o * M1;
      for (long long base = 0; base < total; base += 2LL * G) {
        for (int pass = 0; pass < 2; ++pass) {
          const long long p = base + (pass ? 2 * G - 1 - g : g);
          if (p >= total) continue;
          const int o = static_cast<int>(p / per_o);
          const int r = static_cast<int>(p % per_o);
          const int q = r / (B * M2), b = r / M2 % B, il = r % M2;
          int s, m;
          node_of(nb, depth, q, s, m);
          const int m1 = m >> 1, m2 = m - m1;
          if (o >= m1 || il >= m2) continue;
          const int row = s + m1 + il, col = s + o;
          const Operand A{tile(L, b, row, col), P, static_cast<size_t>(n), nullptr, -1};
          const Operand Bo{tile(W, b, col, col), row_step, static_cast<size_t>(n), wd(b, col), 0};
          chain(A, Bo, m1 - o, 1.f, tile(T, b, row, col), n);
        }
      }
    }
    grid.sync();
    // phase 2: item (o, node, b, jl) -> W tile (s + m1 + il, s + jl) with
    // il = M2 - 1 - o, chain il + 1
    {
      const long long per_o = static_cast<long long>(nodes) * B * M1, total = per_o * M2;
      for (long long base = 0; base < total; base += 2LL * G) {
        for (int pass = 0; pass < 2; ++pass) {
          const long long p = base + (pass ? 2 * G - 1 - g : g);
          if (p >= total) continue;
          const int il = M2 - 1 - static_cast<int>(p / per_o);
          const int r = static_cast<int>(p % per_o);
          const int q = r / (B * M1), b = r / M1 % B, jl = r % M1;
          int s, m;
          node_of(nb, depth, q, s, m);
          const int m1 = m >> 1, m2 = m - m1;
          if (jl >= m1 || il >= m2) continue;
          const int s2 = s + m1, row = s2 + il, col = s + jl;
          const Operand A{tile(W, b, row, s2), P, static_cast<size_t>(n), wd(b, row), il};
          const Operand Bo{tile(T, b, s2, col), row_step, static_cast<size_t>(n), nullptr, -1};
          chain(A, Bo, il + 1, -1.f, tile(W, b, row, col), n);
        }
      }
    }
    if (depth > 0) grid.sync();
  }
}

}  // namespace

// L (B, n, n) lower-triangular; Wd (B, n/64, 64, 64) the inverses of its
// diagonal blocks; W (B, n, n) receives L^{-1}, every element written; T
// (B, n, n) scratch.  n % 64 == 0.  One cooperative launch of at most one
// CTA per SM (the top level's phase-1 items cap it).  A refused launch
// returns its error.
extern "C" int ff_tri_inv(const float* L, const float* Wd, float* W, float* T, int B, int n,
                          void* stream) {
  if (B <= 0 || n <= 0) return 0;
  static bool smem_set[ff::MAX_DEVICES];  // the 68 KB opt-in, once per device
  int dev = 0, sms = 0;
  cudaError_t err = ff::device_sms(&dev, &sms);
  if (err == cudaSuccess && !(dev < ff::MAX_DEVICES && smem_set[dev])) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(tri_inv_kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err == cudaSuccess && dev < ff::MAX_DEVICES) smem_set[dev] = true;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nb = n / P;
  const long long top = static_cast<long long>(B) * (nb / 2) * (nb - nb / 2);
  const long long work = top > B ? top : B;
  const long long grid = sms < work ? sms : work;
  void* args[] = {&L, &Wd, &W, &T, &B, &n};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(tri_inv_kernel),
                                    dim3(static_cast<unsigned>(grid)), dim3(THREADS), args,
                                    SMEM_BYTES, static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
