// K5: the symmetric eigendecomposition of a batch of small float64 matrices,
//
//   (K[b] + K[b]^T) / 2 = V[b] diag(w[b]) V[b]^T,  w[b] ascending,
//
// n <= 64, one CTA a matrix, in one launch: the mode Grams of the Kronecker
// NLML (fidelityfusion_tpu_torch/ops/kron.py:eigh_pairs, 8 to 32 rows in
// the GAR fit, for all restarts at once).
//
// Replaces no TPU kernel: the JAX package left eigh to XLA.  It was added
// because torch.linalg.eigh sends every float64 size to cuSOLVER's syevd,
// which takes a batch's matrices one after another, each a chain of some 20
// small kernels, and then reads the solver's status back to the host: a
// device sync on every call, twice a training step.  K5 needs no workspace
// query, reads nothing back and allocates nothing.
//
// Bound on the H100: latency.  The work is ~9 n^3 FLOPs a matrix (0.3
// MFLOP at n = 32) and 2 n^2 doubles of traffic, each well under a
// microsecond at the card's peaks; the time is the chain of dependent
// Jacobi rounds, (n - 1) a sweep, each round a rotation (two reciprocal
// square roots and a reciprocal) and a 2 x 2 block update between two
// barriers, some 1,200 cycles of one warp's dependent instructions.
// What the design does about it:
//   * fewer sweeps: they start from C^T K C, C the orthonormal DCT-II basis,
//     and V = C.  The callers' Grams are stationary kernels on regular 1-D
//     grids, whose eigenvectors lie close to C's columns, and C's even and
//     odd columns keep a symmetric grid's two halves of the spectrum apart
//     (those couplings start at zero and are never rotated).  In a float64
//     model of the rounds, SE Grams of 16 to 64 points at length scales of
//     0.3 to 16 grid steps took 4-6 sweeps from C against 5-16 from the
//     identity; a matrix without that structure gets an orthogonal change
//     of basis for two small products' cost;
//   * one CTA a matrix with A, V and the start's product in shared memory
//     (3 m^2 doubles, m = n rounded up to even: 24 KB at n = 32, 96 KB at
//     n = 64 by the dynamic shared-memory opt-in), so a round touches no
//     global memory;
//   * parallel cyclic Jacobi in the round-robin order: each round rotates
//     m / 2 disjoint pairs (p, q) at once, and in m - 1 rounds every pair
//     meets once.  An odd n gets a zero row and column, whose pairs have
//     A_pq = 0 and never rotate;
//   * a round is two phases.  One warp computes the pairs' rotations, the
//     tangent t = e / (d + sign(d) sqrt(d^2 + e^2)) (d = A_qq - A_pp,
//     e = 2 A_pq; the smaller angle), and the pair's new diagonal entries
//     A_pp - t A_pq and A_qq + t A_pq.  A pair whose A_pq^2 is under the
//     stopping test's tolerance over m^2 is left as it is: inside a cluster
//     of equal (or negligible) eigenvalues such a rotation may turn by up to
//     45 degrees and shuffles the couplings that the other pairs are
//     eliminating (in the model, a matrix with two eigenvalues, each n / 2
//     times, took 15 sweeps at n = 64 with this rule and 17 without it, an
//     SE Gram 6 and 7).  Then each thread owns one 2 x 2
//     block of A (rows of pair k, columns of pair l), applies pair k's
//     rotation to its rows and pair l's to its columns, and applies pair l's
//     to the same block of V: the blocks partition A and V, so each is read
//     and written in place by one thread, and a round needs two barriers.
//     A rotated pair's diagonal block (k = l) takes its new diagonal and
//     zeros directly;
//   * A's rows are not padded: the round-robin pairs hold consecutive
//     indices, so phase 2's reads along a row and phase 1's reads of A_pp
//     and A_pq fall in distinct banks; a row stride of m + 1 would put all
//     of phase 1's A_pq, whose p + q is nearly constant, in one bank;
//   * it stops on the device when off(A) <= n 2^-53 ||A||_F after a sweep,
//     or after MAX_SWEEPS.  off(A)^2 is summed as the sweep's last round
//     writes its blocks, so the test costs no barrier of its own;
//   * it orders the values ascending in the CTA (each one's rank by count,
//     ties by index) and writes V's columns in that order;
//   * it symmetrizes at the load, and screens for non-finite entries: such a
//     matrix gives NaN values and identity vectors, as eigh_pairs' plain
//     path does.
#include "common.cuh"

namespace {

constexpr int MAX_N = 64;  // 3 * 64^2 doubles of A, V and the start's product: 96 KB
constexpr int MAX_HALF = MAX_N / 2;
// The sweep cap.  In a float64 model of these rounds the stopping test
// ended every matrix of the card tests and SE Grams of 16 to 64 grid points
// at length scales 0.3 to 16 grid steps within 15 sweeps (SE Grams within
// 6): the cap only bounds a matrix that never meets it.
constexpr int MAX_SWEEPS = 30;
constexpr double EPS = 1.1102230246251565e-16;  // 2^-53

// The index at position `pos` of round `r` of the round-robin order over m
// (even) indices: index 0 stays at position 0, the others move one position
// a round, and position k meets position m - 1 - k.
__device__ __forceinline__ int at_position(int pos, int r, int m) {
  if (pos == 0) return 0;
  const int v = pos - 1 + r;  // < 2 (m - 1): one conditional subtraction, no division
  return 1 + (v >= m - 1 ? v - (m - 1) : v);
}

// (a, b) <- (c a - s b, s a + c b): one rotation of a pair of values held in
// registers (rotating through references into shared memory made the
// compiler reload b after storing a, a round trip to shared memory on each
// rotation's chain).
__device__ __forceinline__ void rotate(double& a, double& b, double c, double s) {
  const double a0 = a;
  a = fma(c, a0, -s * b);
  b = fma(s, a0, c * b);
}

// NaN last, NaNs equal: a strict total order with the index as tie-break.
__device__ __forceinline__ bool before(double x, int i, double y, int j) {
  const bool xn = isnan(x), yn = isnan(y);
  if (xn || yn) return (!xn && yn) || (xn && yn && i < j);
  return x < y || (x == y && i < j);
}

// The sums of `a` and `b` over the CTA, returned to every thread; blockDim.x
// is a multiple of 32 and `part` 64 doubles of scratch.
__device__ __forceinline__ void block_sum2(double& a, double& b, double* part) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
  if ((threadIdx.x & 31) == 0) {
    part[warp] = a;
    part[MAX_HALF + warp] = b;
  }
  __syncthreads();
  a = b = 0.0;
  for (int i = 0; i < warps; ++i) {
    a += part[i];
    b += part[MAX_HALF + i];
  }
}

// One CTA of max(32, (m / 2)^2 rounded up to a warp) threads per matrix:
// thread k * (m / 2) + l owns block (k, l).
__global__ void __launch_bounds__(1024, 1)
small_eigh_kernel(const double* __restrict__ K, double* __restrict__ w,
                  double* __restrict__ V_out, int n) {
  extern __shared__ double smem[];
  __shared__ int pair_p[MAX_HALF], pair_q[MAX_HALF], rank[MAX_N];
  __shared__ double rot_c[MAX_HALF], rot_s[MAX_HALF], diag_p[MAX_HALF], diag_q[MAX_HALF];
  __shared__ double part[2 * MAX_HALF];

  const int m = n + (n & 1), h = m / 2, tid = threadIdx.x;
  double* A = smem;              // m x m, row stride m
  double* V = smem + m * m;      // m x m, row stride m
  double* T = smem + 2 * m * m;  // m x m: K C, the start's product
  const size_t b = blockIdx.x;
  const double* Kb = K + b * n * n;
  double* wb = w + b * n;
  double* Vb = V_out + b * n * n;

  // A <- (K + K^T) / 2 and V <- C, the orthonormal DCT-II basis (C_ij =
  // sqrt((2 - [j = 0]) / n) cos(pi (2 i + 1) j / (2 n))), both padded by a
  // zero row and column (V's pad: 1 on the diagonal) at an odd n
  int bad = 0;
  const double c0 = sqrt(1.0 / n), c1 = sqrt(2.0 / n);
  for (int e = tid; e < m * m; e += blockDim.x) {
    const int i = e / m, j = e - i * m;
    double a = 0.0, v = i == j ? 1.0 : 0.0;
    if (i < n && j < n) {
      const double kij = Kb[i * n + j];
      bad |= !isfinite(kij);
      a = 0.5 * (kij + Kb[j * n + i]);
      v = j == 0 ? c0 : c1 * cospi((2 * i + 1) * j / (2.0 * n));
    }
    A[e] = a;
    V[e] = v;
  }
  if (__syncthreads_or(bad)) {
    for (int e = tid; e < n * n; e += blockDim.x) Vb[e] = e % (n + 1) == 0 ? 1.0 : 0.0;
    for (int i = tid; i < n; i += blockDim.x) wb[i] = __longlong_as_double(0x7ff8000000000000LL);
    return;
  }
  // the sweeps start from A <- C^T A C (its upper triangle, mirrored): T = A C,
  // then C^T T
  for (int e = tid; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e - i * n;
    double acc = 0.0;
    for (int q = 0; q < n; ++q) acc = fma(A[i * m + q], V[q * m + j], acc);
    T[i * m + j] = acc;
  }
  __syncthreads();
  double fro = 0.0, off = 0.0;
  for (int e = tid; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e - i * n;
    if (i > j) continue;
    double acc = 0.0;
    for (int q = 0; q < n; ++q) acc = fma(V[q * m + i], T[q * m + j], acc);
    A[i * m + j] = A[j * m + i] = acc;
    fro = fma(i == j ? 1.0 : 2.0, acc * acc, fro);
    if (i != j) off = fma(2.0, acc * acc, off);
  }
  block_sum2(fro, off, part);  // its barrier also publishes the new A
  const double tol = (n * EPS) * (n * EPS) * fro, pair_tol = tol / (m * m);

  const bool owns = tid < h * h;
  const int k = tid / h, l = tid - k * h;
  for (int sweep = 0; sweep < MAX_SWEEPS && off > tol; ++sweep) {
    for (int r = 0; r < m - 1; ++r) {
      if (tid < h) {
        const int p = at_position(tid, r, m), q = at_position(m - 1 - tid, r, m);
        const double app = A[p * m + p], aqq = A[q * m + q], apq = A[p * m + q];
        // t = sign(d) e / den, den = |d| + sqrt(d^2 + e^2), and c = 1 / sqrt(1 +
        // t^2) = den / sqrt(den^2 + e^2): two reciprocal square roots and a
        // reciprocal, the last two side by side, on the round's critical path
        double t = 0.0, c = 1.0, s = 0.0;  // t = 0: the pair is left as it is
        if (apq * apq > pair_tol) {
          const double d = aqq - app, e = 2.0 * apq, e2 = e * e, r2 = fma(d, d, e2);
          const double den = fabs(d) + r2 * rsqrt(r2), se = d < 0.0 ? -e : e;
          const double g = rsqrt(fma(den, den, e2));
          c = den * g;
          s = se * g;
          t = se * __drcp_rn(den);
        }
        pair_p[tid] = p;
        pair_q[tid] = q;
        rot_c[tid] = c;
        rot_s[tid] = s;
        diag_p[tid] = fma(-t, apq, app);
        diag_q[tid] = fma(t, apq, aqq);
      }
      __syncthreads();
      double acc = 0.0;
      if (owns) {
        const int pk = pair_p[k], qk = pair_q[k], pl = pair_p[l], ql = pair_q[l];
        const double cl = rot_c[l], sl = rot_s[l];
        double* v0 = V + pk * m;
        double* v1 = V + qk * m;
        double* a0 = A + pk * m;
        double* a1 = A + qk * m;
        // the block's 8 values, all loaded before any is stored
        double u00 = v0[pl], u01 = v0[ql], u10 = v1[pl], u11 = v1[ql];
        double x00 = a0[pl], x01 = a0[ql], x10 = a1[pl], x11 = a1[ql];
        rotate(u00, u01, cl, sl);  // V J_l
        rotate(u10, u11, cl, sl);
        if (k == l) {  // (pl, ql) = (pk, qk): the pair's own 2 x 2
          if (sl != 0.0) {
            x00 = diag_p[k];
            x11 = diag_q[k];
            x01 = x10 = 0.0;
          } else {
            acc = x01 * x01 + x10 * x10;
          }
        } else {
          const double ck = rot_c[k], sk = rot_s[k];
          rotate(x00, x10, ck, sk);  // rows: J_k^T A
          rotate(x01, x11, ck, sk);
          rotate(x00, x01, cl, sl);  // columns: (J_k^T A) J_l
          rotate(x10, x11, cl, sl);
          acc = x00 * x00 + x01 * x01 + x10 * x10 + x11 * x11;
        }
        v0[pl] = u00;
        v0[ql] = u01;
        v1[pl] = u10;
        v1[ql] = u11;
        a0[pl] = x00;
        a0[ql] = x01;
        a1[pl] = x10;
        a1[ql] = x11;
      }
      const bool last = r == m - 2;
      if (last) {
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if ((tid & 31) == 0) part[tid / 32] = acc;
      }
      __syncthreads();
      if (last) {
        off = 0.0;
        for (int i = 0; i < static_cast<int>(blockDim.x / 32); ++i) off += part[i];
      }
    }
  }

  if (tid < n) {
    const double di = A[tid * m + tid];
    int rk = 0;
    for (int j = 0; j < n; ++j) rk += before(A[j * m + j], j, di, tid);
    rank[tid] = rk;
    wb[rk] = di;
  }
  __syncthreads();
  for (int e = tid; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e - i * n;
    Vb[i * n + rank[j]] = V[i * m + j];
  }
}

}  // namespace

// K (B, n, n) contiguous float64, 1 <= n <= 64; w (B, n) and V (B, n, n)
// contiguous receive the ascending eigenvalues and the eigenvectors (as
// columns) of each (K + K^T) / 2, every element written.  A refused launch
// returns its error.
extern "C" int ff_small_eigh(const double* K, double* w, double* V, int B, int n, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (n > MAX_N) return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in[ff::MAX_DEVICES];  // the shared-memory opt-in, once a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m = n + (n & 1), h = m / 2;
  const int smem = 3 * m * m * static_cast<int>(sizeof(double));
  if (smem > 48 * 1024 && !(dev < ff::MAX_DEVICES && opted_in[dev])) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(small_eigh_kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               3 * MAX_N * MAX_N * static_cast<int>(sizeof(double)));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < ff::MAX_DEVICES) opted_in[dev] = true;
  }
  const int threads = h * h < 32 ? 32 : (h * h + 31) / 32 * 32;
  small_eigh_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(K, w, V, n);
  return static_cast<int>(cudaGetLastError());
}
