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

constexpr int MAX_DEVICES = 64;

// The current device (*dev) and its SM count (*sms), the count queried once
// per device and process, so that a launch costs no attribute query.
inline cudaError_t device_sms(int* dev, int* sms) {
  static int known[MAX_DEVICES];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < MAX_DEVICES && known[*dev] > 0) {
    *sms = known[*dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
  if (err == cudaSuccess && *dev < MAX_DEVICES) known[*dev] = *sms;
  return err;
}

// 16 bytes global -> shared, asynchronously, cached in L2 only: the operands
// of the cooperative kernels may have been written earlier in the same
// launch by another CTA, so they must not come through L1.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
// The same copy reading only the first `bytes` (0, 4, 8, 12 or 16) of src and
// writing zeros over the rest of dst; with 0, src is not read at all.
__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace ff
