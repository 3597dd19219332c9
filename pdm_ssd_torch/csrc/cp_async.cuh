// Asynchronous copies from global to shared memory (cp.async, sm_80 and
// later) and a once-per-card flag, shared by the sparse conv's kernels.
#pragma once

#include <cuda_runtime.h>

namespace pdm_ssd {

// Kernel attributes belong to a device: each layout sets its own once per
// card (cudaFuncSetAttribute costs host time on every call). Setting one
// twice, as two threads racing here may, is harmless.
struct OncePerDevice {
  bool done[64] = {};
  bool* slot() {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return nullptr;
    return &done[dev];
  }
};

// cp.async of BYTES (4 or 16) from global to shared memory; where `valid` is
// false nothing is read and the destination is zero-filled.
template <int BYTES>
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

}  // namespace pdm_ssd
