// Farthest point sampling for Hopper (sm_90a).
//
// Replaces the TPU kernel `farthest_point_sample_pallas`
// (pdm_ssd_tpu/ops/pallas/fps.py). Semantics are those of the plain
// version in pdm_ssd_torch/ops/pointnet2.py: the first pick is index 0, every
// point keeps the running minimum of its squared distance to the picks
// (starting from 1e10), and each step picks the first index of the maximum.
//
// What bounds it: FPS is a chain of npoint - 1 dependent arg-max reductions
// over one cloud, so the time is the latency of one block-wide reduction per
// step, not bytes or FLOPs.
//
// Design: one block of up to 1024 threads per cloud. Thread t owns points
// t, t + T, t + 2T, ... (PPT of them). Their coordinates stay in registers for
// the whole run; the running minima live in shared memory (PPT * T floats),
// because coordinates plus minima of a 16384-point cloud (256 KB) exceed
// both the register file and the shared memory of one SM. Each step:
//   1. every thread reads the last pick's xyz from shared memory,
//   2. updates its points' minima and keeps a local (max, lowest index)
//      together with the winner's coordinates,
//   3. a warp arg-max with __shfl_xor_sync, then warp 0 reduces the per-warp
//      winners from shared memory,
//   4. lane 0 of warp 0 writes out[b, i] and the new pick's xyz.
// The distance is (dx*dx + dy*dy) + dz*dz with round-to-nearest intrinsics,
// so no FMA contraction changes the rounding against the plain version.
// Only B blocks run (B SMs of 132); a cluster per cloud is later work.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kMaxThreads = 1024;
constexpr float kBig = 1e10f;

__device__ __forceinline__ void warp_argmax(float& d, int& i, float& x, float& y, float& z) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, d, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    const float ox = __shfl_xor_sync(0xffffffffu, x, off);
    const float oy = __shfl_xor_sync(0xffffffffu, y, off);
    const float oz = __shfl_xor_sync(0xffffffffu, z, off);
    if (od > d || (od == d && oi < i)) {
      d = od;
      i = oi;
      x = ox;
      y = oy;
      z = oz;
    }
  }
}

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads, 1)
    fps_kernel(const float* __restrict__ xyz, int* __restrict__ out, int n, int npoint) {
  extern __shared__ float s_dist[];  // (PPT, T): point t + k*T at s_dist[k*T + t]
  __shared__ float s_wd[32], s_wx[32], s_wy[32], s_wz[32];
  __shared__ int s_wi[32];
  __shared__ float s_last[3];

  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  const float* p = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  int* o = out + static_cast<size_t>(blockIdx.x) * npoint;

  float px[PPT], py[PPT], pz[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int j = tid + k * T;
    px[k] = py[k] = pz[k] = 0.f;
    // padding points hold -1 and can never win against a real point (>= 0)
    float d0 = -1.f;
    if (j < n) {
      px[k] = p[3 * j];
      py[k] = p[3 * j + 1];
      pz[k] = p[3 * j + 2];
      d0 = kBig;
    }
    s_dist[k * T + tid] = d0;
  }
  if (tid == 0) {
    o[0] = 0;
    s_last[0] = p[0];
    s_last[1] = p[1];
    s_last[2] = p[2];
  }
  __syncthreads();

  for (int it = 1; it < npoint; ++it) {
    const float lx = s_last[0], ly = s_last[1], lz = s_last[2];
    float bd = -2.f, bx = 0.f, by = 0.f, bz = 0.f;
    int bi = INT_MAX;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const float dx = __fsub_rn(px[k], lx);
      const float dy = __fsub_rn(py[k], ly);
      const float dz = __fsub_rn(pz[k], lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const float m = fminf(s_dist[k * T + tid], d);
      s_dist[k * T + tid] = m;
      if (m > bd) {  // strict: the lowest index wins within the thread
        bd = m;
        bi = tid + k * T;
        bx = px[k];
        by = py[k];
        bz = pz[k];
      }
    }
    warp_argmax(bd, bi, bx, by, bz);
    if (lane == 0) {
      s_wd[warp] = bd;
      s_wi[warp] = bi;
      s_wx[warp] = bx;
      s_wy[warp] = by;
      s_wz[warp] = bz;
    }
    __syncthreads();
    if (warp == 0) {
      if (lane < nwarps) {
        bd = s_wd[lane];
        bi = s_wi[lane];
        bx = s_wx[lane];
        by = s_wy[lane];
        bz = s_wz[lane];
      } else {
        bd = -2.f;
        bi = INT_MAX;
      }
      warp_argmax(bd, bi, bx, by, bz);
      if (lane == 0) {
        o[it] = bi;
        s_last[0] = bx;
        s_last[1] = by;
        s_last[2] = bz;
      }
    }
    __syncthreads();
  }
}

template <int PPT>
int launch(const float* xyz, int* out, int B, int N, int npoint, int threads, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * PPT * threads;
  cudaError_t err = cudaFuncSetAttribute(fps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fps_kernel<PPT><<<B, threads, smem, stream>>>(xyz, out, N, npoint);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Largest cloud the kernel takes (points per thread 32, 1024 threads).
extern "C" int fps_max_points() { return 32 * kMaxThreads; }

// xyz: (B, N, 3) float32 contiguous on the device; out: (B, npoint) int32.
// Returns 0 or the CUDA error of the launch; does not synchronize.
extern "C" int fps_launch(const float* xyz, int* out, int B, int N, int npoint, cudaStream_t stream) {
  if (B < 1 || N < 1 || npoint < 1 || N > fps_max_points()) return static_cast<int>(cudaErrorInvalidValue);
  const int per_thread = (N + kMaxThreads - 1) / kMaxThreads;
  if (per_thread == 1) {
    const int threads = (N + 31) / 32 * 32;
    return launch<1>(xyz, out, B, N, npoint, threads, stream);
  }
  if (per_thread <= 2) return launch<2>(xyz, out, B, N, npoint, kMaxThreads, stream);
  if (per_thread <= 4) return launch<4>(xyz, out, B, N, npoint, kMaxThreads, stream);
  if (per_thread <= 8) return launch<8>(xyz, out, B, N, npoint, kMaxThreads, stream);
  if (per_thread <= 16) return launch<16>(xyz, out, B, N, npoint, kMaxThreads, stream);
  return launch<32>(xyz, out, B, N, npoint, kMaxThreads, stream);
}
