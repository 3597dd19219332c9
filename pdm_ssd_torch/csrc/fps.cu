// Farthest point sampling for Hopper (sm_90a): a thread-block cluster per
// cloud, and one block per cloud where a cluster does not fit or pay.
//
// Replaces the TPU kernel `farthest_point_sample_pallas`
// (pdm_ssd_tpu/ops/pallas/fps.py). Semantics are those of the plain
// version in pdm_ssd_torch/ops/pointnet2.py: the first pick is index 0, every
// point keeps the running minimum of its squared distance to the picks
// (starting from 1e10), and each step picks the first index of the maximum;
// npoint > N keeps picking (index 0 once every minimum is 0).
//
// Masked FPS (`mask` not null: one byte a point, nonzero where valid), as
// `farthest_point_sample(xyz, npoint, mask)` of pdm_ssd_tpu/ops/pointnet2.py
// computes it: the first pick is the first valid index (0 in a cloud with
// none), the running minima are kept as before, and a candidate outside the
// mask reads -1, so each pick is the first arg-max over the valid points'
// minima, and the lowest valid index once every valid point reads 0. An
// invalid point's minimum is never read: the block path stores -1 for it
// from the start, the cluster path's key of an invalid point is 0 and a
// valid point's is its minimum's bits plus 1. `groups` consecutive clouds
// read one cloud's coordinates (cloud c reads xyz cloud c / groups), so the
// sectors of a cloud, each with its own mask, run in one launch. Each path
// is a template on the mask, so the unmasked kernels are the code they were.
//
// What bounds it: FPS is a chain of npoint - 1 dependent arg-max reductions
// over one cloud, so the time is the latency of one cloud-wide reduction per
// step, not bytes or FLOPs. One block per cloud leaves B of 132 SMs busy and
// every step updates the whole cloud on one SM.
//
// Exactness. The distance is (dx*dx + dy*dy) + dz*dz with round-to-nearest
// intrinsics, so no FMA contraction changes the rounding against the plain
// version. The winner is the largest minimum, ties to the lowest index: a
// lexicographic maximum of (d, -i). That order is total, so the maximum is
// associative and commutative, and any split of the cloud over threads,
// warps and blocks, reduced in any order, picks the index the plain
// version's first-arg-max picks. Minima are >= +0, so their float bits
// order as unsigned integers, and the key is (bits of d, ~i) compared as
// unsigned pairs.
//
// Cluster path (`fps_cluster_kernel`): a cluster of S blocks (S <= 16) per
// cloud, one block per SM (the dynamic shared memory each block reserves
// leaves no room for a second). Block r owns points [r*T*PPT, (r+1)*T*PPT),
// thread t of it points t, t + T, ...; coordinates and running minima stay in
// registers. Slots past the cloud's end hold copies of point 0 under their
// own index >= N: they track point 0's minimum exactly and lose every tie to
// it, so they never win. One step:
//   1. each thread updates its minima and keeps its best key, with the
//      winner's coordinates; two `redux.sync` maxima give the warp's key, and
//      the lane that holds it writes (key, xyz) to its warp's record;
//   2. `__syncthreads`, then warp 0 reduces the warps' records to the block's
//      and writes it into the half of a double buffer the step's parity names;
//   3. one cluster barrier (arrive with release, wait with acquire);
//   4. warp 0 of every block reads the S block records of that parity
//      through distributed shared memory, one a lane, reduces them to the
//      same key and hands the pick, with its coordinates, to its block
//      through shared memory and a `__syncthreads`: no second cluster
//      barrier.
// The parity buffers make one cluster barrier a step enough: step it + 2
// rewrites the records that step it reads, and no block passes barrier it + 1
// before every block has finished its reads of step it. Two variants of this
// kernel, timed in turns with it at the flagship shape on an H100 at 700 W,
// were slower: every warp reading the warps' records of all blocks (8 times
// the bytes between SMs; 7.727 ms against 5.707 for an earlier form of the
// kernel here), and every warp reading the S block records (5.611 ms against
// 4.918 for warp 0 alone, which is the kernel here). Block rank 0 keeps the picks in shared memory and
// writes them out at the end: a store to device memory in the loop would hold
// up the barrier's release. A last barrier keeps each block's shared memory
// alive until the others have read it.
//
// Block path (`fps_block_kernel`): one block of up to 1024 threads per cloud
// (PointRCNN's ROI stack: 400 clouds of 512 and of 128 points fill the card
// with blocks alone). Coordinates in registers, minima in shared memory;
// per step a warp arg-max of (d, index) with shuffles, the winning lane
// publishes its point, then warp 0 reduces the warps' winners. A thread
// keeps its best slot, not its coordinates, and with several points a thread
// the block size is a compile-time constant, so `__launch_bounds__(1024, 1)`'s
// 64 registers hold 16 points a thread without spilling (ptxas spilled 144
// bytes when the thread tracked coordinates at a runtime block size, and 512
// threads of 32 points spilled too, at 128 registers).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr float kBig = 1e10f;
constexpr unsigned kFull = 0xffffffffu;

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

// ---- block path ----------------------------------------------------------

// the lexicographic maximum of (d, -i) over a warp, in every lane
__device__ __forceinline__ void warp_argmax(float& d, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(kFull, d, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (od > d || (od == d && oi < i)) {
      d = od;
      i = oi;
    }
  }
}

template <int PPT, int TMAX, bool MASK>
__global__ void __launch_bounds__(TMAX, 1)
    fps_block_kernel(const float* __restrict__ xyz, const unsigned char* __restrict__ mask,
                     int* __restrict__ out, int n, int npoint, int groups) {
  extern __shared__ float s_dist[];  // (PPT, T): point t + k*T at s_dist[k*T + t]
  __shared__ float s_wd[32], s_wx[32], s_wy[32], s_wz[32];
  __shared__ int s_wi[32];
  __shared__ float s_last[3];
  __shared__ int s_seed;

  // with several points a thread the block is TMAX threads, so k * T is a
  // constant offset and no register holds a slot's address
  const int T = PPT == 1 ? static_cast<int>(blockDim.x) : TMAX;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  const float* p = xyz + static_cast<size_t>(blockIdx.x / groups) * n * 3;
  const unsigned char* m = MASK ? mask + static_cast<size_t>(blockIdx.x) * n : nullptr;
  int* o = out + static_cast<size_t>(blockIdx.x) * npoint;
  if (MASK && tid == 0) s_seed = INT_MAX;
  if (MASK) __syncthreads();

  float px[PPT], py[PPT], pz[PPT];
  int seed = INT_MAX;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int j = tid + k * T;
    px[k] = py[k] = pz[k] = 0.f;
    // padding points, and points outside the mask, hold -1 and can never
    // win against a valid point (>= 0)
    float d0 = -1.f;
    if (j < n) {
      px[k] = p[3 * j];
      py[k] = p[3 * j + 1];
      pz[k] = p[3 * j + 2];
      if (!MASK || m[j]) {
        d0 = kBig;
        seed = min(seed, j);
      }
    }
    s_dist[k * T + tid] = d0;
  }
  if (MASK) {
    seed = __reduce_min_sync(kFull, seed);
    if (lane == 0 && seed != INT_MAX) atomicMin(&s_seed, seed);
    __syncthreads();
  }
  if (tid == 0) {
    // the first valid point, or point 0 where no point is valid
    const int first = MASK && s_seed != INT_MAX ? s_seed : 0;
    o[0] = first;
    s_last[0] = p[3 * first];
    s_last[1] = p[3 * first + 1];
    s_last[2] = p[3 * first + 2];
  }
  __syncthreads();

  for (int it = 1; it < npoint; ++it) {
    const float lx = s_last[0], ly = s_last[1], lz = s_last[2];
    // the thread's best as (d, slot): the coordinates are fetched once, by
    // the lane that wins its warp, which keeps registers for the points
    float bd = -2.f;
    int bk = 0;
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
        bk = k;
      }
    }
    const int mine = tid + bk * T;
    int bi = mine;
    warp_argmax(bd, bi);
    if (bi == mine) {  // one lane: the warp's winner is its point
      float bx = 0.f, by = 0.f, bz = 0.f;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (k == bk) {
          bx = px[k];
          by = py[k];
          bz = pz[k];
        }
      }
      s_wd[warp] = bd;
      s_wi[warp] = bi;
      s_wx[warp] = bx;
      s_wy[warp] = by;
      s_wz[warp] = bz;
    }
    __syncthreads();
    if (warp == 0) {
      bd = lane < nwarps ? s_wd[lane] : -2.f;
      bi = lane < nwarps ? s_wi[lane] : INT_MAX;
      const int own = bi;
      warp_argmax(bd, bi);
      if (bi == own) {
        o[it] = bi;
        s_last[0] = s_wx[lane];
        s_last[1] = s_wy[lane];
        s_last[2] = s_wz[lane];
      }
    }
    __syncthreads();
  }
}

template <int PPT, int TMAX, bool MASK>
int launch_block(const float* xyz, const unsigned char* mask, int* out, int B, int N,
                 int npoint, int groups, int threads, cudaStream_t stream) {
  if (threads < 32 || threads > TMAX || threads % 32 != 0 || threads * PPT < N ||
      (PPT > 1 && threads != TMAX))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(float)) * PPT * threads;
  static OncePerDevice once;  // for the largest block of this layout
  bool* done = once.slot();
  if (done == nullptr || !*done) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_block_kernel<PPT, TMAX, MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float)) * PPT * TMAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (done != nullptr) *done = true;
  }
  fps_block_kernel<PPT, TMAX, MASK><<<B, threads, smem, stream>>>(xyz, mask, out, N, npoint,
                                                                    groups);
  return static_cast<int>(cudaGetLastError());
}

// ---- cluster path --------------------------------------------------------

constexpr int kClusterThreads = 256;    // most threads a cluster block runs
constexpr int kMaxCluster = 16;
// Dynamic shared memory every cluster block reserves: more than half of an
// SM's 228 KB, so no SM holds two blocks and a cluster of S blocks spreads
// over S SMs. The records and block rank 0's picks use the front of it.
constexpr int kClusterSmem = 120 * 1024;

// A winner: key (bits of d, ~index) and coordinates, 32 bytes.
struct __align__(16) Record {
  uint4 key_xy;   // d bits, ~index, x bits, y bits
  uint4 z;        // z bits, unused
};

// shared memory of a cluster block: the warps' records, the block's record
// by step parity, then the picks
constexpr int kPickOffset = (kClusterThreads / 32 + 4) * static_cast<int>(sizeof(Record));

__device__ __forceinline__ bool better(unsigned d, unsigned ni, unsigned bd, unsigned bni) {
  return d > bd || (d == bd && ni > bni);
}

__device__ __forceinline__ void put(Record* r, unsigned d, unsigned ni, float x, float y, float z) {
  r->key_xy = make_uint4(d, ni, __float_as_uint(x), __float_as_uint(y));
  r->z = make_uint4(__float_as_uint(z), 0u, 0u, 0u);
}

// The lexicographic maximum, over a warp, of the records the lanes hold;
// returns the key in every lane and the winner's coordinates.
__device__ __forceinline__ void warp_pick(unsigned d, unsigned ni, unsigned x, unsigned y,
                                          unsigned z, unsigned& wd, unsigned& wni, float& wx,
                                          float& wy, float& wz) {
  wd = __reduce_max_sync(kFull, d);
  wni = __reduce_max_sync(kFull, d == wd ? ni : 0u);
  const int src = __ffs(__ballot_sync(kFull, d == wd && ni == wni)) - 1;
  wx = __uint_as_float(__shfl_sync(kFull, x, src));
  wy = __uint_as_float(__shfl_sync(kFull, y, src));
  wz = __uint_as_float(__shfl_sync(kFull, z, src));
}

template <int PPT, bool MASK>
__global__ void __launch_bounds__(kClusterThreads, 1)
    fps_cluster_kernel(const float* __restrict__ xyz, const unsigned char* __restrict__ mask,
                       int* __restrict__ out, int n, int npoint, int groups) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  Record* s_warp = reinterpret_cast<Record*>(s_raw);             // [T/32]
  Record* s_block = s_warp + kClusterThreads / 32;                // [2], by parity
  Record* s_pick_rec = s_block + 2;                               // [2]: the pick, by parity
  int* s_pick = reinterpret_cast<int*>(s_raw + kPickOffset);      // [npoint], rank 0
  __shared__ int s_seed;                                          // the block's first valid
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cloud = blockIdx.x / S;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  const float* p = xyz + static_cast<size_t>(cloud / groups) * n * 3;
  const unsigned char* m = MASK ? mask + static_cast<size_t>(cloud) * n : nullptr;
  int* o = out + static_cast<size_t>(cloud) * npoint;
  const int first = rank * T * PPT + tid;
  // picks wait in shared memory while they fit: a store to device memory
  // inside the loop would hold up every release of the cluster barrier
  const bool keep = kPickOffset + 4 * npoint <= kClusterSmem;

  float px[PPT], py[PPT], pz[PPT], md[PPT];
  unsigned valid = 0;  // bit k: slot k is in the mask (MASK only)
  int seed = INT_MAX;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int j = first + k * T;
    const int src = j < n ? j : 0;  // past the end: a copy of point 0
    px[k] = p[3 * src];
    py[k] = p[3 * src + 1];
    pz[k] = p[3 * src + 2];
    md[k] = kBig;
    if (MASK && m[src]) {
      valid |= 1u << k;
      if (j < n) seed = min(seed, j);
    }
  }
  // lane l < S reads block l's record
  const Record* remote = cluster.map_shared_rank(s_block, min(lane, S - 1));
  int start = 0;
  if (MASK) {
    // the first valid index of the cloud: a minimum over the block, then
    // over the cluster's blocks through distributed shared memory
    if (tid == 0) s_seed = INT_MAX;
    __syncthreads();
    seed = __reduce_min_sync(kFull, seed);
    if (lane == 0 && seed != INT_MAX) atomicMin(&s_seed, seed);
    cluster.sync();
    int best = INT_MAX;
    for (int r = 0; r < S; ++r) best = min(best, *cluster.map_shared_rank(&s_seed, r));
    start = best == INT_MAX ? 0 : best;
    // no block rewrites s_seed, and the records are written after this
  }
  float lx = p[3 * start], ly = p[3 * start + 1], lz = p[3 * start + 2];
  if (rank == 0 && tid == 0) {
    if (keep) s_pick[0] = start;
    else o[0] = start;
  }

  for (int it = 1; it < npoint; ++it) {
    // 1. minima and the thread's best: the first slot unconditionally, so
    //    every thread holds a candidate; strict > keeps the lowest index
    unsigned bd = 0, bni = 0;
    float bx = 0.f, by = 0.f, bz = 0.f;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const float dx = __fsub_rn(px[k], lx);
      const float dy = __fsub_rn(py[k], ly);
      const float dz = __fsub_rn(pz[k], lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      md[k] = fminf(md[k], d);
      // masked: 0 outside the mask, the minimum's bits + 1 inside (minima
      // are finite, so the + 1 keeps their order)
      const unsigned db = MASK ? ((valid >> k) & 1u ? __float_as_uint(md[k]) + 1u : 0u)
                               : __float_as_uint(md[k]);
      if (k == 0 || db > bd) {
        bd = db;
        bni = ~static_cast<unsigned>(first + k * T);
        bx = px[k];
        by = py[k];
        bz = pz[k];
      }
    }
    // 2. the warp's winner, published by the lane that holds it
    unsigned wd = __reduce_max_sync(kFull, bd);
    unsigned wni = __reduce_max_sync(kFull, bd == wd ? bni : 0u);
    if (bd == wd && bni == wni) put(s_warp + warp, wd, wni, bx, by, bz);
    __syncthreads();
    // 3. warp 0 reduces the warps' records to the block's, into the half of
    //    the double buffer this step's parity names
    const int parity = it & 1;
    if (warp == 0) {
      unsigned d = 0, ni = 0, x = 0, y = 0, z = 0;
      if (lane < nwarps) {
        const uint4 a = s_warp[lane].key_xy;
        d = a.x;
        ni = a.y;
        x = a.z;
        y = a.w;
        z = s_warp[lane].z.x;
      }
      float fx, fy, fz;
      warp_pick(d, ni, x, y, z, wd, wni, fx, fy, fz);
      if (lane == 0) put(s_block + parity, wd, wni, fx, fy, fz);
    }
    // 4. one barrier across the cluster, then warp 0 reads the S block
    //    records of this parity, one a lane, reduces them and hands the pick
    //    to the block through shared memory
    cluster.sync();
    if (warp == 0) {
      unsigned d = 0, ni = 0, x = 0, y = 0, z = 0;
      if (lane < S) {
        const uint4 a = remote[parity].key_xy;
        d = a.x;
        ni = a.y;
        x = a.z;
        y = a.w;
        z = remote[parity].z.x;
      }
      float fx, fy, fz;
      warp_pick(d, ni, x, y, z, wd, wni, fx, fy, fz);
      if (lane == 0) put(s_pick_rec + parity, wd, wni, fx, fy, fz);
    }
    __syncthreads();
    const uint4 pick = s_pick_rec[parity].key_xy;
    wni = pick.y;
    lx = __uint_as_float(pick.z);
    ly = __uint_as_float(pick.w);
    lz = __uint_as_float(s_pick_rec[parity].z.x);
    if (rank == 0 && tid == 0) {
      if (keep) s_pick[it] = static_cast<int>(~wni);
      else o[it] = static_cast<int>(~wni);
    }
  }
  cluster.sync();  // no block leaves while another may still read its records
  if (rank == 0 && keep) {
    for (int i = tid; i < npoint; i += T) o[i] = s_pick[i];
  }
}

template <int PPT, bool MASK>
cudaError_t cluster_config(int S, int threads, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  static OncePerDevice once;
  bool* done = once.slot();
  if (done == nullptr || !*done) {
    const void* fn = reinterpret_cast<const void*>(fps_cluster_kernel<PPT, MASK>);
    cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kClusterSmem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    if (done != nullptr) *done = true;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(S);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->blockDim = dim3(static_cast<unsigned>(threads));
  cfg->dynamicSmemBytes = kClusterSmem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int PPT>
int cluster_occupancy(int S, int threads) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<PPT, false>(S, threads, &cfg, &attr);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cfg.gridDim = dim3(static_cast<unsigned>(S));
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fps_cluster_kernel<PPT, false>, &cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

template <int PPT, bool MASK>
int launch_cluster(const float* xyz, const unsigned char* mask, int* out, int B, int N,
                   int npoint, int groups, int S, int threads, cudaStream_t stream) {
  if (S < 1 || S > kMaxCluster || threads < 32 || threads > kClusterThreads ||
      (threads & (threads - 1)) != 0 || static_cast<long long>(S) * threads * PPT < N)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<PPT, MASK>(S, threads, &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.gridDim = dim3(static_cast<unsigned>(B) * static_cast<unsigned>(S));
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel<PPT, MASK>, xyz, mask, out, N, npoint,
                           groups);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The layouts the library holds; `ops/fps.py:fps_plan` picks among them.
// Block path: points per thread 1 to 16 at up to 1024 threads.
// Cluster path: points per thread 1 to 16 at up to 256 threads, S <= 16.

// Clusters of S blocks of `threads` threads and `ppt` points a thread that
// can be resident at once (cudaOccupancyMaxActiveClusters), or minus a CUDA
// error.
extern "C" int fps_max_active_clusters(int S, int threads, int ppt) {
  if (S < 1 || S > kMaxCluster || threads < 32 || threads > kClusterThreads)
    return -static_cast<int>(cudaErrorInvalidValue);
  switch (ppt) {
    case 1: return cluster_occupancy<1>(S, threads);
    case 2: return cluster_occupancy<2>(S, threads);
    case 4: return cluster_occupancy<4>(S, threads);
    case 8: return cluster_occupancy<8>(S, threads);
    case 16: return cluster_occupancy<16>(S, threads);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

namespace {

// xyz: (B / groups, N, 3) float32 contiguous on the device; mask: null, or
// (B, N) bytes, nonzero where a point is valid; out: (B, npoint) int32.
// Cloud c reads xyz cloud c / groups and mask row c.
// cluster 0: the block path (`threads` threads, `ppt` points each; S unused);
// cluster 1: a cluster of S blocks per cloud. Returns 0 or the CUDA error of
// the launch, cudaErrorInvalidValue for a layout the library does not hold;
// does not synchronize.
template <bool MASK>
int launch(const float* xyz, const unsigned char* mask, int* out, int B, int N, int npoint,
           int groups, int cluster, int S, int threads, int ppt, cudaStream_t stream) {
  if (cluster) {
    switch (ppt) {
      case 1: return launch_cluster<1, MASK>(xyz, mask, out, B, N, npoint, groups, S, threads, stream);
      case 2: return launch_cluster<2, MASK>(xyz, mask, out, B, N, npoint, groups, S, threads, stream);
      case 4: return launch_cluster<4, MASK>(xyz, mask, out, B, N, npoint, groups, S, threads, stream);
      case 8: return launch_cluster<8, MASK>(xyz, mask, out, B, N, npoint, groups, S, threads, stream);
      case 16: return launch_cluster<16, MASK>(xyz, mask, out, B, N, npoint, groups, S, threads, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (ppt) {
    case 1: return launch_block<1, 1024, MASK>(xyz, mask, out, B, N, npoint, groups, threads, stream);
    case 2: return launch_block<2, 1024, MASK>(xyz, mask, out, B, N, npoint, groups, threads, stream);
    case 4: return launch_block<4, 1024, MASK>(xyz, mask, out, B, N, npoint, groups, threads, stream);
    case 8: return launch_block<8, 1024, MASK>(xyz, mask, out, B, N, npoint, groups, threads, stream);
    case 16: return launch_block<16, 1024, MASK>(xyz, mask, out, B, N, npoint, groups, threads, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int fps_launch(const float* xyz, const unsigned char* mask, int* out, int B, int N,
                          int npoint, int groups, int cluster, int S, int threads, int ppt,
                          cudaStream_t stream) {
  if (B < 1 || N < 1 || npoint < 1 || groups < 1 || B % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mask != nullptr)
    return launch<true>(xyz, mask, out, B, N, npoint, groups, cluster, S, threads, ppt, stream);
  return launch<false>(xyz, mask, out, B, N, npoint, groups, cluster, S, threads, ppt, stream);
}
