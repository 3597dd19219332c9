// Exact first-K ball query for Hopper (sm_90a).
//
// Replaces the TPU's grid_ball_query_pallas
// (pdm_ssd_tpu/ops/pallas/retired/grid_query.py) and computes the contract of
// the plain version, `ball_query` in pdm_ssd_torch/ops/pointnet2.py, bit for
// bit: for each center the first K points in point order with d2 < r*r, slots
// past the hit count repeat the first hit, an empty ball is all zeros. The
// TPU kernel buckets points into 32-slot cells, reads a 3x3 window and picks
// any K hits by modular rank, because that machine gathers slowly and has no
// prefix sum; its own check (every index inside the ball, as many distinct
// indices as the exact query) is a relaxation that the exact result meets.
// None of that is carried over: no bucket table, no double-buffered copy, no
// triangular product.
//
// One warp per center; the warps of a block serve centers of one cloud and
// walk that cloud in point order, a tile of kTile points at a time through
// shared memory. Each lane tests one point against every radius of the level;
// for each radius the lanes vote, a lane's rank among the hits is the count so
// far plus the hits in the lanes below it, and a hit of rank < K writes its
// index to slot `rank`. A warp stops testing once every radius has its K hits,
// and the block stops walking once every warp has. One launch serves all radii
// of a set-abstraction level. d2 is (dx*dx + dy*dy) + dz*dz from
// round-to-nearest intrinsics, so no FMA contraction moves a point across a
// radius against the plain version.
//
// What bounds it: operations, not bytes. The cloud and the centers are read
// once per block from L2 and the indices written once, but a sparse cloud
// fills no ball, so every center tests every point: B * M * N distance tests
// of 8 operations and a compare and a vote per radius.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxBranches = 4;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kThreads;  // points per shared-memory tile
constexpr unsigned kFull = 0xffffffffu;

struct QueryParams {
  float r2[kMaxBranches];
  int k[kMaxBranches];
  int* idx[kMaxBranches];
  int nb;
};

__global__ void __launch_bounds__(kThreads)
    ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                      const unsigned char* __restrict__ mask, int N, int M, int blocks_per_cloud,
                      QueryParams p) {
  __shared__ float s_xyz[3 * kTile];
  __shared__ unsigned char s_ok[kTile];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const long long b = blockIdx.x / blocks_per_cloud;
  const int m = (blockIdx.x % blocks_per_cloud) * kWarps + warp;
  const bool active = m < M;  // the same in every lane of a warp
  const long long center = b * M + m;
  float cx = 0.f, cy = 0.f, cz = 0.f;
  if (active) {
    cx = new_xyz[3 * center];
    cy = new_xyz[3 * center + 1];
    cz = new_xyz[3 * center + 2];
  }
  const float* pts = xyz + b * N * 3;
  const unsigned char* ok = mask == nullptr ? nullptr : mask + b * N;

  int count[kMaxBranches];
  int first_idx[kMaxBranches];
#pragma unroll
  for (int br = 0; br < kMaxBranches; ++br) {
    count[br] = 0;
    first_idx[br] = 0;
  }

  // a warp without a center tests nothing but still loads tiles and meets
  // the block's barriers
  bool done = !active;
  for (int base = 0; base < N; base += kTile) {
    const int n_tile = min(kTile, N - base);
    for (int i = tid; i < 3 * n_tile; i += kThreads) s_xyz[i] = pts[3LL * base + i];
    if (tid < n_tile) s_ok[tid] = ok == nullptr ? 1 : ok[base + tid];
    __syncthreads();
    if (!done) {
      for (int r = 0; r < n_tile; r += 32) {
        const int t = r + lane;
        bool valid = false;
        float d2 = 0.f;
        if (t < n_tile) {
          valid = s_ok[t] != 0;
          const float dx = __fsub_rn(cx, s_xyz[3 * t]);
          const float dy = __fsub_rn(cy, s_xyz[3 * t + 1]);
          const float dz = __fsub_rn(cz, s_xyz[3 * t + 2]);
          d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        }
        bool all_full = true;
#pragma unroll
        for (int br = 0; br < kMaxBranches; ++br) {
          if (br < p.nb) {
            const bool within = valid && d2 < p.r2[br];
            const unsigned votes = __ballot_sync(kFull, within);
            if (votes != 0u) {  // the same in every lane
              if (count[br] == 0) first_idx[br] = base + r + __ffs(votes) - 1;
              const int rank = count[br] + __popc(votes & below);
              if (within && rank < p.k[br]) p.idx[br][center * p.k[br] + rank] = base + t;
              count[br] += __popc(votes);
            }
            all_full = all_full && count[br] >= p.k[br];
          }
        }
        if (all_full) {
          done = true;
          break;
        }
      }
    }
    // also keeps the next tile's loads behind this tile's reads
    if (__syncthreads_and(done)) break;
  }

  if (active) {
#pragma unroll
    for (int br = 0; br < kMaxBranches; ++br) {
      if (br < p.nb) {
        const int K = p.k[br];
        for (int k = min(count[br], K) + lane; k < K; k += 32)
          p.idx[br][center * K + k] = first_idx[br];
      }
    }
  }
}

}  // namespace

// Most radii one launch takes.
extern "C" int ball_query_max_branches() { return kMaxBranches; }

// xyz: (B, N, 3), new_xyz: (B, M, 3) float32 contiguous on the device;
// mask: (B, N) bytes, 0 for a point that is in no ball, or null. r2, k and idx
// are host arrays of length nb: squared radius, K, and the device output
// (B, M, K) int32 of each radius. Returns 0 or the CUDA error of the launch;
// does not synchronize.
extern "C" int ball_query_launch(const float* xyz, const float* new_xyz,
                                 const unsigned char* mask, int B, int N, int M, int nb,
                                 const float* r2, const int* k, void* const* idx,
                                 cudaStream_t stream) {
  if (B < 1 || N < 1 || M < 1 || nb < 1 || nb > kMaxBranches)
    return static_cast<int>(cudaErrorInvalidValue);
  QueryParams p;
  p.nb = nb;
  for (int br = 0; br < kMaxBranches; ++br) {
    const bool on = br < nb;
    if (on && k[br] < 1) return static_cast<int>(cudaErrorInvalidValue);
    p.r2[br] = on ? r2[br] : 0.f;
    p.k[br] = on ? k[br] : 0;
    p.idx[br] = on ? static_cast<int*>(idx[br]) : nullptr;
  }
  const int blocks_per_cloud = (M + kWarps - 1) / kWarps;
  const long long blocks = static_cast<long long>(B) * blocks_per_cloud;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  ball_query_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      xyz, new_xyz, mask, N, M, blocks_per_cloud, p);
  return static_cast<int>(cudaGetLastError());
}
