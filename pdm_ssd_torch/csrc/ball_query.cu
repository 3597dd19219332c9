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
// triangular product. Two kernels compute the function; `ball_query_plan` in
// ops/ball_query.py picks one by shape.
//
// The grid path (`ball_query_grid_kernel`) tests only the points near a
// center. As on the TPU, the grid is built outside the kernel
// (`build_grid` in ops/ball_query.py, torch ops on the device): each point
// gets the key of its 3D cell, whose edge is a little over the level's
// largest radius, and the keys are sorted stably, so each cell's points form
// one run in point order; a masked point gets a key past every cell. One
// warp per center: lane l < 27 computes window cell l of the 3x3x3 cells
// around the center's (the same float64 product and floor as the build) and
// finds its run by two binary searches in the sorted keys; the warp merges
// the 27 index-sorted runs, taking the least head index across the lanes
// (`redux.sync`) as the next candidate, so candidates come in point order.
// Every point of a ball lies in the window (the cell edge exceeds the radius
// by more than the rounding of the float32 test and of the cell product),
// so the hits come in the plain version's order. The walk tests every radius
// of the level and stops once every radius has K hits. A window that holds
// more than N / 16 points (a dense region, where the merge's one candidate a
// step would be slow) walks the cloud in point order 32 points a step
// instead, as the walk path does. What bounds it: latency, not bytes or
// operations. A center's searches are two chains of log2(N) dependent loads
// and its merge one candidate per step; the card holds enough warps to
// overlap them.
//
// The walk path (`ball_query_kernel`) serves small clouds, where a grid
// costs more than it saves: the warps of a block serve centers of one cloud
// and walk that cloud in point order, a tile of kTile points at a time
// through shared memory. Each lane tests one point against every radius of
// the level; for each radius the lanes vote, a lane's rank among the hits is
// the count so far plus the hits in the lanes below it, and a hit of rank <
// K writes its index to slot `rank`. A warp stops testing once every radius
// has its K hits, and the block stops walking once every warp has. What
// bounds it: operations, B * M * N distance tests where no ball fills.
//
// On both paths one launch serves all radii of a set-abstraction level, and
// d2 is (dx*dx + dy*dy) + dz*dz from round-to-nearest intrinsics, so no FMA
// contraction moves a point across a radius against the plain version.
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

constexpr unsigned kNone = 0xffffffffu;  // past every point index
constexpr int kCellBits = 21;            // bits of each cell coordinate in a key
constexpr int kCellMax = (1 << kCellBits) - 2;  // so that every key + 1 stays below a
constexpr int kCellOffset = 1 << (kCellBits - 1);  // masked point's key, 2^63 - 1

// Counts of the sorted keys a[0..n) below k1 and below k2, two searches
// interleaved so that their loads overlap.
__device__ __forceinline__ void lower_bounds(const long long* __restrict__ a, int n, long long k1,
                                             long long k2, int& r1, int& r2) {
  int lo1 = 0, lo2 = 0;
  for (int step = 1 << (31 - __clz(n)); step > 0; step >>= 1) {
    if (lo1 + step <= n && a[lo1 + step - 1] < k1) lo1 += step;
    if (lo2 + step <= n && a[lo2 + step - 1] < k2) lo2 += step;
  }
  r1 = lo1;
  r2 = lo2;
}

// The cell coordinate of x along one axis, offset into [0, kCellMax]:
// floor(x * inv_cell) in float64, clamped, as `cell_coords` in
// ops/ball_query.py computes it for the points.
__device__ __forceinline__ int cell_of(float x, double inv_cell) {
  double c = floor(__dmul_rn(static_cast<double>(x), inv_cell));
  c = fmin(fmax(c, -static_cast<double>(kCellOffset)), static_cast<double>(kCellMax - kCellOffset));
  return static_cast<int>(c) + kCellOffset;  // NaN: cell 0, where its tests all fail
}

// One radius's hits of a step, in point order across the lanes: `votes` the
// warp's ballot, `within` this lane's test and `index` its point, `count`
// the hits so far, `first_in_step` the step's first hit. A hit of rank < K
// writes its index to slot `rank`.
__device__ __forceinline__ void take_hits(unsigned votes, bool within, int index, int lane,
                                          long long center, int br, const QueryParams& p,
                                          int& count, int& first_idx, int first_in_step) {
  if (votes == 0u) return;
  if (count == 0) first_idx = first_in_step;
  const int rank = count + __popc(votes & ((1u << lane) - 1u));
  if (within && rank < p.k[br]) p.idx[br][center * p.k[br] + rank] = index;
  count += __popc(votes);
}

__global__ void __launch_bounds__(kThreads)
    ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                      const unsigned char* __restrict__ mask, int N, int M, int blocks_per_cloud,
                      QueryParams p) {
  __shared__ float s_xyz[3 * kTile];
  __shared__ unsigned char s_ok[kTile];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
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
            take_hits(votes, within, base + t, lane, center, br, p, count[br], first_idx[br],
                      base + r + __ffs(votes) - 1);
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

__global__ void __launch_bounds__(kThreads)
    ball_query_grid_kernel(const long long* __restrict__ keys, const float4* __restrict__ pts,
                           const float* __restrict__ xyz, const unsigned char* __restrict__ mask,
                           const float* __restrict__ new_xyz, int B, int N, int M,
                           double inv_cell, QueryParams p) {
  const int lane = threadIdx.x & 31;
  const long long center = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (center >= static_cast<long long>(B) * M) return;  // the whole warp
  const long long b = center / M;
  const float cx = new_xyz[3 * center];
  const float cy = new_xyz[3 * center + 1];
  const float cz = new_xyz[3 * center + 2];

  // lane l < 27: the run of window cell (l / 9, l / 3 % 3, l % 3) - 1
  int pos = 0, end = 0;
  if (lane < 27) {
    const int x = cell_of(cx, inv_cell) + lane / 9 - 1;
    const int y = cell_of(cy, inv_cell) + lane / 3 % 3 - 1;
    const int z = cell_of(cz, inv_cell) + lane % 3 - 1;
    if (x >= 0 && x <= kCellMax && y >= 0 && y <= kCellMax && z >= 0 && z <= kCellMax) {
      const long long key = (static_cast<long long>(x) << (2 * kCellBits)) |
                            (static_cast<long long>(y) << kCellBits) | z;
      lower_bounds(keys + b * N, N, key, key + 1, pos, end);
    }
  }
  int count[kMaxBranches];
  int first_idx[kMaxBranches];
#pragma unroll
  for (int br = 0; br < kMaxBranches; ++br) {
    count[br] = 0;
    first_idx[br] = 0;
  }

  // A window that holds more than a sixteenth of the cloud (a dense ball
  // region) is cheaper to walk 32 points a step over the cloud in point
  // order, as the walk path does, than one candidate a step: both give the
  // same first K.
  const int window = __reduce_add_sync(kFull, static_cast<unsigned>(end - pos));
  if (window > N / 16) {
    const float* cloud = xyz + b * N * 3;
    const unsigned char* ok = mask == nullptr ? nullptr : mask + b * N;
    for (int base = 0; base < N; base += 32) {
      const int t = base + lane;
      bool valid = false;
      float d2 = 0.f;
      if (t < N) {
        valid = ok == nullptr || ok[t] != 0;
        const float dx = __fsub_rn(cx, cloud[3 * t]);
        const float dy = __fsub_rn(cy, cloud[3 * t + 1]);
        const float dz = __fsub_rn(cz, cloud[3 * t + 2]);
        d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      }
      bool all_full = true;
#pragma unroll
      for (int br = 0; br < kMaxBranches; ++br) {
        if (br < p.nb) {
          const bool within = valid && d2 < p.r2[br];
          const unsigned votes = __ballot_sync(kFull, within);
          take_hits(votes, within, t, lane, center, br, p, count[br], first_idx[br],
                    base + __ffs(votes) - 1);
          all_full = all_full && count[br] >= p.k[br];
        }
      }
      if (all_full) break;
    }
  } else {
    const float4* run = pts + b * N;
    float4 head = make_float4(0.f, 0.f, 0.f, 0.f), next = head;
    if (pos < end) head = run[pos];
    if (pos + 1 < end) next = run[pos + 1];
    unsigned hv = pos < end ? __float_as_uint(head.w) : kNone;
    while (true) {
      const unsigned m = __reduce_min_sync(kFull, hv);
      if (m == kNone) break;
      // the lane whose head is the candidate tests it and moves on
      unsigned bits = 0u;
      if (hv == m) {
        const float dx = __fsub_rn(cx, head.x);
        const float dy = __fsub_rn(cy, head.y);
        const float dz = __fsub_rn(cz, head.z);
        const float d2 =
            __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
#pragma unroll
        for (int br = 0; br < kMaxBranches; ++br)
          if (br < p.nb && d2 < p.r2[br]) bits |= 1u << br;
        ++pos;
        head = next;
        hv = pos < end ? __float_as_uint(head.w) : kNone;
        if (pos + 1 < end) next = run[pos + 1];
      }
      bits = __reduce_or_sync(kFull, bits);
      bool all_full = true;
#pragma unroll
      for (int br = 0; br < kMaxBranches; ++br) {
        if (br < p.nb) {
          // one hit at most: lane 0 writes it
          take_hits((bits >> br) & 1u, lane == 0, static_cast<int>(m), lane, center, br, p,
                    count[br], first_idx[br], static_cast<int>(m));
          all_full = all_full && count[br] >= p.k[br];
        }
      }
      if (all_full) break;
    }
  }

#pragma unroll
  for (int br = 0; br < kMaxBranches; ++br) {
    if (br < p.nb) {
      const int K = p.k[br];
      for (int k = min(count[br], K) + lane; k < K; k += 32)
        p.idx[br][center * K + k] = first_idx[br];
    }
  }
}

int fill_params(int nb, const float* r2, const int* k, void* const* idx, QueryParams* p) {
  if (nb < 1 || nb > kMaxBranches) return static_cast<int>(cudaErrorInvalidValue);
  p->nb = nb;
  for (int br = 0; br < kMaxBranches; ++br) {
    const bool on = br < nb;
    if (on && k[br] < 1) return static_cast<int>(cudaErrorInvalidValue);
    p->r2[br] = on ? r2[br] : 0.f;
    p->k[br] = on ? k[br] : 0;
    p->idx[br] = on ? static_cast<int*>(idx[br]) : nullptr;
  }
  return 0;
}

}  // namespace

// The bits b of one cell coordinate in a grid key (the key is x << 2b |
// y << b | z), and the most radii one launch takes.
extern "C" int ball_query_cell_bits() { return kCellBits; }
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
  if (B < 1 || N < 1 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  QueryParams p;
  const int err = fill_params(nb, r2, k, idx, &p);
  if (err != 0) return err;
  const int blocks_per_cloud = (M + kWarps - 1) / kWarps;
  const long long blocks = static_cast<long long>(B) * blocks_per_cloud;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  ball_query_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      xyz, new_xyz, mask, N, M, blocks_per_cloud, p);
  return static_cast<int>(cudaGetLastError());
}

// The grid path. keys: (B, N) int64, each cloud's cell keys sorted, a masked
// point's past every cell; pts: (B, N, 4) float32, the points in key order,
// x, y, z and the point's index as int32 bits; xyz: (B, N, 3) float32 and
// mask (B, N) bytes or null, the cloud in point order (a window that holds
// more than N / 16 points walks it); new_xyz: (B, M, 3) float32; all
// contiguous on the device. inv_cell: 1 / the cells' edge, as the keys were
// made with it. r2, k and idx as for ball_query_launch. Returns 0 or the
// CUDA error of the launch; does not synchronize.
extern "C" int ball_query_grid_launch(const long long* keys, const float* pts, const float* xyz,
                                      const unsigned char* mask, const float* new_xyz, int B,
                                      int N, int M, double inv_cell, int nb, const float* r2,
                                      const int* k, void* const* idx, cudaStream_t stream) {
  if (B < 1 || N < 1 || M < 1 || !(inv_cell > 0.0)) return static_cast<int>(cudaErrorInvalidValue);
  QueryParams p;
  const int err = fill_params(nb, r2, k, idx, &p);
  if (err != 0) return err;
  const long long blocks = (static_cast<long long>(B) * M + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  ball_query_grid_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      keys, reinterpret_cast<const float4*>(pts), xyz, mask, new_xyz, B, N, M, inv_cell, p);
  return static_cast<int>(cudaGetLastError());
}
