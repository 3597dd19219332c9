// Grouping kernels of the fused set abstraction for Hopper (sm_90a):
// window_select, gather_rows, scatter_add_rows.
//
// They replace the TPU's grouping kernels
//   grid_query_group_pallas  (pdm_ssd_tpu/ops/pallas/retired/grid_query.py)
//   gather_rows, both layouts (pdm_ssd_tpu/ops/pallas/retired/onehot_gather.py)
//   scatter_add_rows          (the same file; the gather's backward)
// and compute what those compute, not how: the TPU kernels select and gather
// with one-hot matrix products, split indices into bf16 halves and rank hits
// with triangular products because that machine gathers slowly and has no
// prefix sum. Here a warp ranks hits with a ballot and a population count,
// and rows are read and added by address.
//
// window_select: the plain version is `window_select_plain` in
// pdm_ssd_torch/ops/group.py. One warp per ball center walks the center's
// 3x3 cell window of the slot table in candidate order (dy outer, dx inner,
// slots inner), 32 candidates at a time. For each radius the lanes vote with
// `d2 < r*r`; a lane's rank among the hits is the count so far plus the hits
// in the lanes below it, and a hit of rank < K writes its point index and its
// relative xyz to slot `rank`. Slots past the hit count repeat the first hit;
// an empty ball gives index 0, zero rows and hit = 0. The walk ends early once
// every radius has its K hits. d2 is (rx*rx + ry*ry) + rz*rz from
// round-to-nearest intrinsics, so no FMA contraction moves a point across a
// radius against the plain version. The center's cell comes from the caller,
// who computes it with the same PyTorch code that bucketed the points.
// What bounds it: bytes. A center reads 9 table rows (9 * cap * 4 B) and up
// to 9 * cap points of 12 B at scattered addresses, and writes K * 16 B per
// radius; table rows are read 128 B per warp, the points are the scattered part.
//
// gather_rows: out[b, r, :] = feat[b, idx[b, r], :], a zero row for an index
// outside [0, N). The feature rows may be a channel slice of a wider payload:
// `ld` is the distance between rows in floats and `feat` already points at
// the slice's first channel, so no branch copies its slice first. One thread
// moves 16 B where the slice, the row stride and the output are 16-byte
// aligned, else 4 B. Bound by bytes: every output byte is written once and
// read once from a row that mostly sits in L2.
//
// scatter_add_rows: out[b, idx[b, r], :] += vals[b, r, :] with float32
// atomicAdd into a buffer the caller has zeroed; an index outside
// [0, n_rows) is dropped. The order of the additions, and with it the last
// bits of the sums, changes from run to run. Bound by bytes read (vals once)
// plus the atomics' traffic in L2.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxBranches = 4;
constexpr int kSelectThreads = 128;
constexpr int kRowThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct SelectParams {
  float r2[kMaxBranches];
  int k[kMaxBranches];
  int* idx[kMaxBranches];
  float* rel[kMaxBranches];
  unsigned char* hit[kMaxBranches];
  int nb;
};

__global__ void __launch_bounds__(kSelectThreads)
    window_select_kernel(const int* __restrict__ table, const int* __restrict__ cells,
                         const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                         long long n_centers, int N, int M, int n_cells, int grid_w, int cap,
                         SelectParams p) {
  const long long center =
      static_cast<long long>(blockIdx.x) * (kSelectThreads / 32) + (threadIdx.x >> 5);
  if (center >= n_centers) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const long long b = center / M;
  const float cx = new_xyz[3 * center];
  const float cy = new_xyz[3 * center + 1];
  const float cz = new_xyz[3 * center + 2];
  const int cc = cells[center];
  const int* tab = table + b * (static_cast<long long>(n_cells) + 1) * cap;
  const float* pts = xyz + b * N * 3;

  int count[kMaxBranches];
  int first_idx[kMaxBranches];
  float first_x[kMaxBranches], first_y[kMaxBranches], first_z[kMaxBranches];
#pragma unroll
  for (int br = 0; br < kMaxBranches; ++br) {
    count[br] = 0;
    first_idx[br] = 0;
    first_x[br] = first_y[br] = first_z[br] = 0.f;
  }

  // a center in the dump cell (out of range) reads nothing
  if (cc >= 0 && cc < n_cells) {
    const int n_cand = 9 * cap;
    for (int base = 0; base < n_cand; base += 32) {
      bool done = true;
#pragma unroll
      for (int br = 0; br < kMaxBranches; ++br) {
        if (br < p.nb) done = done && count[br] >= p.k[br];
      }
      if (done) break;
      const int j = base + lane;
      int cand = -1;
      if (j < n_cand) {
        const int w = j / cap;
        const int slot = j - w * cap;
        int row = cc + (w / 3 - 1) * grid_w + (w % 3 - 1);
        row = min(max(row, 0), n_cells);
        cand = tab[static_cast<long long>(row) * cap + slot];
      }
      float rx = 0.f, ry = 0.f, rz = 0.f, d2 = 0.f;
      if (cand >= 0) {
        rx = __fsub_rn(pts[3 * cand], cx);
        ry = __fsub_rn(pts[3 * cand + 1], cy);
        rz = __fsub_rn(pts[3 * cand + 2], cz);
        d2 = __fadd_rn(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)), __fmul_rn(rz, rz));
      }
#pragma unroll
      for (int br = 0; br < kMaxBranches; ++br) {
        if (br < p.nb) {
          const bool within = cand >= 0 && d2 < p.r2[br];
          const unsigned mask = __ballot_sync(kFull, within);
          if (mask != 0u) {  // the same in every lane
            if (count[br] == 0) {
              const int src = __ffs(mask) - 1;
              first_idx[br] = __shfl_sync(kFull, cand, src);
              first_x[br] = __shfl_sync(kFull, rx, src);
              first_y[br] = __shfl_sync(kFull, ry, src);
              first_z[br] = __shfl_sync(kFull, rz, src);
            }
            const int rank = count[br] + __popc(mask & below);
            if (within && rank < p.k[br]) {
              const long long o = center * p.k[br] + rank;
              p.idx[br][o] = cand;
              p.rel[br][3 * o] = rx;
              p.rel[br][3 * o + 1] = ry;
              p.rel[br][3 * o + 2] = rz;
            }
            count[br] += __popc(mask);
          }
        }
      }
    }
  }

#pragma unroll
  for (int br = 0; br < kMaxBranches; ++br) {
    if (br < p.nb) {
      const int K = p.k[br];
      for (int k = min(count[br], K) + lane; k < K; k += 32) {
        const long long o = center * K + k;
        p.idx[br][o] = first_idx[br];
        p.rel[br][3 * o] = first_x[br];
        p.rel[br][3 * o + 1] = first_y[br];
        p.rel[br][3 * o + 2] = first_z[br];
      }
      if (lane == 0) p.hit[br][center] = count[br] > 0 ? 1 : 0;
    }
  }
}

template <typename V>
__device__ __forceinline__ V zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ float4 zero_value<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// cv: channels per row in units of V; ld: floats between feature rows.
template <typename V>
__global__ void __launch_bounds__(kRowThreads)
    gather_rows_kernel(const float* __restrict__ feat, const int* __restrict__ idx,
                       float* __restrict__ out, long long total, int N, int R, int cv,
                       long long ld) {
  const long long t = static_cast<long long>(blockIdx.x) * kRowThreads + threadIdx.x;
  if (t >= total) return;
  const long long row = t / cv;
  const int v = static_cast<int>(t - row * cv);
  const long long b = row / R;
  const int i = idx[row];
  V val = zero_value<V>();
  if (i >= 0 && i < N) val = reinterpret_cast<const V*>(feat + (b * N + i) * ld)[v];
  reinterpret_cast<V*>(out)[t] = val;
}

__global__ void __launch_bounds__(kRowThreads)
    scatter_add_rows_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
                            float* __restrict__ out, long long total, int R, int C, int n_rows) {
  const long long t = static_cast<long long>(blockIdx.x) * kRowThreads + threadIdx.x;
  if (t >= total) return;
  const long long row = t / C;
  const int c = static_cast<int>(t - row * C);
  const long long b = row / R;
  const int i = idx[row];
  if (i >= 0 && i < n_rows) atomicAdd(out + (b * n_rows + i) * C + c, vals[t]);
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

int blocks_for(long long total, int threads, unsigned* out) {
  const long long blocks = (total + threads - 1) / threads;
  if (blocks < 1 || blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  *out = static_cast<unsigned>(blocks);
  return 0;
}

}  // namespace

// Most radii one launch takes.
extern "C" int window_select_max_branches() { return kMaxBranches; }

// table: (B, n_cells + 1, cap) int32 point index per slot, -1 where empty;
// cells: (B, M) int32 cell of each center (n_cells for the dump cell);
// xyz: (B, N, 3), new_xyz: (B, M, 3) float32. r2, k, idx, rel, hit are host
// arrays of length nb: squared radius, K, and the device outputs
// idx (B, M, K) int32, rel (B, M, K, 3) float32, hit (B, M) uint8 of each radius.
// Returns 0 or the CUDA error of the launch; does not synchronize.
extern "C" int window_select_launch(const int* table, const int* cells, const float* xyz,
                                    const float* new_xyz, int B, int N, int M, int n_cells,
                                    int grid_w, int cap, int nb, const float* r2, const int* k,
                                    void* const* idx, void* const* rel, void* const* hit,
                                    cudaStream_t stream) {
  if (B < 1 || N < 1 || M < 1 || n_cells < 1 || grid_w < 1 || cap < 1 || nb < 1 ||
      nb > kMaxBranches)
    return static_cast<int>(cudaErrorInvalidValue);
  SelectParams p;
  p.nb = nb;
  for (int br = 0; br < kMaxBranches; ++br) {
    const bool on = br < nb;
    if (on && k[br] < 1) return static_cast<int>(cudaErrorInvalidValue);
    p.r2[br] = on ? r2[br] : 0.f;
    p.k[br] = on ? k[br] : 0;
    p.idx[br] = on ? static_cast<int*>(idx[br]) : nullptr;
    p.rel[br] = on ? static_cast<float*>(rel[br]) : nullptr;
    p.hit[br] = on ? static_cast<unsigned char*>(hit[br]) : nullptr;
  }
  const long long n_centers = static_cast<long long>(B) * M;
  unsigned blocks = 0;
  const int bad = blocks_for(n_centers, kSelectThreads / 32, &blocks);
  if (bad != 0) return bad;
  window_select_kernel<<<blocks, kSelectThreads, 0, stream>>>(table, cells, xyz, new_xyz,
                                                              n_centers, N, M, n_cells, grid_w,
                                                              cap, p);
  return static_cast<int>(cudaGetLastError());
}

// feat: first channel of the (B, N, C) rows to read, `ld` floats from one row
// to the next and N * ld from one cloud to the next; idx: (B, R) int32;
// out: (B, R, C) float32 contiguous.
extern "C" int gather_rows_launch(const float* feat, const int* idx, float* out, int B, int N,
                                  int R, int C, long long ld, cudaStream_t stream) {
  if (B < 1 || N < 1 || R < 1 || C < 1 || ld < C) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = C % 4 == 0 && ld % 4 == 0 && aligned16(feat) && aligned16(out);
  const int cv = vec ? C / 4 : C;
  const long long total = static_cast<long long>(B) * R * cv;
  unsigned blocks = 0;
  const int bad = blocks_for(total, kRowThreads, &blocks);
  if (bad != 0) return bad;
  if (vec) {
    gather_rows_kernel<float4><<<blocks, kRowThreads, 0, stream>>>(feat, idx, out, total, N, R,
                                                                   cv, ld);
  } else {
    gather_rows_kernel<float><<<blocks, kRowThreads, 0, stream>>>(feat, idx, out, total, N, R,
                                                                  cv, ld);
  }
  return static_cast<int>(cudaGetLastError());
}

// vals: (B, R, C) float32 contiguous; idx: (B, R) int32; out: (B, n_rows, C)
// float32 contiguous, zeroed by the caller.
extern "C" int scatter_add_rows_launch(const float* vals, const int* idx, float* out, int B,
                                       int R, int C, int n_rows, cudaStream_t stream) {
  if (B < 1 || R < 1 || C < 1 || n_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(B) * R * C;
  unsigned blocks = 0;
  const int bad = blocks_for(total, kRowThreads, &blocks);
  if (bad != 0) return bad;
  scatter_add_rows_kernel<<<blocks, kRowThreads, 0, stream>>>(vals, idx, out, total, R, C,
                                                              n_rows);
  return static_cast<int>(cudaGetLastError());
}
