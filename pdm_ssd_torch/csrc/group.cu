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
// outside [0, N), for float32 or bfloat16 rows (the second entry point is
// the counterpart of the TPU's same-shape row gather,
// tools/microbench_pallas_gather.py `pallas_dynamic_gather`). The feature rows
// may be a channel slice of a wider payload: `ld` is the distance between rows
// in elements and `feat` already points at the slice's first channel, so no
// branch copies its slice first. Bound by bytes: every output byte is written
// once and read once from a row that mostly sits in L2; the index is read
// once per row. Two kernels, chosen by `ops/group.py:gather_plan`:
// `gather_rows_kernel` gives a row to a group of lanes (32 for rows of 512 B
// or more, fewer for narrower rows) that sweeps it in the widest unit that
// the slice start, the row stride, the row and the output all allow (16 B
// where the payload's channels line up); `gather_narrow_kernel` gives a
// thread several rows of 16 B or less, so that the output goes out in 16-byte
// stores (SA level 1 gathers one float a row). An output row r starts at
// r * C * size, so a slice whose start or stride is off 16 bytes cannot meet
// the output at one phase in every row: splitting head and tail around an
// aligned middle pays only where both line up, and then the plan already
// takes 16-byte units. Offsets are 32-bit where every byte the launch
// touches is within 2^31, chosen at launch; the grid strides over clouds
// (y) and rows (x), so no thread divides per element.
//
// scatter_add_rows: out[b, idx[b, r], :] += vals[b, r, :] with float32
// atomicAdd into a buffer the caller has zeroed; an index outside
// [0, n_rows) is dropped. The order of the additions, and with it the last
// bits of the sums, changes from run to run. Bound by bytes read (vals once)
// plus the atomics' traffic in L2.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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

template <bool WIDE>
using Offset = typename std::conditional<WIDE, long long, int>::type;

// Row path: a group of `lanes` lanes (a power of two) per row, U the unit
// every load and store moves (16, 8, 4 or 2 bytes: the common alignment of
// the slice start, the row stride, the row and the output), `units` of them
// per row, `ld` bytes from one feature row to the next. A warp takes a tile
// of `passes` * 32 / lanes rows (passes <= lanes, so a tile is at most 32
// rows): lane l loads the index of row l once, and in each pass a group takes
// its row's index from that lane with a shuffle. The plan shortens the tile
// where long tiles would leave too few warps to keep loads in flight. Clouds
// run along the grid's y axis, rows along x, both strided, so no thread
// divides.
template <typename U, bool WIDE>
__global__ void __launch_bounds__(kRowThreads)
    gather_rows_kernel(const char* __restrict__ feat, const int* __restrict__ idx,
                       U* __restrict__ out, int B, int N, int R, int units, long long ld,
                       int lanes, int passes) {
  using I = Offset<WIDE>;
  const int lane = threadIdx.x & 31;
  const int rows_per_pass = 32 / lanes;
  const int tile_rows = rows_per_pass * passes;
  const int group = lane / lanes;
  const int sub = lane & (lanes - 1);
  const int warps = gridDim.x * (kRowThreads / 32);
  const int first_tile = (blockIdx.x * (kRowThreads / 32) + (threadIdx.x >> 5)) * tile_rows;
  const U zero = {};
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const int* ib = idx + static_cast<I>(b) * R;
    const char* fb = feat + static_cast<I>(b) * N * static_cast<I>(ld);
    U* ob = out + static_cast<I>(b) * R * units;
    for (int tile = first_tile; tile < R; tile += warps * tile_rows) {
      const int mine = lane < tile_rows && tile + lane < R ? __ldg(ib + tile + lane) : -1;
#pragma unroll 4
      for (int pass = 0; pass < passes; ++pass) {
        const int slot = pass * rows_per_pass + group;
        const int i = __shfl_sync(kFull, mine, slot);
        const int r = tile + slot;
        if (r < R) {
          U* dst = ob + static_cast<I>(r) * units;
          if (i >= 0 && i < N) {
            const U* src = reinterpret_cast<const U*>(fb + static_cast<I>(i) * static_cast<I>(ld));
            for (int u = sub; u < units; u += lanes) dst[u] = __ldg(src + u);
          } else {
            for (int u = sub; u < units; u += lanes) dst[u] = zero;
          }
        }
      }
    }
  }
}

__host__ __device__ constexpr int gcd16(int a) { return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : a % 2 == 0 ? 2 : 1; }

// Narrow path, for rows of C elements of E that are at most 16 bytes: one
// thread takes kRows consecutive rows (of the flattened (B, R) grid), so
// that their output, kRows * C * sizeof(E) bytes, is a whole number of
// 16-byte stores. The reads are scattered by nature. One division a thread
// and pass finds the first row's cloud; the rest step through. `ld` in
// elements. Rows past the last whole chunk go one a thread.
template <typename E, int C, bool WIDE>
__global__ void __launch_bounds__(kRowThreads)
    gather_narrow_kernel(const E* __restrict__ feat, const int* __restrict__ idx,
                         E* __restrict__ out, int B, int N, int R, long long ld) {
  using I = Offset<WIDE>;
  constexpr int kRows = 16 / gcd16(C * static_cast<int>(sizeof(E)));
  constexpr int kVec = kRows * C * static_cast<int>(sizeof(E)) / 16;
  const I total = static_cast<I>(B) * R;
  const I chunks = total / kRows;
  const I stride = static_cast<I>(gridDim.x) * kRowThreads;
  const I start = static_cast<I>(blockIdx.x) * kRowThreads + threadIdx.x;
  for (I c = start; c < chunks; c += stride) {
    const I f0 = c * kRows;
    I b = f0 / R;
    int r = static_cast<int>(f0 - b * R);
    int ids[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) ids[j] = __ldg(idx + f0 + j);
    union {
      uint4 v[kVec];
      E e[kRows * C];
    } buf;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int i = ids[j];
      if (i >= 0 && i < N) {
        const E* src = feat + (b * N + i) * static_cast<I>(ld);
#pragma unroll
        for (int k = 0; k < C; ++k) buf.e[j * C + k] = __ldg(src + k);
      } else {
#pragma unroll
        for (int k = 0; k < C; ++k) buf.e[j * C + k] = E(0);
      }
      if (++r == R) {
        r = 0;
        ++b;
      }
    }
    uint4* dst = reinterpret_cast<uint4*>(out + f0 * C);
#pragma unroll
    for (int v = 0; v < kVec; ++v) dst[v] = buf.v[v];
  }
  for (I f = chunks * kRows + start; f < total; f += stride) {
    const I b = f / R;
    const int i = __ldg(idx + f);
    const bool ok = i >= 0 && i < N;
    const E* src = feat + (b * N + (ok ? i : 0)) * static_cast<I>(ld);
#pragma unroll
    for (int k = 0; k < C; ++k) out[f * C + k] = ok ? __ldg(src + k) : E(0);
  }
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

namespace {

template <bool WIDE>
int launch_rows(const void* feat, const int* idx, void* out, int B, int N, int R, int units,
                long long ld_bytes, int unit, int lanes, int passes, dim3 grid,
                cudaStream_t stream) {
  const char* f = static_cast<const char*>(feat);
  switch (unit) {
    case 16:
      gather_rows_kernel<uint4, WIDE><<<grid, kRowThreads, 0, stream>>>(
          f, idx, static_cast<uint4*>(out), B, N, R, units, ld_bytes, lanes, passes);
      break;
    case 8:
      gather_rows_kernel<uint2, WIDE><<<grid, kRowThreads, 0, stream>>>(
          f, idx, static_cast<uint2*>(out), B, N, R, units, ld_bytes, lanes, passes);
      break;
    case 4:
      gather_rows_kernel<unsigned, WIDE><<<grid, kRowThreads, 0, stream>>>(
          f, idx, static_cast<unsigned*>(out), B, N, R, units, ld_bytes, lanes, passes);
      break;
    case 2:
      gather_rows_kernel<unsigned short, WIDE><<<grid, kRowThreads, 0, stream>>>(
          f, idx, static_cast<unsigned short*>(out), B, N, R, units, ld_bytes, lanes, passes);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int C>
int launch_narrow_c(const void* feat, const int* idx, void* out, int B, int N, int R,
                    long long ld, bool wide, unsigned blocks, cudaStream_t stream) {
  const E* f = static_cast<const E*>(feat);
  E* o = static_cast<E*>(out);
  if (wide) {
    gather_narrow_kernel<E, C, true><<<blocks, kRowThreads, 0, stream>>>(f, idx, o, B, N, R, ld);
  } else {
    gather_narrow_kernel<E, C, false><<<blocks, kRowThreads, 0, stream>>>(f, idx, o, B, N, R, ld);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch_narrow(const void* feat, const int* idx, void* out, int B, int N, int R, int C,
                  long long ld, bool wide, unsigned blocks, cudaStream_t stream) {
  switch (C) {
    case 1: return launch_narrow_c<E, 1>(feat, idx, out, B, N, R, ld, wide, blocks, stream);
    case 2: return launch_narrow_c<E, 2>(feat, idx, out, B, N, R, ld, wide, blocks, stream);
    case 3: return launch_narrow_c<E, 3>(feat, idx, out, B, N, R, ld, wide, blocks, stream);
    case 4: return launch_narrow_c<E, 4>(feat, idx, out, B, N, R, ld, wide, blocks, stream);
  }
  if constexpr (sizeof(E) == 2) {
    switch (C) {
      case 5: return launch_narrow_c<E, 5>(feat, idx, out, B, N, R, ld, wide, blocks, stream);
      case 6: return launch_narrow_c<E, 6>(feat, idx, out, B, N, R, ld, wide, blocks, stream);
      case 7: return launch_narrow_c<E, 7>(feat, idx, out, B, N, R, ld, wide, blocks, stream);
      case 8: return launch_narrow_c<E, 8>(feat, idx, out, B, N, R, ld, wide, blocks, stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The plan comes from `ops/group.py:gather_plan`; this side refuses one the
// pointers or sizes do not allow. lanes 0: the narrow path; else the row path
// with `unit`-byte accesses and `passes` passes a tile. wide: 64-bit offsets.
template <typename E>
int launch_gather_rows(const void* feat, const int* idx, void* out, int B, int N, int R, int C,
                       long long ld, int lanes, int passes, int unit, int wide, int blocks,
                       cudaStream_t stream) {
  constexpr long long es = static_cast<long long>(sizeof(E));
  if (B < 1 || N < 1 || R < 1 || C < 1 || ld < C || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long most = static_cast<long long>(B) * (static_cast<long long>(N) * ld +
                                                       static_cast<long long>(R) * C) * es;
  if (!wide && most >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0) {
    if (C * es > 16 || !aligned16(out)) return static_cast<int>(cudaErrorInvalidValue);
    return launch_narrow<E>(feat, idx, out, B, N, R, C, ld, wide != 0,
                            static_cast<unsigned>(blocks), stream);
  }
  const long long row = C * es;
  const std::uintptr_t at = reinterpret_cast<std::uintptr_t>(feat) |
                            reinterpret_cast<std::uintptr_t>(out);
  if (lanes > 32 || (lanes & (lanes - 1)) != 0 || passes < 1 || passes > lanes || unit < es ||
      unit > 16 || row % unit != 0 || (ld * es) % unit != 0 || at % unit != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(B < 65535 ? B : 65535));
  const int units = static_cast<int>(row / unit);
  return wide ? launch_rows<true>(feat, idx, out, B, N, R, units, ld * es, unit, lanes, passes,
                                  grid, stream)
              : launch_rows<false>(feat, idx, out, B, N, R, units, ld * es, unit, lanes, passes,
                                   grid, stream);
}

}  // namespace

// feat: first channel of the (B, N, C) rows to read, `ld` elements from one
// row to the next and N * ld from one cloud to the next; idx: (B, R) int32;
// out: (B, R, C) contiguous. float32 rows. lanes, passes, unit, wide, blocks: the
// launch plan (`ops/group.py:gather_plan`).
extern "C" int gather_rows_launch(const float* feat, const int* idx, float* out, int B, int N,
                                  int R, int C, long long ld, int lanes, int passes, int unit,
                                  int wide, int blocks, cudaStream_t stream) {
  return launch_gather_rows<float>(feat, idx, out, B, N, R, C, ld, lanes, passes, unit, wide,
                                   blocks, stream);
}

// The same for bfloat16 rows: the kernel moves their 16 bits unread.
extern "C" int gather_rows_bf16_launch(const void* feat, const int* idx, void* out, int B, int N,
                                       int R, int C, long long ld, int lanes, int passes,
                                       int unit, int wide, int blocks, cudaStream_t stream) {
  return launch_gather_rows<unsigned short>(feat, idx, out, B, N, R, C, ld, lanes, passes, unit,
                                            wide, blocks, stream);
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
