// Weight gradient of the gather-matmul sparse convolution for Hopper
// (sm_90a): sparse_conv_wgrad.
//
//   dW[k] = sum_{b, v} feats[b, nbr[b, v, k], :]^T dy[b, v, :]      (Cin x Cout)
//
// with nbr[b, v, k] outside [0, Vin) meaning "absent tap, adds nothing". It is
// the counterpart of the `dWt = feats^T . gather(dy, bplan)` dot_general of
// `_scm_bwd` (pdm_ssd_tpu/models/backbones_3d/sparse_backbone.py), which XLA
// computes on the TPU; the forward is `sparse_conv_kernel` in sparse_conv.cu.
// The plain version is `sparse_conv_wgrad_plain` in ops/sparse_conv.py.
//
// What bounds it: bytes. Each output row's dy (Cout floats) and map row (K
// ints) are read once and each present tap gathers one row of feats (Cin
// floats), 2 * Cin * Cout operations per present tap: SECOND's 12 layers of
// a training batch read about 1 GB of tables and maps for 8.6 GFLOP. Most of
// a ladder table's slots past the first stage are padding, and most present
// taps lie in one plane of the 3 x 3 x 3 kernel (LiDAR's ground), so what a
// design must avoid is walking empty rows and giving all the work to the
// blocks of a few taps. So:
//
// - A first launch gives each tile of 64 consecutive output rows the OR of
//   its rows' tap masks, reading the map once. The taps are cut into rows
//   of 3 by a table the caller passes (`wgrad_row_taps` of
//   ops/sparse_conv.py: at K=27 each row holds one tap of every plane dz,
//   dy or dx = const, so a thin layer of sites loads every row alike); a
//   block owns a row of taps and the tiles chunk, chunk + chunks, ... of
//   the batch, and first lists, in order, those of its tiles whose mask has
//   one of its taps. The rows x chunks blocks fill one wave.
// - Per listed tile it copies its taps' columns of the map, compacts each
//   tap's rows that have it (a ballot per 32 rows, in row order), then
//   copies the tile's dy rows, once for all its taps, and gathers each
//   tap's feats rows, 16 bytes a copy where the widths allow.
//   All copies are cp.async into a ring of three tiles, a tile's map two
//   tiles ahead of its rows, so each wait is for copies started two tiles
//   earlier. A row without the tap costs nothing.
// - The threads form G row groups, each holding the block's taps' Cin x
//   Cout accumulators, TM x TN a tap a thread, and taking every G-th of a
//   tap's compacted rows, 4 values of each side a float4. Where a thread
//   holds 4 x 4 of a tap (Cin and Cout up to 32) the 3 taps are summed at
//   once, so a tile's dy rows and map are staged once for them; wider layers
//   take one tap a pass, in three passes, so that two blocks fit an SM and
//   one block's copies run under the other's products (3 taps at once, 192
//   accumulators a thread and one block an SM, measured slower on the card).
//   At the end the row groups are added in a fixed tree order through shared
//   memory, and the block writes one partial per tap and chunk.
// - A last launch sums each output's partials over the chunks in chunk
//   order. No float atomics anywhere: the order of every sum is a function
//   of the shapes and the map alone, so two runs give the same bits.
//
// Widths are padded to 4, 8, 16, 32, 64 or 128 input and 8, 16, 28, 32, 64
// or 128 output channels (28 for the focal importance convs' 27). Where Cin
// and Cout are multiples of 4 and the pointers 16-byte aligned the copies
// move 16 bytes, else 4.
//
// What bounds it now is neither the bytes nor the multiply-adds but the
// work of a tile: its compaction, starting its copies and two barriers
// cost about as much as its products at the ladder's few present taps a
// row. The first launch adds about 12 us a layer (the tiles' masks could
// come with the forward's plan, but then every predict would build them).
// Later work: a producer warp that compacts and copies while the other
// warps multiply (mbarriers), tiles of 128 rows at the narrow widths, the
// chunk sum and the tiles' masks folded into this kernel, and tensor cores
// for the wide layers (split TF32 to keep float32's accuracy).
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

using pdm_ssd::copy_async;
using pdm_ssd::copy_commit;
using pdm_ssd::copy_wait;
using pdm_ssd::OncePerDevice;

constexpr int kRows = 64;                      // output rows of a tile
constexpr int kMaxTaps = 27;
constexpr int kMaxC = 128;                     // most Cin and Cout
constexpr int kMostThreads = 256;
constexpr int kRowTaps = 3;                    // taps of a row of blocks
constexpr int kStages = 3;                     // items whose rows are in shared memory
constexpr int kAhead = kStages - 1;            // a map's copy leads its rows' by this many
constexpr int kMapSlots = kStages + kAhead;    // items whose map columns are held
constexpr int kMaxList = 1024;                 // most tiles a block walks
constexpr int kSmemMost = 232448;              // shared memory a block may have (227 KB)
constexpr int kSmemSM = 233472;                // an SM's, 1 KB of each block's reserved

// The taps of each row of blocks: k[3 * y + i], tap i of row y, or -1.
struct RowTaps {
  int k[kMaxTaps];
};

constexpr int cin_width(int c) {
  return c <= 4 ? 4 : c <= 8 ? 8 : c <= 16 ? 16 : c <= 32 ? 32 : c <= 64 ? 64 : 128;
}
constexpr int cout_width(int c) {
  return c <= 8 ? 8 : c <= 16 ? 16 : c <= 28 ? 28 : c <= 32 ? 32 : c <= 64 ? 64 : 128;
}

// row groups of a block whose P threads cover one tap: as many as fit in
// kMostThreads with the block a whole number of warps
constexpr int row_groups(int P) {
  int g = kMostThreads / P;
  while (g > 1 && (P * g) % 32 != 0) --g;
  return g;
}

// BM x BN: a tap's padded Cin x Cout; TM x TN the accumulators of a thread
// per tap, in float4 groups BM / (TM / 4) and BN / (TN / 4) apart; TG the
// taps a block sums at once: its row's 3 where a thread holds 4 x 4 of a
// tap, else 1, in 3 passes (two blocks an SM then overlap one's copies with
// the other's products, which measured faster than 3 taps in one block).
template <int BM, int BN>
struct WLayout {
  static constexpr int TM = BM >= 64 ? 8 : 4;
  static constexpr int TN = BN >= 64 ? 8 : 4;
  static constexpr int kMQuads = TM / 4, kNQuads = TN / 4;
  static constexpr int kMStride = BM / kMQuads, kNStride = BN / kNQuads;
  static constexpr int kCols = BN / TN;               // threads across a tap's columns
  static constexpr int P = (BM / TM) * kCols;         // threads of a row group
  static constexpr int G = row_groups(P);
  static constexpr int kThreads = P * G;
  static constexpr int TG = TM * TN == 16 ? kRowTaps : 1;
  static constexpr int kPasses = kRowTaps / TG;
  static constexpr int kAccT = TG * TM * TN;          // accumulators of a thread
  static constexpr int kA = TG * kRows * BM;          // floats of a tile's gathered rows
  static constexpr int kD = kRows * BN;               // floats of its dy rows
  static constexpr int kI = TG * kRows;               // ints of its map columns, of its row lists
  static constexpr int kList = 2 * kI + TG;           // a tile's row lists and their counts
  static constexpr int kFold = (G / 2) * P * kAccT;   // the row groups' tree sum
  static constexpr int kData = kStages * (kA + kD);
  static constexpr int kFloats = kData > kFold ? kData : kFold;
  static constexpr int kSmem = static_cast<int>(sizeof(float)) * kFloats +
                               static_cast<int>(sizeof(int)) *
                                   (kMapSlots * kI + kStages * kList + kMaxList + 64);
  static constexpr int kPerSM = kSmemSM / (kSmem + 1024 + 16) >= 2 ? 2 : 1;   // blocks an SM
  static_assert(BM % TM == 0 && BN % TN == 0 && kThreads % 32 == 0 && kThreads <= kMostThreads,
                "layout");
  static_assert(kSmem + 16 <= kSmemMost, "shared memory");
};

// cp.async of n rows of `width` floats, VEC at a time (Q copies a row of the
// padded width): row r from src(r) to dst + r * stride.
template <int VEC, int Q, int kThreads, typename Src>
__device__ __forceinline__ void copy_row_block(float* dst, int stride, int n, int width, Src src) {
  for (int e = threadIdx.x; e < n * Q; e += kThreads) {
    const int r = e / Q;
    const int c = (e - r * Q) * VEC;
    if (c < width) copy_async<VEC * 4>(dst + r * stride + c, src(r) + c, true);
  }
}

template <int BM, int BN>
__global__ void __launch_bounds__(WLayout<BM, BN>::kThreads, WLayout<BM, BN>::kPerSM)
    sparse_conv_wgrad_kernel(const float* __restrict__ feats, const int* __restrict__ nbr,
                             const float* __restrict__ dy, const int* __restrict__ tile_taps,
                             const RowTaps row_taps, float* __restrict__ partial, int Vin,
                             int Vout, int K, int Cin, int Cout, int tiles, int total, int chunks,
                             int vec) {
  using L = WLayout<BM, BN>;
  constexpr int TM = L::TM, TN = L::TN, TG = L::TG, G = L::G, P = L::P;
  constexpr int kThreads = L::kThreads;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                                             // [kStages][TG][kRows][BM]
  float* d_s = smem + kStages * L::kA;                           // [kStages][kRows][BN]
  int* idx_s = reinterpret_cast<int*>(smem + L::kFloats);        // [kMapSlots][TG][kRows]
  int* list_s = idx_s + kMapSlots * L::kI;                       // [kStages][kList]
  int* work_s = list_s + kStages * L::kList;                     // [kMaxList] tiles to sum
  int* warp_s = work_s + kMaxList;                               // [kWarps] ballot counts
  __shared__ int n_work;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = tid / P;
  const int p = tid - g * P;
  const int tx = p % L::kCols;
  const int ty = p / L::kCols;
  const int chunk = blockIdx.x;
  const int n_tiles = chunk < total ? (total - 1 - chunk) / chunks + 1 : 0;

  for (int pass = 0; pass < L::kPasses; ++pass) {
    // the pass's taps, -1 past K
    int tap[TG];
#pragma unroll
    for (int t = 0; t < TG; ++t) tap[t] = row_taps.k[blockIdx.y * kRowTaps + pass * TG + t];
    // tap[t] for a t known only at run time, from registers
    auto tap_of = [&](int t) {
      int k = tap[0];
#pragma unroll
      for (int u = 1; u < TG; ++u)
        if (t == u) k = tap[u];
      return k;
    };

    // this block's tiles, chunk, chunk + chunks, ..., that have a tap of the
    // pass, in order: (tile << 8) | bit t where the tile has tap[t]
    if (tid == 0) n_work = 0;
    for (int w = 0; w < n_tiles; w += kThreads) {
      const int j = w + tid;
      const int gt = chunk + j * chunks;
      const unsigned mask = j < n_tiles ? static_cast<unsigned>(tile_taps[gt]) : 0u;
      unsigned taps = 0u;
#pragma unroll
      for (int t = 0; t < TG; ++t)
        if (tap[t] >= 0 && ((mask >> tap[t]) & 1u)) taps |= 1u << t;
      const unsigned keep = __ballot_sync(0xffffffffu, taps != 0u);
      __syncthreads();                       // n_work of the last window is read
      if (lane == 0) warp_s[warp] = __popc(keep);
      __syncthreads();
      int base = n_work;
      for (int v = 0; v < warp; ++v) base += warp_s[v];
      if (taps != 0u)
        work_s[base + __popc(keep & ((1u << lane) - 1u))] = (gt << 8) | static_cast<int>(taps);
      __syncthreads();
      if (tid == kThreads - 1) n_work = base + __popc(keep);
    }
    __syncthreads();
    const int n = n_work;

    // work item j: its cloud b, its first row row0 of the cloud, its taps
    auto item = [&](int j, int& b, int& row0) {
      const int e = work_s[j];
      const int gt = e >> 8;
      b = gt / tiles;
      row0 = (gt - b * tiles) * kRows;
      return static_cast<unsigned>(e & 0xff);
    };

    // the map's columns of item j's taps (-1 for the others and past the edge)
    auto copy_map = [&](int j) {
      if (j >= n) return;
      int b, row0;
      const unsigned taps = item(j, b, row0);
      const int rows = min(kRows, Vout - row0);
      const int* map = nbr + (static_cast<long long>(b) * Vout + row0) * K;
      int* ix = idx_s + (j % kMapSlots) * L::kI;
      for (int e = tid; e < kRows * TG; e += kThreads) {
        const int r = e / TG;
        const int t = e - r * TG;
        if (r < rows && ((taps >> t) & 1u))
          copy_async<4>(reinterpret_cast<float*>(ix + t * kRows + r),
                        reinterpret_cast<const float*>(map + static_cast<long long>(r) * K +
                                                       tap_of(t)),
                        true);
        else
          ix[t * kRows + r] = -1;
      }
    };

    // each tap's rows that have it, in row order: their rows in the tile and
    // their slots in the table
    auto compact = [&](int j) {
      if (j >= n) return;
      const int* ix = idx_s + (j % kMapSlots) * L::kI;
      int* rl = list_s + (j % kStages) * L::kList;
      int* sl = rl + L::kI;
      int* cnt = sl + L::kI;
      for (int t = warp; t < TG; t += kWarps) {
        int c = 0;
#pragma unroll
        for (int h = 0; h < kRows; h += 32) {
          const int i = ix[t * kRows + h + lane];
          const bool has = i >= 0 && i < Vin;
          const unsigned m = __ballot_sync(0xffffffffu, has);
          if (has) {
            const int at = t * kRows + c + __popc(m & ((1u << lane) - 1u));
            rl[at] = h + lane;
            sl[at] = i;
          }
          c += __popc(m);
        }
        if (lane == 0) cnt[t] = c;
      }
    };

    // item j's dy rows, once for its taps, and each tap's feats rows
    auto copy_rows = [&](int j) {
      if (j >= n) return;
      int b, row0;
      item(j, b, row0);
      const int rows = min(kRows, Vout - row0);
      const float* table = feats + static_cast<long long>(b) * Vin * Cin;
      const float* drows = dy + (static_cast<long long>(b) * Vout + row0) * Cout;
      const int* sl = list_s + (j % kStages) * L::kList + L::kI;
      const int* cnt = sl + L::kI;
      float* as = a_s + (j % kStages) * L::kA;
      float* ds = d_s + (j % kStages) * L::kD;
      auto dy_row = [&](int r) { return drows + static_cast<long long>(r) * Cout; };
      if (vec)
        copy_row_block<4, BN / 4, kThreads>(ds, BN, rows, Cout, dy_row);
      else
        copy_row_block<1, BN, kThreads>(ds, BN, rows, Cout, dy_row);
#pragma unroll
      for (int t = 0; t < TG; ++t) {
        auto feats_row = [&](int r) {
          return table + static_cast<long long>(sl[t * kRows + r]) * Cin;
        };
        if (vec)
          copy_row_block<4, BM / 4, kThreads>(as + t * kRows * BM, BM, cnt[t], Cin, feats_row);
        else
          copy_row_block<1, BM, kThreads>(as + t * kRows * BM, BM, cnt[t], Cin, feats_row);
      }
    };

    float acc[TG][TM][TN];
#pragma unroll
    for (int t = 0; t < TG; ++t)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int m = 0; m < TN; ++m) acc[t][i][m] = 0.f;

    // The ring. Copy group i (one commit) holds item i + kStages's rows and
    // item i + kStages + kAhead's map, so at the end of item j the rows of
    // item j + 1 and the map of item j + kStages are two groups old: their
    // copies ran under two items' products. Items 0 .. kStages - 1 start it.
    for (int i = 0; i < kStages; ++i) copy_map(i);
    copy_commit();
    copy_wait<0>();
    __syncthreads();
    for (int i = 0; i < kStages; ++i) compact(i);
    __syncthreads();
    for (int i = 0; i < kStages; ++i) {
      copy_rows(i);
      if (i + kAhead >= kStages) copy_map(i + kAhead);
      copy_commit();
    }
    copy_wait<kStages - 1>();
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* as = a_s + (j % kStages) * L::kA + ty * 4;
      const float* ds = d_s + (j % kStages) * L::kD + tx * 4;
      const int* rl = list_s + (j % kStages) * L::kList;
      const int* cnt = rl + 2 * L::kI;
#pragma unroll
      for (int t = 0; t < TG; ++t) {
        const int c = cnt[t];
        const float* at = as + t * kRows * BM;
        const int* rt = rl + t * kRows;
        for (int r = g; r < c; r += G) {
          const float* ar = at + r * BM;
          const float* dr = ds + rt[r] * BN;
          float av[TM], dv[TN];
#pragma unroll
          for (int q = 0; q < L::kMQuads; ++q) {
            const float4 x = *reinterpret_cast<const float4*>(ar + q * L::kMStride);
            av[4 * q] = x.x;
            av[4 * q + 1] = x.y;
            av[4 * q + 2] = x.z;
            av[4 * q + 3] = x.w;
          }
#pragma unroll
          for (int q = 0; q < L::kNQuads; ++q) {
            const float4 x = *reinterpret_cast<const float4*>(dr + q * L::kNStride);
            dv[4 * q] = x.x;
            dv[4 * q + 1] = x.y;
            dv[4 * q + 2] = x.z;
            dv[4 * q + 3] = x.w;
          }
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int m = 0; m < TN; ++m) acc[t][i][m] = fmaf(av[i], dv[m], acc[t][i][m]);
        }
      }
      copy_wait<kStages - 2>();
      __syncthreads();     // item j's buffers are free; item j + 1's rows, j + kStages's map landed
      compact(j + kStages);
      __syncthreads();
      copy_rows(j + kStages);
      copy_map(j + kStages + kAhead);
      copy_commit();
    }
    copy_wait<0>();
    __syncthreads();

    // the row groups' accumulators added in a fixed tree order: at step s,
    // group g + s hands its sums to group g (g a multiple of 2s)
    float* fold = smem;
    for (int s = 1; s < G; s *= 2) {
      if (g % (2 * s) == s) {
        float* f = fold + (g / (2 * s)) * L::kAccT * P + p;
#pragma unroll
        for (int t = 0; t < TG; ++t)
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int m = 0; m < TN; ++m) f[((t * TM + i) * TN + m) * P] = acc[t][i][m];
      }
      __syncthreads();
      if (g % (2 * s) == 0 && g + s < G) {
        const float* f = fold + (g / (2 * s)) * L::kAccT * P + p;
#pragma unroll
        for (int t = 0; t < TG; ++t)
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int m = 0; m < TN; ++m) acc[t][i][m] += f[((t * TM + i) * TN + m) * P];
      }
      __syncthreads();
    }
    if (g == 0) {
#pragma unroll
      for (int t = 0; t < TG; ++t) {
        if (tap[t] < 0) continue;
        float* out = partial + (static_cast<long long>(tap[t]) * chunks + chunk) * Cin * Cout;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int row = (i / 4) * L::kMStride + ty * 4 + (i % 4);
          if (row >= Cin) continue;
#pragma unroll
          for (int m = 0; m < TN; ++m) {
            const int col = (m / 4) * L::kNStride + tx * 4 + (m % 4);
            if (col < Cout) out[row * Cout + col] = acc[t][i][m];
          }
        }
      }
    }
    __syncthreads();
  }  // pass
}

// tile_taps[b * tiles + t]: bit k set where a row of tile t of cloud b has
// tap k, 0 <= nbr[b, v, k] < Vin. One block a tile, its map rows read whole.
constexpr int kTapThreads = 128;
__global__ void __launch_bounds__(kTapThreads)
    sparse_conv_wgrad_tile_taps_kernel(const int* __restrict__ nbr, int* __restrict__ tile_taps,
                                       int Vin, int Vout, int K, int tiles) {
  __shared__ unsigned warp_or[kTapThreads / 32];
  const int gt = blockIdx.x;
  const int b = gt / tiles;
  const int row0 = (gt - b * tiles) * kRows;
  const int n = min(kRows, Vout - row0) * K;
  const int* map = nbr + (static_cast<long long>(b) * Vout + row0) * K;
  unsigned bits = 0u;
  for (int e = threadIdx.x; e < n; e += kTapThreads) {
    const int i = map[e];
    if (i >= 0 && i < Vin) bits |= 1u << (e % K);
  }
  bits = __reduce_or_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0) warp_or[threadIdx.x >> 5] = bits;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned m = 0u;
    for (int w = 0; w < kTapThreads / 32; ++w) m |= warp_or[w];
    tile_taps[gt] = static_cast<int>(m);
  }
}

// dw[k * CC + e] = sum over chunks c, in order, of partial[(k * chunks + c) * CC + e]
__global__ void sparse_conv_wgrad_reduce_kernel(const float* __restrict__ partial,
                                                float* __restrict__ dw, int K, int chunks,
                                                int CC) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(K) * CC) return;
  const int k = static_cast<int>(idx / CC);
  const int e = static_cast<int>(idx - static_cast<long long>(k) * CC);
  const float* p = partial + static_cast<long long>(k) * chunks * CC + e;
  float sum = 0.f;
  for (int c = 0; c < chunks; ++c) sum += p[static_cast<long long>(c) * CC];
  dw[idx] = sum;
}

struct Args {
  const float* feats;
  const int* nbr;
  const float* dy;
  const int* tile_taps;
  RowTaps row_taps;
  float* partial;
  int B, Vin, Vout, K, Cin, Cout, chunks, vec;
  cudaStream_t stream;
};

template <int BM, int BN>
int launch(const Args& a) {
  using L = WLayout<BM, BN>;
  static OncePerDevice once;
  bool* done = once.slot();
  if (done == nullptr || !*done) {
    const cudaError_t err = cudaFuncSetAttribute(
        sparse_conv_wgrad_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (done != nullptr) *done = true;
  }
  const int tiles = (a.Vout + kRows - 1) / kRows;
  const dim3 grid(static_cast<unsigned>(a.chunks),
                  static_cast<unsigned>((a.K + kRowTaps - 1) / kRowTaps));
  sparse_conv_wgrad_kernel<BM, BN><<<grid, L::kThreads, L::kSmem, a.stream>>>(
      a.feats, a.nbr, a.dy, a.tile_taps, a.row_taps, a.partial, a.Vin, a.Vout, a.K, a.Cin, a.Cout, tiles,
      a.B * tiles, a.chunks, a.vec);
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
int launch_by_cout(const Args& a) {
  switch (cout_width(a.Cout)) {
    case 8: return launch<BM, 8>(a);
    case 16: return launch<BM, 16>(a);
    case 28: return launch<BM, 28>(a);
    case 32: return launch<BM, 32>(a);
    case 64: return launch<BM, 64>(a);
    default: return launch<BM, 128>(a);
  }
}

template <int BM>
int per_sm_by_cout(int Cout) {
  switch (cout_width(Cout)) {
    case 8: return WLayout<BM, 8>::kPerSM;
    case 16: return WLayout<BM, 16>::kPerSM;
    case 28: return WLayout<BM, 28>::kPerSM;
    case 32: return WLayout<BM, 32>::kPerSM;
    case 64: return WLayout<BM, 64>::kPerSM;
    default: return WLayout<BM, 128>::kPerSM;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0; }

}  // namespace

// Most input and output channels, and the blocks an SM holds of the layout
// for Cin x Cout (ops/sparse_conv.py plans with these).
extern "C" int sparse_conv_wgrad_max_channels() { return kMaxC; }
extern "C" int sparse_conv_wgrad_blocks_per_sm(int Cin, int Cout) {
  if (Cin < 1 || Cin > kMaxC || Cout < 1 || Cout > kMaxC) return 0;
  switch (cin_width(Cin)) {
    case 4: return per_sm_by_cout<4>(Cout);
    case 8: return per_sm_by_cout<8>(Cout);
    case 16: return per_sm_by_cout<16>(Cout);
    case 32: return per_sm_by_cout<32>(Cout);
    case 64: return per_sm_by_cout<64>(Cout);
    default: return per_sm_by_cout<128>(Cout);
  }
}

// The weight gradient of the layer `sparse_conv_launch` computes with feats
// (B, Vin, Cin) float32 and map nbr (B, Vout, K) int32: dw (K * Cin, Cout)
// float32, taps outer, from dy (B, Vout, Cout) float32. row_taps: host
// array of 3 * ceil(K / 3) ints, the taps of each row of blocks, 3 a row,
// -1 for none; every tap 0 .. K - 1 must stand in it once. `tile_rows` must
// be 64. The main launch runs `chunks` x ceil(K / 3) blocks, and block x
// walks tiles x, x + chunks, ... of 64 rows, at most 1024 of them.
// tile_taps: scratch of B * ceil(Vout / 64) ints; partial: scratch of
// K * chunks * Cin * Cout floats. All contiguous. Three launches on
// `stream`; returns 0 or the CUDA error of the first that failed (an
// invalid value for arguments outside these limits). Does not synchronize.
extern "C" int sparse_conv_wgrad_launch(const float* feats, const int* nbr, const float* dy,
                                        const int* row_taps, int* tile_taps, float* partial,
                                        float* dw, int B, int Vin, int Vout, int K, int Cin,
                                        int Cout, int tile_rows, int chunks,
                                        cudaStream_t stream) {
  if (B < 1 || Vin < 1 || Vout < 1 || K < 1 || K > kMaxTaps || Cin < 1 || Cin > kMaxC ||
      Cout < 1 || Cout > kMaxC || tile_rows != kRows || chunks < 1 || chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (Vout + kRows - 1) / kRows;
  const long long total = static_cast<long long>(B) * tiles;
  if (total >= (1LL << 23) || (total + chunks - 1) / chunks > kMaxList)
    return static_cast<int>(cudaErrorInvalidValue);
  RowTaps rt{};
  int seen = 0;
  for (int j = 0; j < kMaxTaps; ++j) rt.k[j] = -1;
  for (int j = 0; j < (K + kRowTaps - 1) / kRowTaps * kRowTaps; ++j) {
    const int k = row_taps[j];
    if (k < -1 || k >= K || (k >= 0 && ((seen >> k) & 1)))
      return static_cast<int>(cudaErrorInvalidValue);
    if (k >= 0) seen |= 1 << k;
    rt.k[j] = k;
  }
  if (seen != static_cast<int>((1LL << K) - 1)) return static_cast<int>(cudaErrorInvalidValue);
  sparse_conv_wgrad_tile_taps_kernel<<<static_cast<unsigned>(total), kTapThreads, 0, stream>>>(
      nbr, tile_taps, Vin, Vout, K, tiles);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int vec = Cin % 4 == 0 && Cout % 4 == 0 && aligned16(feats) && aligned16(dy);
  const Args a{feats, nbr, dy, tile_taps, rt, partial, B, Vin, Vout, K, Cin, Cout, chunks, vec,
               stream};
  switch (cin_width(Cin)) {
    case 4: err = launch_by_cout<4>(a); break;
    case 8: err = launch_by_cout<8>(a); break;
    case 16: err = launch_by_cout<16>(a); break;
    case 32: err = launch_by_cout<32>(a); break;
    case 64: err = launch_by_cout<64>(a); break;
    default: err = launch_by_cout<128>(a); break;
  }
  if (err != 0) return err;
  const int CC = Cin * Cout;
  const long long n = static_cast<long long>(K) * CC;
  sparse_conv_wgrad_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      partial, dw, K, chunks, CC);
  return static_cast<int>(cudaGetLastError());
}
