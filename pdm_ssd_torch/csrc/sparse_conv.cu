// Gather-matmul sparse convolution for Hopper (sm_90a): sparse_conv.
//
//   out[b, v, :] = sum_k feats[b, nbr[b, v, k], :] @ W[k]
//
// with nbr[b, v, k] outside [0, Vin) meaning "absent tap, contributes
// nothing". It is the one counterpart of the TPU's four fused "windowed
// gather + sparse-conv matmul" kernels
//   run_pallas, variants D/E   (tools/microbench_sparse_gather.py)
//   run_f, variant F           (tools/microbench_sparse_gather2.py)
//   run_pallas, variants G/H   (tools/microbench_sparse_gather2.py)
//   run_pallas, variant I      (tools/microbench_sparse_gather3.py)
// and of the model's `gather_taps` + `dot_general`
// (pdm_ssd_tpu/models/backbones_3d/sparse_backbone.py). Those four differ in
// how they get rows out of a table on a machine that gathers slowly: one-hot
// products over DMA'd windows of the sorted slot table, rows packed to 128
// lanes, a resident table. Here a thread reads a row by its address, so one
// kernel computes what all four compute. The plain version is
// `sparse_conv_plain` in pdm_ssd_torch/ops/sparse_conv.py.
//
// What bounds it: operations. A 64 -> 64 layer over 52000 rows with a third
// of its taps present is about 4 GFLOP per cloud against 13 MB of table,
// 5.6 MB of map and 13 MB of output: float32 arithmetic takes several times
// the bytes' time at the card's peaks. So the design spends nothing on taps
// that are not there and keeps the arithmetic units fed:
//
// - A plan per kernel map (`sparse_conv_plan` in ops/sparse_conv.py) sorts
//   each cloud's output rows by their 27-bit tap mask and gives every tile
//   of 64 sorted rows the OR of its rows' masks. Rows with the same taps sit
//   together, so a tile's OR-mask is close to each row's own.
// - A block of 128 threads owns one tile and all Cout columns (up to 128).
//   It reads its rows through the plan's order and writes each result to the
//   row's own slot. The reduction axis is the tile's present taps only
//   (taps outer, channels inner, the layout of W): a tap absent from the
//   OR-mask is skipped whole, and a tile without taps writes zeros.
// - That axis is walked in chunks of 32. A chunk's gathered inputs (64 rows
//   x 32, zero where a row lacks the tap) and its 32 rows of W are copied to
//   shared memory with cp.async, 16 bytes a copy where the widths allow,
//   zero-filled by the copy itself; two stages, so the next chunk's gather
//   runs under this chunk's arithmetic. Inputs are staged row-major with a
//   row stride of 36 floats: the copies of one row fill consecutive banks
//   (the old column-major store hit one bank 8 times), and a float4 read of
//   the product is a broadcast within the lanes of one row.
// - Every thread accumulates a TM x TN register tile (8 x 8 at 128 columns,
//   8 x 4 at 64), reading 4 reduction steps of its rows and of its columns
//   as float4s. A thread's rows are kThreads / (BN / TN) apart, so the
//   lanes of a warp that read different rows read different banks.
//
// Each output is one chain of fused multiply-adds over the reduction axis in
// order, so two runs give the same bits and no atomics are needed; a step
// that the tile has but the row lacks adds an exact 0. A row's result
// therefore does not depend on its tile: the plan moves work, not numbers.
// The data gradient of the backward is this same product through the
// transposed map with W flipped per tap (ops/sparse_conv.py launches it so).
//
// sparse_conv_wgrad is the weight gradient,
//
//   dW[k] = sum_v feats[b, nbr[b, v, k], :]^T dy[b, v, :]     (Cin x Cout)
//
// the counterpart of the `dWt = feats^T . gather(dy, bplan)` dot_general of
// `_scm_bwd` (pdm_ssd_tpu/models/backbones_3d/sparse_backbone.py), which XLA
// computes on the TPU: the same sum written through the forward map, so that
// the forward's plan says which taps a tile of rows has. Its plain version is
// `sparse_conv_wgrad_plain`. What bounds it: operations, 2 * Cin * Cout per
// present tap of a row against Cin + Cout floats staged per row (a 64 -> 64
// layer does 32 multiply-adds for every float it stages). The design is the
// simple one:
//
// - A block of 256 threads owns one tap and a chunk of consecutive tiles of
//   the plan (64 sorted rows each). A tile whose OR-mask lacks the tap is
//   skipped whole. Of the other tiles it walks 32 rows at a time: one warp
//   looks up the tap's input slot of each row and compacts the rows that
//   have it (a ballot), then the block stages their gathered feats rows and
//   their dy rows in shared memory and adds the outer products.
// - The threads form G groups; each group owns the whole Cin x Cout tile in
//   TM x TN registers a thread and takes every G-th staged row. At the end
//   the groups are added in a fixed order through shared memory and the
//   block writes one partial per (tap, chunk).
// - A second launch sums each output's partials over the chunks in chunk
//   order. No float atomics anywhere: two runs give the same bits.
//
// `wgmma`, TMA and a better staging are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileRows = 64;             // output rows of a block
constexpr int kChunk = 32;                // reduction steps staged at once
constexpr int kAStride = kChunk + 4;      // floats between staged rows
constexpr int kAStage = kTileRows * kAStride;
constexpr int kMaxTaps = 27;
constexpr int kMaxCout = 128;

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

template <int BN>
constexpr int smem_bytes(int K) {
  return static_cast<int>(sizeof(float)) * 2 * (kAStage + kChunk * BN) +
         static_cast<int>(sizeof(int)) * kTileRows * K;
}

// BN: columns of the block (Cout rounded up); TN: columns of a thread, in
// float4 groups BN / (TN / 4) apart; VEC: floats a copy moves (4 where Cin
// and Cout are multiples of 4 and the pointers 16-byte aligned, else 1).
template <int BN, int TN, int VEC>
__global__ void __launch_bounds__(kThreads)
    sparse_conv_kernel(const float* __restrict__ feats, const int* __restrict__ nbr,
                       const float* __restrict__ w, const int* __restrict__ order,
                       const int* __restrict__ tile_mask, float* __restrict__ out, int Vin,
                       int Vout, int K, int Cin, int cin_shift, int Cout, int tiles) {
  constexpr int kColGroups = BN / TN;
  constexpr int kRowGroups = kThreads / kColGroups;
  constexpr int TM = kTileRows / kRowGroups;
  constexpr int kQuads = TN / 4;
  constexpr int kQuadStride = BN / kQuads;
  constexpr int kWStage = kChunk * BN;
  static_assert(kColGroups * kRowGroups == kThreads && TM * kRowGroups == kTileRows, "layout");
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                                           // [2][kTileRows][kAStride]
  float* w_s = smem + 2 * kAStage;                             // [2][kChunk][BN]
  int* idx_s = reinterpret_cast<int*>(w_s + 2 * kWStage);      // [kTileRows][K]
  __shared__ int row_s[kTileRows];
  __shared__ int tap_s[kMaxTaps];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, Vout - row0);
  const unsigned mask = static_cast<unsigned>(tile_mask[static_cast<long long>(b) * tiles +
                                                        blockIdx.x]) & ((1u << K) - 1u);
  const int ntaps = __popc(mask);
  const float* table = feats + static_cast<long long>(b) * Vin * Cin;
  const int* map = nbr + static_cast<long long>(b) * Vout * K;
  float* dst = out + static_cast<long long>(b) * Vout * Cout;

  if (tid < kTileRows) {  // a slot outside [0, Vout) is neither read nor written
    const int v = tid < rows ? order[static_cast<long long>(b) * Vout + row0 + tid] : -1;
    row_s[tid] = v >= 0 && v < Vout ? v : -1;
  }
  if (tid < K && ((mask >> tid) & 1u)) tap_s[__popc(mask & ((1u << tid) - 1u))] = tid;
  __syncthreads();
  // the tile's map: -1 for a tap the row lacks and for rows past the edge
  if (ntaps > 0) {
    for (int e = tid; e < kTileRows * K; e += kThreads) {
      const int r = e / K;
      const int k = e - r * K;
      int i = -1;
      if (row_s[r] >= 0 && ((mask >> k) & 1u)) {
        i = map[static_cast<long long>(row_s[r]) * K + k];
        if (i < 0 || i >= Vin) i = -1;
      }
      idx_s[e] = i;
    }
  }
  __syncthreads();

  const int depth = ntaps * Cin;  // the tile's reduction axis: its taps x Cin
  const int chunks = (depth + kChunk - 1) / kChunk;
  // step j of the axis is channel j % Cin of tap slot j / Cin (a shift where
  // Cin is a power of two, as on every layer of the ladder)
  auto tap_slot = [&](int j) { return cin_shift >= 0 ? j >> cin_shift : j / Cin; };
  auto stage = [&](int c, int s) {
    float* as = a_s + s * kAStage;
    float* ws = w_s + s * kWStage;
    const int j0 = c * kChunk;
    constexpr int kAPer = kChunk / VEC;
    for (int e = tid; e < kTileRows * kAPer; e += kThreads) {
      const int r = e / kAPer;
      const int q = e - r * kAPer;
      const int j = j0 + q * VEC;
      const float* src = table;
      bool valid = false;
      if (j < depth) {
        const int t = tap_slot(j);
        const int i = idx_s[r * K + tap_s[t]];
        if (i >= 0) {
          src = table + static_cast<long long>(i) * Cin + (j - t * Cin);
          valid = true;
        }
      }
      copy_async<VEC * 4>(as + r * kAStride + q * VEC, src, valid);
    }
    constexpr int kWPer = BN / VEC;
    for (int e = tid; e < kChunk * kWPer; e += kThreads) {
      const int jj = e / kWPer;
      const int col = (e - jj * kWPer) * VEC;
      const int j = j0 + jj;
      const float* src = w;
      bool valid = false;
      if (j < depth && col < Cout) {
        const int t = tap_slot(j);
        src = w + (static_cast<long long>(tap_s[t]) * Cin + (j - t * Cin)) * Cout + col;
        valid = true;
      }
      copy_async<VEC * 4>(ws + jj * BN + col, src, valid);
    }
  };

  const int tx = tid % kColGroups;
  const int ty = tid / kColGroups;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[i][n] = 0.f;

  if (chunks > 0) {
    stage(0, 0);
    copy_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage(c + 1, (c + 1) & 1);
      copy_commit();
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();
    const float* as = a_s + (c & 1) * kAStage + ty * kAStride;
    const float* ws = w_s + (c & 1) * kWStage + tx * 4;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + i * kRowGroups * kAStride + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float wv[TN];
#pragma unroll
        for (int g = 0; g < kQuads; ++g) {
          const float4 q = *reinterpret_cast<const float4*>(ws + (kk + u) * BN + g * kQuadStride);
          wv[4 * g] = q.x;
          wv[4 * g + 1] = q.y;
          wv[4 * g + 2] = q.z;
          wv[4 * g + 3] = q.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = u == 0 ? a[i].x : u == 1 ? a[i].y : u == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int n = 0; n < TN; ++n) acc[i][n] = fmaf(av, wv[n], acc[i][n]);
        }
      }
    }
    // the next iteration's copies overwrite the other stage, which every
    // thread has finished reading
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + i * kRowGroups;
    if (row_s[r] >= 0) {
      float* o = dst + static_cast<long long>(row_s[r]) * Cout;
#pragma unroll
      for (int g = 0; g < kQuads; ++g) {
        const int col = g * kQuadStride + tx * 4;
        if constexpr (VEC == 4) {
          if (col < Cout)
            *reinterpret_cast<float4*>(o + col) =
                make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < Cout) o[col + e] = acc[i][4 * g + e];
        }
      }
    }
  }
}

template <int BN, int TN, int VEC>
int launch(const float* feats, const int* nbr, const float* w, const int* order,
           const int* tile_mask, float* out, int B, int Vin, int Vout, int K, int Cin, int Cout,
           int tiles, cudaStream_t stream) {
  const int cin_shift = (Cin & (Cin - 1)) == 0 ? __builtin_ctz(static_cast<unsigned>(Cin)) : -1;
  static OncePerDevice once;  // for the largest map this layout takes
  bool* done = once.slot();
  if (done == nullptr || !*done) {
    const cudaError_t err =
        cudaFuncSetAttribute(sparse_conv_kernel<BN, TN, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<BN>(kMaxTaps));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (done != nullptr) *done = true;
  }
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(B));
  sparse_conv_kernel<BN, TN, VEC><<<grid, kThreads, smem_bytes<BN>(K), stream>>>(
      feats, nbr, w, order, tile_mask, out, Vin, Vout, K, Cin, cin_shift, Cout, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int launch_by_width(const float* feats, const int* nbr, const float* w, const int* order,
                    const int* tile_mask, float* out, int B, int Vin, int Vout, int K, int Cin,
                    int Cout, int tiles, cudaStream_t stream) {
  if (Cout <= 16)
    return launch<16, 4, VEC>(feats, nbr, w, order, tile_mask, out, B, Vin, Vout, K, Cin, Cout,
                              tiles, stream);
  if (Cout <= 32)
    return launch<32, 4, VEC>(feats, nbr, w, order, tile_mask, out, B, Vin, Vout, K, Cin, Cout,
                              tiles, stream);
  if (Cout <= 64)
    return launch<64, 4, VEC>(feats, nbr, w, order, tile_mask, out, B, Vin, Vout, K, Cin, Cout,
                              tiles, stream);
  return launch<128, 8, VEC>(feats, nbr, w, order, tile_mask, out, B, Vin, Vout, K, Cin, Cout,
                             tiles, stream);
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0; }

constexpr int kWThreads = 256;
constexpr int kWRows = 32;               // rows of a tile staged at once (one warp's lookups)
constexpr int kWMaxC = 128;              // most Cin and Cout of the weight gradient

// BM x BN: the block's output tile (Cin and Cout rounded up to 16, 32, 64 or
// 128); TM x TN the registers of a thread, in float4 groups BM / (TM / 4)
// and BN / (TN / 4) apart.
template <int BM, int BN>
struct WLayout {
  static constexpr int TM = BM >= 64 ? 8 : 4;
  static constexpr int TN = BN >= 64 ? 8 : 4;
  static constexpr int kCols = BN / TN;               // threads across a group's columns
  static constexpr int kGroup = (BM / TM) * kCols;    // threads of a group
  static constexpr int G = kWThreads / kGroup;        // groups of the block
  static constexpr int kStage = kWRows * (BM + BN);
  static constexpr int kSmem = (G > 1 && BM * BN > kStage) ? BM * BN : kStage;
  static_assert(kGroup * G == kWThreads && G <= kWRows, "layout");
};

template <int BM, int BN>
__global__ void __launch_bounds__(kWThreads)
    sparse_conv_wgrad_kernel(const float* __restrict__ feats, const int* __restrict__ nbr,
                             const float* __restrict__ dy, const int* __restrict__ order,
                             const int* __restrict__ tile_mask, float* __restrict__ partial,
                             int Vin, int Vout, int K, int Cin, int Cout, int tiles,
                             int total_tiles, int tiles_per_chunk, int chunks) {
  using L = WLayout<BM, BN>;
  constexpr int TM = L::TM, TN = L::TN, G = L::G;
  constexpr int kMQuads = TM / 4, kNQuads = TN / 4;
  constexpr int kMStride = BM / kMQuads, kNStride = BN / kNQuads;
  __shared__ __align__(16) float smem[L::kSmem];
  float* a_s = smem;                        // [kWRows][BM] gathered feats rows
  float* d_s = smem + kWRows * BM;          // [kWRows][BN] dy rows
  __shared__ int src_s[kWRows];             // a staged row's input slot
  __shared__ long long dst_s[kWRows];       // its dy row, batch included
  __shared__ int count_s;

  const int tid = threadIdx.x;
  const int g = tid / L::kGroup;
  const int t = tid - g * L::kGroup;
  const int tx = t % L::kCols;
  const int ty = t / L::kCols;
  const int k = blockIdx.y;
  const int chunk = blockIdx.x;
  const unsigned bit = 1u << k;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[i][n] = 0.f;

  const int t1 = min(total_tiles, (chunk + 1) * tiles_per_chunk);
  for (int gt = chunk * tiles_per_chunk; gt < t1; ++gt) {
    if ((static_cast<unsigned>(tile_mask[gt]) & bit) == 0u) continue;  // uniform: skip the tile
    const int b = gt / tiles;
    const int row0 = (gt - b * tiles) * kTileRows;
    const int rows = min(kTileRows, Vout - row0);
    const float* table = feats + static_cast<long long>(b) * Vin * Cin;
    for (int s = 0; s < rows; s += kWRows) {
      __syncthreads();  // the last sub-block's rows are read
      if (tid < kWRows) {
        int i = -1;
        long long dst = 0;
        if (s + tid < rows) {
          const int v = order[static_cast<long long>(b) * Vout + row0 + s + tid];
          if (v >= 0 && v < Vout) {
            dst = static_cast<long long>(b) * Vout + v;
            i = nbr[dst * K + k];
            if (i >= Vin) i = -1;
          }
        }
        const unsigned present = __ballot_sync(0xffffffffu, i >= 0);
        if (i >= 0) {
          const int slot = __popc(present & ((1u << tid) - 1u));
          src_s[slot] = i;
          dst_s[slot] = dst;
        }
        if (tid == 0) count_s = __popc(present);
      }
      __syncthreads();
      const int n = count_s;
      if (n == 0) continue;
      for (int e = tid; e < kWRows * BM; e += kWThreads) {
        const int r = e / BM;
        const int c = e - r * BM;
        a_s[e] = r < n && c < Cin ? table[static_cast<long long>(src_s[r]) * Cin + c] : 0.f;
      }
      for (int e = tid; e < kWRows * BN; e += kWThreads) {
        const int r = e / BN;
        const int c = e - r * BN;
        d_s[e] = r < n && c < Cout ? dy[dst_s[r] * Cout + c] : 0.f;
      }
      __syncthreads();
      for (int r = g; r < n; r += G) {
        float av[TM], dv[TN];
#pragma unroll
        for (int q = 0; q < kMQuads; ++q) {
          const float4 x = *reinterpret_cast<const float4*>(a_s + r * BM + q * kMStride + ty * 4);
          av[4 * q] = x.x;
          av[4 * q + 1] = x.y;
          av[4 * q + 2] = x.z;
          av[4 * q + 3] = x.w;
        }
#pragma unroll
        for (int q = 0; q < kNQuads; ++q) {
          const float4 x = *reinterpret_cast<const float4*>(d_s + r * BN + q * kNStride + tx * 4);
          dv[4 * q] = x.x;
          dv[4 * q + 1] = x.y;
          dv[4 * q + 2] = x.z;
          dv[4 * q + 3] = x.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int m = 0; m < TN; ++m) acc[i][m] = fmaf(av[i], dv[m], acc[i][m]);
      }
    }
  }

  // the groups' tiles added in group order: group 0 keeps the sum
  auto at = [&](int i, int m) {
    return ((i / 4) * kMStride + ty * 4 + (i % 4)) * BN + (m / 4) * kNStride + tx * 4 + (m % 4);
  };
  for (int h = 1; h < G; ++h) {
    __syncthreads();
    if (g == h) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int m = 0; m < TN; ++m) smem[at(i, m)] = acc[i][m];
    }
    __syncthreads();
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int m = 0; m < TN; ++m) acc[i][m] += smem[at(i, m)];
    }
  }
  if (g == 0) {
    float* out = partial + (static_cast<long long>(k) * chunks + chunk) * Cin * Cout;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = (i / 4) * kMStride + ty * 4 + (i % 4);
      if (row >= Cin) continue;
#pragma unroll
      for (int m = 0; m < TN; ++m) {
        const int col = (m / 4) * kNStride + tx * 4 + (m % 4);
        if (col < Cout) out[row * Cout + col] = acc[i][m];
      }
    }
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

template <int BM, int BN>
int wgrad_launch(const float* feats, const int* nbr, const float* dy, const int* order,
                 const int* tile_mask, float* partial, int B, int Vin, int Vout, int K, int Cin,
                 int Cout, int tiles_per_chunk, int chunks, cudaStream_t stream) {
  const int tiles = (Vout + kTileRows - 1) / kTileRows;
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(K));
  sparse_conv_wgrad_kernel<BM, BN><<<grid, kWThreads, 0, stream>>>(
      feats, nbr, dy, order, tile_mask, partial, Vin, Vout, K, Cin, Cout, tiles, B * tiles,
      tiles_per_chunk, chunks);
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
int wgrad_by_cout(const float* feats, const int* nbr, const float* dy, const int* order,
                  const int* tile_mask, float* partial, int B, int Vin, int Vout, int K, int Cin,
                  int Cout, int tiles_per_chunk, int chunks, cudaStream_t stream) {
  if (Cout <= 16)
    return wgrad_launch<BM, 16>(feats, nbr, dy, order, tile_mask, partial, B, Vin, Vout, K, Cin,
                                Cout, tiles_per_chunk, chunks, stream);
  if (Cout <= 32)
    return wgrad_launch<BM, 32>(feats, nbr, dy, order, tile_mask, partial, B, Vin, Vout, K, Cin,
                                Cout, tiles_per_chunk, chunks, stream);
  if (Cout <= 64)
    return wgrad_launch<BM, 64>(feats, nbr, dy, order, tile_mask, partial, B, Vin, Vout, K, Cin,
                                Cout, tiles_per_chunk, chunks, stream);
  return wgrad_launch<BM, 128>(feats, nbr, dy, order, tile_mask, partial, B, Vin, Vout, K, Cin,
                               Cout, tiles_per_chunk, chunks, stream);
}

}  // namespace

// Most taps and output channels one launch takes, and the rows of a tile
// (the plan's tiles must be the kernel's).
extern "C" int sparse_conv_max_taps() { return kMaxTaps; }
extern "C" int sparse_conv_max_cout() { return kMaxCout; }
extern "C" int sparse_conv_tile_rows() { return kTileRows; }

// feats: (B, Vin, Cin) float32; nbr: (B, Vout, K) int32, an entry outside
// [0, Vin) is an absent tap; w: (K * Cin, Cout) float32, taps outer; order:
// (B, Vout) int32, each cloud's rows sorted by tap mask (a permutation of
// [0, Vout)); tile_mask: (B, tiles) int32, bit k set where a row of the
// tile has tap k, tiles = ceil(Vout / tile_rows); out: (B, Vout, Cout)
// float32. All contiguous. Returns 0 or the CUDA error of the launch; does
// not synchronize.
extern "C" int sparse_conv_launch(const float* feats, const int* nbr, const float* w,
                                  const int* order, const int* tile_mask, float* out, int B,
                                  int Vin, int Vout, int K, int Cin, int Cout, int tile_rows,
                                  cudaStream_t stream) {
  if (B < 1 || B > 65535 || Vin < 1 || Vout < 1 || K < 1 || K > kMaxTaps || Cin < 1 ||
      Cout < 1 || Cout > kMaxCout || tile_rows != kTileRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (Vout + kTileRows - 1) / kTileRows;
  const bool vec = Cin % 4 == 0 && Cout % 4 == 0 && aligned16(feats) && aligned16(w) &&
                   aligned16(out);
  if (vec)
    return launch_by_width<4>(feats, nbr, w, order, tile_mask, out, B, Vin, Vout, K, Cin, Cout,
                              tiles, stream);
  return launch_by_width<1>(feats, nbr, w, order, tile_mask, out, B, Vin, Vout, K, Cin, Cout,
                            tiles, stream);
}

// Most input and output channels the weight gradient takes.
extern "C" int sparse_conv_wgrad_max_channels() { return kWMaxC; }

// The weight gradient of the layer that `sparse_conv_launch` computes with
// the same feats, nbr and plan: dw (K * Cin, Cout) float32, taps outer, from
// dy (B, Vout, Cout) float32. partial: scratch of K * chunks * Cin * Cout
// floats, chunks = ceil(B * tiles / tiles_per_chunk). Two launches on
// `stream`; returns 0 or the CUDA error of the first that failed.
extern "C" int sparse_conv_wgrad_launch(const float* feats, const int* nbr, const float* dy,
                                        const int* order, const int* tile_mask, float* partial,
                                        float* dw, int B, int Vin, int Vout, int K, int Cin,
                                        int Cout, int tile_rows, int tiles_per_chunk,
                                        cudaStream_t stream) {
  if (B < 1 || Vin < 1 || Vout < 1 || K < 1 || K > kMaxTaps || Cin < 1 || Cin > kWMaxC ||
      Cout < 1 || Cout > kWMaxC || tile_rows != kTileRows || tiles_per_chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(B) * ((Vout + kTileRows - 1) / kTileRows);
  const long long chunks = (total + tiles_per_chunk - 1) / tiles_per_chunk;
  if (total > 0x7fffffffLL || chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int c = static_cast<int>(chunks);
  int err;
  if (Cin <= 16)
    err = wgrad_by_cout<16>(feats, nbr, dy, order, tile_mask, partial, B, Vin, Vout, K, Cin, Cout,
                            tiles_per_chunk, c, stream);
  else if (Cin <= 32)
    err = wgrad_by_cout<32>(feats, nbr, dy, order, tile_mask, partial, B, Vin, Vout, K, Cin, Cout,
                            tiles_per_chunk, c, stream);
  else if (Cin <= 64)
    err = wgrad_by_cout<64>(feats, nbr, dy, order, tile_mask, partial, B, Vin, Vout, K, Cin, Cout,
                            tiles_per_chunk, c, stream);
  else
    err = wgrad_by_cout<128>(feats, nbr, dy, order, tile_mask, partial, B, Vin, Vout, K, Cin,
                             Cout, tiles_per_chunk, c, stream);
  if (err != 0) return err;
  const int CC = Cin * Cout;
  const long long n = static_cast<long long>(K) * CC;
  sparse_conv_wgrad_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      partial, dw, K, c, CC);
  return static_cast<int>(cudaGetLastError());
}
