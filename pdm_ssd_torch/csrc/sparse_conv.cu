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
// transposed map with W flipped per tap (ops/sparse_conv.py launches it so);
// the weight gradient is its own kernel, in sparse_conv_wgrad.cu.
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

using pdm_ssd::copy_async;
using pdm_ssd::copy_commit;
using pdm_ssd::copy_wait;
using pdm_ssd::OncePerDevice;

constexpr int kThreads = 128;
constexpr int kTileRows = 64;             // output rows of a block
constexpr int kChunk = 32;                // reduction steps staged at once
constexpr int kAStride = kChunk + 4;      // floats between staged rows
constexpr int kAStage = kTileRows * kAStride;
constexpr int kMaxTaps = 27;
constexpr int kMaxCout = 128;

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
