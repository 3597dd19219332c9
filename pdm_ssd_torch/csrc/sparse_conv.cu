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
// Design. A block of 256 threads owns a tile of 64 output rows of one cloud
// and all Cout columns (up to 128). The K * Cin reduction axis (taps outer,
// channels inner, the layout of W) is walked in chunks of 32: the block
// stages the chunk's gathered inputs (64 x 32, transposed, zero where a tap
// is absent) and the chunk's 32 rows of W in shared memory, then every thread
// accumulates a 4 x CN register tile (rows ty*4.., columns tx, tx+16, ..) with
// fused multiply-adds, in chunk order and channel order: a fixed order, so two
// runs give the same bits. A chunk in which no row of the tile has a present
// tap is skipped, and a tile with no present tap at all writes zeros at once
// (the padding slots past a cloud's active count). Channels are read 4 bytes
// at a time, so Cin = 4 and rows that are not 16-byte aligned take the same
// code.
//
// What bounds it: operations, for the ladder's wide layers. A 64 -> 64 layer
// over 52000 rows with every tap present is 11.5 GFLOP per cloud against 13 MB
// of table, 5.6 MB of map and 13 MB of output: 0.17 ms of float32 arithmetic
// against 0.01 ms of bytes at the card's peaks. The tile reuses every staged W
// row 64 times and every staged input 16 * CN times from shared memory, and
// the gathered rows of neighbouring output slots overlap in L2 because slots
// are sorted by cell. Tensor cores (this is float32 on the CUDA cores) and
// reuse of gathered rows across the three x-taps are left for later.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;       // output rows of a block
constexpr int kChunk = 32;          // reduction elements staged at once
constexpr int kMaxTaps = 27;
constexpr int kTx = 16;             // threads across the columns
constexpr int kRowsPerThread = 4;   // kTileRows / (kThreads / kTx)
constexpr int kAPad = kTileRows + 4;  // keeps float4 reads of 4 rows aligned

template <int CN>
__global__ void __launch_bounds__(kThreads)
    sparse_conv_kernel(const float* __restrict__ feats, const int* __restrict__ nbr,
                       const float* __restrict__ w, float* __restrict__ out, int Vin, int Vout,
                       int K, int Cin, int Cout) {
  constexpr int kCols = kTx * CN;
  __shared__ int idx_s[kTileRows * kMaxTaps];
  __shared__ __align__(16) float a_s[kChunk * kAPad];
  __shared__ __align__(16) float w_s[kChunk * kCols];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, Vout - row0);
  const float* table = feats + static_cast<long long>(b) * Vin * Cin;
  const int* map = nbr + (static_cast<long long>(b) * Vout + row0) * K;
  float* dst = out + (static_cast<long long>(b) * Vout + row0) * Cout;

  // the tile's map; rows past the ragged edge read as absent
  int any = 0;
  for (int e = tid; e < kTileRows * K; e += kThreads) {
    int i = -1;
    if (e < rows * K) {
      i = map[e];
      if (i < 0 || i >= Vin) i = -1;
    }
    idx_s[e] = i;
    any |= (i >= 0);
  }
  any = __syncthreads_or(any);

  const int tx = tid % kTx;
  const int ty = tid / kTx;
  float acc[kRowsPerThread][CN];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[r][j] = 0.f;

  if (any) {
    const int depth = K * Cin;
    for (int j0 = 0; j0 < depth; j0 += kChunk) {
      const int len = min(kChunk, depth - j0);
      // gathered inputs of the chunk: a_s[jj][row] = table[idx[row][k]][c],
      // (k, c) = divmod(j0 + jj, Cin); consecutive threads read consecutive
      // channels of one table row
      int present = 0;
      for (int e = tid; e < kTileRows * kChunk; e += kThreads) {
        const int row = e / kChunk;
        const int jj = e - row * kChunk;
        float v = 0.f;
        if (jj < len) {
          const int j = j0 + jj;
          const int k = j / Cin;
          const int i = idx_s[row * K + k];
          if (i >= 0) {
            v = table[static_cast<long long>(i) * Cin + (j - k * Cin)];
            present = 1;
          }
        }
        a_s[jj * kAPad + row] = v;
      }
      // also the barrier that orders this chunk's stores after the last
      // chunk's reads
      if (!__syncthreads_or(present)) continue;
      for (int e = tid; e < kChunk * kCols; e += kThreads) {
        const int jj = e / kCols;
        const int col = e - jj * kCols;
        w_s[e] = (jj < len && col < Cout)
                     ? w[static_cast<long long>(j0 + jj) * Cout + col] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int jj = 0; jj < kChunk; ++jj) {
        const float4 a = *reinterpret_cast<const float4*>(a_s + jj * kAPad
                                                          + ty * kRowsPerThread);
        const float av[kRowsPerThread] = {a.x, a.y, a.z, a.w};
        float wv[CN];
#pragma unroll
        for (int j = 0; j < CN; ++j) wv[j] = w_s[jj * kCols + j * kTx + tx];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
          for (int j = 0; j < CN; ++j) acc[r][j] = fmaf(av[r], wv[j], acc[r][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = ty * kRowsPerThread + r;
    if (row < rows) {
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int col = j * kTx + tx;
        if (col < Cout) dst[static_cast<long long>(row) * Cout + col] = acc[r][j];
      }
    }
  }
}

}  // namespace

// Most taps and output channels one launch takes.
extern "C" int sparse_conv_max_taps() { return kMaxTaps; }
extern "C" int sparse_conv_max_cout() { return kTx * 8; }

// feats: (B, Vin, Cin) float32; nbr: (B, Vout, K) int32, an entry outside
// [0, Vin) is an absent tap; w: (K * Cin, Cout) float32, taps outer;
// out: (B, Vout, Cout) float32. All contiguous. Returns 0 or the CUDA error of
// the launch; does not synchronize.
extern "C" int sparse_conv_launch(const float* feats, const int* nbr, const float* w, float* out,
                                  int B, int Vin, int Vout, int K, int Cin, int Cout,
                                  cudaStream_t stream) {
  if (B < 1 || B > 65535 || Vin < 1 || Vout < 1 || K < 1 || K > kMaxTaps || Cin < 1 ||
      Cout < 1 || Cout > kTx * 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Vout + kTileRows - 1) / kTileRows, B);
  if (Cout <= kTx) {
    sparse_conv_kernel<1><<<grid, kThreads, 0, stream>>>(feats, nbr, w, out, Vin, Vout, K, Cin,
                                                         Cout);
  } else if (Cout <= kTx * 2) {
    sparse_conv_kernel<2><<<grid, kThreads, 0, stream>>>(feats, nbr, w, out, Vin, Vout, K, Cin,
                                                         Cout);
  } else if (Cout <= kTx * 4) {
    sparse_conv_kernel<4><<<grid, kThreads, 0, stream>>>(feats, nbr, w, out, Vin, Vout, K, Cin,
                                                         Cout);
  } else {
    sparse_conv_kernel<8><<<grid, kThreads, 0, stream>>>(feats, nbr, w, out, Vin, Vout, K, Cin,
                                                         Cout);
  }
  return static_cast<int>(cudaGetLastError());
}
