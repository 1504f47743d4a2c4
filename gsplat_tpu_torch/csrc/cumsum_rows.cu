// Kernel B3: inclusive prefix sum of a [rows, 16] f32 array along its rows.
//
// Replaces: gsplat_tpu/render/blend_pallas.py::_cumsum_rows_kernel (Pallas,
// reached through cumsum_rows), which streams 1024-row blocks through VMEM
// in grid order and carries a [1, C] running sum from one grid step to the
// next. Blocks of a CUDA grid run in no order, so the carry becomes a
// three-launch scan:
//   1. block_sums: each block of 512 rows writes its 16 column totals;
//   2. scan_block_sums: one block turns those totals into exclusive
//      per-block offsets, in place;
//   3. scan_blocks: each block scans its 512 rows and adds its offset.
// In launches 1 and 3 a block stages its 512 x 16 tile in shared memory
// with coalesced 16-byte loads; thread (column c, segment s) owns rows
// [32 s, 32 s + 32) of column c and scans them serially, then adds the
// totals of the segments before it. Each segment of 32 rows sits 528 floats
// from the next (16 floats of padding), so the two segments a warp reads at
// once fall in different shared-memory banks.
//
// Bound on the card: bytes. The function reads the array once and writes it
// once (2 x rows x 64 bytes); this design reads it twice (launches 1 and 3),
// so it moves 1.5x the bound's bytes.
//
// Rounding: the offsets (block totals, their scan, and the totals of the
// segments before a thread's own) are carried in f64, so each output is the
// f32 in-segment prefix (at most 32 terms) plus one f32 rounding of an exact
// offset; an f32 carry across 2.5M rows would add a chain of ~150 roundings
// of the column's largest prefix.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 16;
constexpr int kThreads = 256;
constexpr int kSegRows = 32;
constexpr int kSegs = kThreads / kCols;            // 16 segments
constexpr int kBlockRows = kSegs * kSegRows;       // 512 rows per block
constexpr int kSegStride = kSegRows * kCols + 16;  // padded segment
constexpr int kScanThreads = 1024;
constexpr int kScanSegs = kScanThreads / kCols;    // 64 segments

__device__ __forceinline__ int smem_index(int row, int col) {
  return (row / kSegRows) * kSegStride + (row % kSegRows) * kCols + col;
}

// Stage rows [row0, row0 + 512) of x (zeros past `rows`) in shared memory.
__device__ __forceinline__ void load_tile(const float* __restrict__ x,
                                          int rows, int row0, float* tile) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  for (int f = threadIdx.x; f < kBlockRows * kCols / 4; f += kThreads) {
    const int r = f / (kCols / 4);
    const int cg = f % (kCols / 4);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < rows) {
      v = x4[static_cast<size_t>(row0 + r) * (kCols / 4) + cg];
    }
    *reinterpret_cast<float4*>(tile + smem_index(r, 4 * cg)) = v;
  }
}

__global__ void __launch_bounds__(kThreads) block_sums_kernel(
    const float* __restrict__ x, int rows, double* __restrict__ sums) {
  __shared__ __align__(16) float tile[kSegs * kSegStride];
  __shared__ float seg_tot[kSegs][kCols];
  load_tile(x, rows, blockIdx.x * kBlockRows, tile);
  __syncthreads();
  const int c = threadIdx.x % kCols;
  const int s = threadIdx.x / kCols;
  float acc = 0.0f;
  for (int j = 0; j < kSegRows; ++j) {
    acc += tile[smem_index(s * kSegRows + j, c)];
  }
  seg_tot[s][c] = acc;
  __syncthreads();
  if (s == 0) {
    double tot = 0.0;
    for (int v = 0; v < kSegs; ++v) tot += seg_tot[v][c];
    sums[static_cast<size_t>(blockIdx.x) * kCols + c] = tot;
  }
}

// One block: sums[nblk, 16] -> exclusive prefix over blocks, in place.
__global__ void __launch_bounds__(kScanThreads) scan_block_sums_kernel(
    double* __restrict__ sums, int nblk) {
  __shared__ double seg_tot[kScanSegs][kCols];
  const int c = threadIdx.x % kCols;
  const int s = threadIdx.x / kCols;
  const int per = (nblk + kScanSegs - 1) / kScanSegs;
  const int k0 = min(s * per, nblk);
  const int k1 = min(k0 + per, nblk);
  double acc = 0.0;
  for (int k = k0; k < k1; ++k) acc += sums[static_cast<size_t>(k) * kCols + c];
  seg_tot[s][c] = acc;
  __syncthreads();
  double run = 0.0;
  for (int v = 0; v < s; ++v) run += seg_tot[v][c];
  for (int k = k0; k < k1; ++k) {
    const size_t o = static_cast<size_t>(k) * kCols + c;
    const double val = sums[o];
    sums[o] = run;
    run += val;
  }
}

__global__ void __launch_bounds__(kThreads) scan_blocks_kernel(
    const float* __restrict__ x, int rows,
    const double* __restrict__ offsets, float* __restrict__ out) {
  __shared__ __align__(16) float tile[kSegs * kSegStride];
  __shared__ float seg_tot[kSegs][kCols];
  const int row0 = blockIdx.x * kBlockRows;
  load_tile(x, rows, row0, tile);
  __syncthreads();
  const int c = threadIdx.x % kCols;
  const int s = threadIdx.x / kCols;
  float acc = 0.0f;
  for (int j = 0; j < kSegRows; ++j) {
    const int i = smem_index(s * kSegRows + j, c);
    acc += tile[i];
    tile[i] = acc;
  }
  seg_tot[s][c] = acc;
  __syncthreads();
  double off = offsets[static_cast<size_t>(blockIdx.x) * kCols + c];
  for (int v = 0; v < s; ++v) off += seg_tot[v][c];
  const float off32 = static_cast<float>(off);
  for (int j = 0; j < kSegRows; ++j) {
    tile[smem_index(s * kSegRows + j, c)] += off32;
  }
  __syncthreads();
  float4* out4 = reinterpret_cast<float4*>(out);
  for (int f = threadIdx.x; f < kBlockRows * kCols / 4; f += kThreads) {
    const int r = f / (kCols / 4);
    const int cg = f % (kCols / 4);
    if (row0 + r < rows) {
      out4[static_cast<size_t>(row0 + r) * (kCols / 4) + cg] =
          *reinterpret_cast<const float4*>(tile + smem_index(r, 4 * cg));
    }
  }
}

}  // namespace

// x, out: [rows, 16] f32, 16-byte aligned; block_sums: scratch of
// scratch_rows x 16 f64, at least ceil(rows / 512) rows (else
// cudaErrorInvalidValue, and nothing is launched).
extern "C" int gsplat_cumsum_rows(const void* x, int rows, void* block_sums,
                                  int scratch_rows, void* out, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const int nblk = (rows + kBlockRows - 1) / kBlockRows;
  if (scratch_rows < nblk) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* sums = static_cast<double*>(block_sums);
  block_sums_kernel<<<nblk, kThreads, 0, st>>>(static_cast<const float*>(x),
                                               rows, sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_block_sums_kernel<<<1, kScanThreads, 0, st>>>(sums, nblk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_blocks_kernel<<<nblk, kThreads, 0, st>>>(
      static_cast<const float*>(x), rows, sums, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
