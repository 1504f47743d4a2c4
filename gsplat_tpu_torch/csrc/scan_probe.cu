// Kernels P2: inclusive scans down the 64 rows of an f32 [64, P] array, by
// product or by sum, in two variants, and the four scan rounds of the TPU
// probe.
//
// Replaces: scripts/profile_scan_variants.py (Pallas): k_prod / k_sum
// (scan_grouped in interpret mode) and kernel(which) (four rounds of
// acc <- cumsum(cumprod(acc)) 1e-6 + x with scan_flat or scan_grouped, on
// a grid of 1024 steps that re-read one [64, 1024] VMEM block). The TPU
// scans roll whole (64, P) blocks along the sublane axis and mask; here the
// 64-row axis goes across threads and each block owns a tile of 32 columns:
// - flat: a 6-step Kogge-Stone scan. Thread (half h, lane l) holds row
//   32 h + l of 8 columns: five warp-shuffle steps (1, 2, 4, 8, 16) scan
//   each 32-row half, then the upper half combines the lower half's totals
//   (row 31) through shared memory. The tile is staged in shared memory so
//   that the global loads and stores are coalesced.
// - grouped: warp g holds the 8-row group g of 32 columns (lane = column,
//   so the global loads are coalesced): a sequential scan in registers, the
//   8 group totals through shared memory, each warp combining the totals of
//   the groups before it in order, and that prefix spread over its rows.
// Combines are taken in the plain versions' order
// (gsplat_tpu_torch/utils/scan_probe.py), which for flat differs from the
// TPU scan_flat's in the last step only, and for grouped inside the groups.
//
// Bound on the card: operations. A scan needs one combine an element; the
// rounds are compute-bound when `reps` passes re-read one L2-resident
// [64, 1024] input (grid = 32 column tiles x reps), each pass writing the
// same output, as every TPU grid step wrote the same block. The flat scan
// spends five shuffles and five combines an element a scan, grouped about
// two combines.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;
constexpr int kTile = 32;      // columns per block
constexpr int kThreads = 256;  // 8 warps
constexpr int kFlatCols = 8;   // columns per thread in the flat scan
constexpr int kGroup = 8;      // rows per group in the grouped scan
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kProd = 0, kSum = 1, kRounds = 2 };

struct Mul {
  __device__ __forceinline__ static float op(float a, float b) { return a * b; }
};
struct Add {
  __device__ __forceinline__ static float op(float a, float b) { return a + b; }
};

// Flat: v[j] is row 32 h + lane of column 8 q + j; half_tot is scratch
// [4][8] for the lower half's totals.
template <class Op>
__device__ __forceinline__ void flat_scan(float (&v)[kFlatCols], int lane,
                                          int h, int q,
                                          float (*half_tot)[kFlatCols]) {
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
#pragma unroll
    for (int j = 0; j < kFlatCols; ++j) {
      const float o = __shfl_up_sync(kFull, v[j], k);
      if (lane >= k) v[j] = Op::op(v[j], o);
    }
  }
  if (h == 0 && lane == 31) {
#pragma unroll
    for (int j = 0; j < kFlatCols; ++j) half_tot[q][j] = v[j];
  }
  __syncthreads();
  if (h == 1) {
#pragma unroll
    for (int j = 0; j < kFlatCols; ++j) v[j] = Op::op(v[j], half_tot[q][j]);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) scan_flat_kernel(
    const float* __restrict__ x, int p, float* __restrict__ out, int mode) {
  __shared__ float tile[kRows][kTile + 1];
  __shared__ float half_tot[kThreads / 64][kFlatCols];
  const int col0 = blockIdx.x * kTile;
  const int c = threadIdx.x % kTile;
  const bool in = col0 + c < p;
#pragma unroll
  for (int k = 0; k < kRows * kTile / kThreads; ++k) {
    const int r = threadIdx.x / kTile + k * (kThreads / kTile);
    tile[r][c] = in ? x[static_cast<size_t>(r) * p + col0 + c] : 0.0f;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = warp & 1;
  const int q = warp >> 1;
  const int row = h * 32 + lane;
  float v[kFlatCols], x0[kFlatCols];
#pragma unroll
  for (int j = 0; j < kFlatCols; ++j) v[j] = x0[j] = tile[row][q * kFlatCols + j];
  if (mode == kProd) {
    flat_scan<Mul>(v, lane, h, q, half_tot);
  } else if (mode == kSum) {
    flat_scan<Add>(v, lane, h, q, half_tot);
  } else {
    for (int round = 0; round < 4; ++round) {
      flat_scan<Mul>(v, lane, h, q, half_tot);
      flat_scan<Add>(v, lane, h, q, half_tot);
#pragma unroll
      for (int j = 0; j < kFlatCols; ++j) v[j] = v[j] * 1e-6f + x0[j];
    }
  }
#pragma unroll
  for (int j = 0; j < kFlatCols; ++j) tile[row][q * kFlatCols + j] = v[j];
  __syncthreads();
  if (in) {
#pragma unroll
    for (int k = 0; k < kRows * kTile / kThreads; ++k) {
      const int r = threadIdx.x / kTile + k * (kThreads / kTile);
      out[static_cast<size_t>(r) * p + col0 + c] = tile[r][c];
    }
  }
}

// Grouped: v[j] is row 8 g + j of column `lane` of the tile; tot is
// scratch [8][32] for the group totals.
template <class Op>
__device__ __forceinline__ void grouped_scan(float (&v)[kGroup], int lane,
                                             int g, float (*tot)[kTile]) {
#pragma unroll
  for (int j = 1; j < kGroup; ++j) v[j] = Op::op(v[j], v[j - 1]);
  tot[g][lane] = v[kGroup - 1];
  __syncthreads();
  if (g > 0) {
    float e = tot[0][lane];
    for (int k = 1; k < g; ++k) e = Op::op(e, tot[k][lane]);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) v[j] = Op::op(v[j], e);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) scan_grouped_kernel(
    const float* __restrict__ x, int p, float* __restrict__ out, int mode) {
  __shared__ float tot[kRows / kGroup][kTile];
  const int g = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col = blockIdx.x * kTile + lane;
  const bool in = col < p;
  float v[kGroup], x0[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    v[j] = x0[j] = in ? x[static_cast<size_t>(g * kGroup + j) * p + col] : 0.0f;
  }
  if (mode == kProd) {
    grouped_scan<Mul>(v, lane, g, tot);
  } else if (mode == kSum) {
    grouped_scan<Add>(v, lane, g, tot);
  } else {
    for (int round = 0; round < 4; ++round) {
      grouped_scan<Mul>(v, lane, g, tot);
      grouped_scan<Add>(v, lane, g, tot);
#pragma unroll
      for (int j = 0; j < kGroup; ++j) v[j] = v[j] * 1e-6f + x0[j];
    }
  }
  if (in) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      out[static_cast<size_t>(g * kGroup + j) * p + col] = v[j];
    }
  }
}

}  // namespace

// variant: 0 = flat, 1 = grouped; mode: 0 = product scan, 1 = sum scan,
// 2 = the four rounds. x, out: [64, p] f32, row-major. reps >= 1 passes
// over the whole array (grid = ceil(p / 32) x reps), all writing the same
// output. Anything else: cudaErrorInvalidValue, and nothing is launched.
extern "C" int gsplat_scan_probe(int variant, int mode, const void* x, int p,
                                 void* out, int reps, void* stream) {
  if ((variant != 0 && variant != 1) || mode < kProd || mode > kRounds ||
      p < 1 || reps < 1 || reps > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((p + kTile - 1) / kTile, reps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (variant == 0) {
    scan_flat_kernel<<<grid, kThreads, 0, st>>>(xf, p, of, mode);
  } else {
    scan_grouped_kernel<<<grid, kThreads, 0, st>>>(xf, p, of, mode);
  }
  return static_cast<int>(cudaGetLastError());
}
