// Kernels P2: inclusive scans down the 64 rows of an f32 [64, P] array, by
// product or by sum, in two variants, and the four scan rounds of the TPU
// probe.
//
// Replaces: scripts/profile_scan_variants.py (Pallas): k_prod / k_sum
// (scan_grouped in interpret mode) and kernel(which) (four rounds of
// acc <- cumsum(cumprod(acc)) 1e-6 + x with scan_flat or scan_grouped, on
// a grid of 1024 steps over one [64, 1024] block that stays in VMEM, since
// its index map is constant).
//
// Bound on the card: operations. A scan needs one combine an element and a
// round's update one FMA; the block is read once and written once.
//
// Design: one column a thread, its 64 rows in registers, so a warp's load
// or store of a row is one coalesced 128-byte access and a scan needs no
// shuffle, no shared memory and no barrier. As the TPU's VMEM block did,
// the tile stays on chip across the passes: a block loads its columns
// once, runs its share of the `reps` passes in registers and writes once.
// The grid is column blocks x pass slices, as many slices as fill the
// card's resident blocks (never more than `reps`); a slice runs
// floor(reps / S) or ceil(reps / S) passes and every slice writes the same
// bits. Each pass starts from the last pass's input less
// eps * min(|last output|, FLT_MAX), with eps a kernel argument the host
// passes as +0: that subtracts +0, which leaves every float as it is, but
// the compiler cannot know it, so it can neither hoist nor collapse the
// passes and the result stays one pass's, bit for bit.
// - flat: scan_flat's log steps k = 1, 2, ..., 32 over the 64 rows, row r
//   combining row r - k (in place, rows in descending order): 321 combines
//   a column a scan, in the TPU's association.
// - grouped: each 8-row group scanned in sequence (ILP 8 across the
//   groups), the group totals combined in order, that exclusive prefix
//   spread over groups 1-7: 118 combines a column, in the plain version's
//   order (gsplat_tpu_torch/utils/scan_probe.py).
// Combines are IEEE products and sums; built with -fmad=false, the round's
// update is one multiply and one add, as in the plain version.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;
constexpr int kLogRows = 6;
constexpr int kGroup = 8;
constexpr int kRounds = 4;
constexpr int kThreads = 128;  // one column a thread
constexpr int kMinBlocks = 3;  // at most 168 registers a thread: 0 spills

enum Variant { kFlat = 0, kGrouped = 1 };
enum Mode { kProd = 0, kSum = 1, kRoundsMode = 2 };

template <int Op>
__device__ __forceinline__ float combine(float a, float b) {
  return Op == kProd ? a * b : a + b;
}

// Both loops have trip counts nvcc can see (steps, not k = 1, 2, 4, ...;
// every row, not rows >= k), so it unrolls both, every index is a constant
// and v stays in registers.
template <int Op>
__device__ __forceinline__ void flat_scan(float (&v)[kRows]) {
#pragma unroll
  for (int step = 0; step < kLogRows; ++step) {
    const int k = 1 << step;
#pragma unroll
    for (int r = kRows - 1; r > 0; --r) {
      if (r >= k) v[r] = combine<Op>(v[r], v[r - k]);
    }
  }
}

template <int Op>
__device__ __forceinline__ void grouped_scan(float (&v)[kRows]) {
#pragma unroll
  for (int r = 1; r < kRows; ++r) {
    if (r % kGroup != 0) v[r] = combine<Op>(v[r], v[r - 1]);
  }
  float e = v[kGroup - 1];
#pragma unroll
  for (int g = 1; g < kRows / kGroup; ++g) {
    const float total = v[g * kGroup + kGroup - 1];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      v[g * kGroup + j] = combine<Op>(v[g * kGroup + j], e);
    }
    if (g + 1 < kRows / kGroup) e = combine<Op>(e, total);
  }
}

template <int V, int Op>
__device__ __forceinline__ void scan(float (&v)[kRows]) {
  if (V == kFlat) {
    flat_scan<Op>(v);
  } else {
    grouped_scan<Op>(v);
  }
}

template <int V, int M>
__global__ void __launch_bounds__(kThreads, kMinBlocks) scan_kernel(
    const float* __restrict__ x, int p, float* __restrict__ out, int reps,
    float eps) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  const int slices = gridDim.y;
  const int slice = blockIdx.y;
  const int passes = reps / slices + (slice < reps % slices ? 1 : 0);
  if (col >= p || passes == 0) return;
  float xv[kRows], v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) xv[r] = x[static_cast<size_t>(r) * p + col];
#pragma unroll 1
  for (int pass = 0; pass < passes; ++pass) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] = xv[r];
    if (M == kRoundsMode) {
#pragma unroll 1
      for (int round = 0; round < kRounds; ++round) {
        scan<V, kProd>(v);
        scan<V, kSum>(v);
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[r] = v[r] * 1e-6f + xv[r];
      }
    } else {
      scan<V, M>(v);
    }
    // carry this pass into the next: c is +0 when eps is, and x - (+0) is x
    const float c = eps * fminf(fabsf(v[kRows - 1]), FLT_MAX);
#pragma unroll
    for (int r = 0; r < kRows; ++r) xv[r] -= c;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[static_cast<size_t>(r) * p + col] = v[r];
}

template <int V, int M>
int launch(const float* x, int p, float* out, int reps, cudaStream_t st) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scan_kernel<V, M>, kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int col_blocks = (p + kThreads - 1) / kThreads;
  int slices = sms * per_sm / col_blocks;
  slices = slices < 1 ? 1 : (slices > reps ? reps : slices);
  scan_kernel<V, M><<<dim3(col_blocks, slices), kThreads, 0, st>>>(
      x, p, out, reps, 0.0f);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_mode(int mode, const float* x, int p, float* out, int reps,
                cudaStream_t st) {
  if (mode == kProd) return launch<V, kProd>(x, p, out, reps, st);
  if (mode == kSum) return launch<V, kSum>(x, p, out, reps, st);
  return launch<V, kRoundsMode>(x, p, out, reps, st);
}

}  // namespace

// variant: 0 = flat, 1 = grouped; mode: 0 = product scan, 1 = sum scan,
// 2 = the four rounds. x, out: [64, p] f32, row-major. reps >= 1 passes
// over the whole array, the output one pass's. Anything else:
// cudaErrorInvalidValue, and nothing is launched.
extern "C" int gsplat_scan_probe(int variant, int mode, const void* x, int p,
                                 void* out, int reps, void* stream) {
  if ((variant != kFlat && variant != kGrouped) || mode < kProd ||
      mode > kRoundsMode || p < 1 || reps < 1 || reps > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (variant == kFlat) return launch_mode<kFlat>(mode, xf, p, of, reps, st);
  return launch_mode<kGrouped>(mode, xf, p, of, reps, st);
}
