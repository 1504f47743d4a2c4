// The gradient fold: each gaussian's sum of its own gradient rows. The
// rows [rows, 16] f32 are in enumeration order, where gaussian g owns the
// consecutive rows [start[g], start[g] + cnt[g]); out[g] is their sum in
// one fixed order, and 0 where cnt[g] is 0:
//
//   the segment is cut into chunks of kChunk rows from its first row; a
//   chunk's sum runs left to right from its first row, and the segment's
//   sum runs left to right over its chunks' sums from the first.
//
// Replaces XLA glue, not a Pallas kernel: the fold of
// gsplat_tpu/render/api.py:148-161, which takes each segment's sum as the
// difference of two rows of one prefix sum over all rows (kernel B3 and
// the boundary gathers of csrc/fold_segments.cu in this port). That
// difference carries an ulp of the running sum, which reaches 1e6 at a
// real frame's size, so a gaussian whose rows are all 0 came out at
// +-0.06..0.5 and Adam moved it a whole step. Summed on its own, a
// segment's error grows with its own rows only, and all-zero rows give 0.
// The plain version is render/api.py::_fold_rows_plain, which adds in the
// same order, so the two agree bit for bit (one f32 rounding per add; no
// FMA is involved), and the order does not depend on the launch, so the
// result is the same from run to run.
//
// Bound on the card: bytes. Each gaussian reads its start and count (8
// bytes) and writes a 64-byte row, and every row of the input is read once
// (64 bytes). Design: a block of 256 threads takes 64 consecutive
// gaussians; four threads (a quad) hold a row's 16 columns as four 16-byte
// float4s. The block scans its gaussians' chunk counts, and in rounds of
// kSlots chunks every quad sums chunks of any of its gaussians into shared
// memory, after which each gaussian's own quad adds its chunks' sums in
// order. So a gaussian of 1e5 rows is shared by the block's 64 quads, not
// walked by one; most gaussians hold one chunk and take one round.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGauss = kThreads / 4;   // gaussians a block, one quad each
constexpr int kChunk = 32;             // rows a chunk
constexpr int kSlots = 256;            // chunk sums a round holds

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__global__ void __launch_bounds__(kThreads) fold_rows_kernel(
    const float4* __restrict__ rows, const int* __restrict__ start,
    const int* __restrict__ cnt, int n, float4* __restrict__ out) {
  __shared__ int s_start[kGauss];
  __shared__ int s_cnt[kGauss];
  __shared__ int s_off[kGauss + 1];    // exclusive scan of chunk counts
  __shared__ float4 s_sum[kSlots * 4];

  const int tid = threadIdx.x;
  const int quad = tid >> 2;
  const int q = tid & 3;
  const int g0 = blockIdx.x * kGauss;
  if (tid < 32) {
    // lane l scans gaussians 2l and 2l + 1
    int c[2];
    for (int h = 0; h < 2; ++h) {
      const int i = 2 * tid + h;
      const int g = g0 + i;
      const int k = g < n ? __ldg(cnt + g) : 0;
      s_start[i] = g < n ? __ldg(start + g) : 0;
      s_cnt[i] = k;
      c[h] = (k + kChunk - 1) / kChunk;
    }
    int incl = c[0] + c[1];
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (tid >= d) incl += v;
    }
    const int excl = incl - c[0] - c[1];
    s_off[2 * tid] = excl;
    s_off[2 * tid + 1] = excl + c[0];
    if (tid == 31) s_off[kGauss] = incl;
  }
  __syncthreads();

  const int total = s_off[kGauss];
  const int own_lo = s_off[quad];
  const int own_hi = s_off[quad + 1];
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  bool have = false;
  for (int base = 0; base < total; base += kSlots) {
    const int m = min(kSlots, total - base);
    for (int c = quad; c < m; c += kGauss) {
      const int k = base + c;
      // the gaussian of chunk k: the last i with s_off[i] <= k, which owns
      // at least one chunk
      int lo = 0, hi = kGauss;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (s_off[mid] <= k) lo = mid; else hi = mid;
      }
      const int j = k - s_off[lo];
      const long long r0 =
          static_cast<long long>(s_start[lo]) + static_cast<long long>(j) *
          kChunk;
      const int len = min(kChunk, s_cnt[lo] - j * kChunk);
      const float4* p = rows + r0 * 4 + q;
      float4 s = __ldg(p);
#pragma unroll 4
      for (int t = 1; t < len; ++t) add4(s, __ldg(p + 4LL * t));
      s_sum[c * 4 + q] = s;
    }
    __syncthreads();
    const int a = max(own_lo, base);
    const int b = min(own_hi, base + m);
    for (int k = a; k < b; ++k) {
      const float4 v = s_sum[(k - base) * 4 + q];
      if (have) {
        add4(acc, v);
      } else {
        acc = v;
        have = true;
      }
    }
    __syncthreads();
  }
  const int g = g0 + quad;
  if (g < n) out[static_cast<long long>(g) * 4 + q] = acc;
}

}  // namespace

// rows: [nrows, 16] f32, 16-byte aligned, every start + cnt <= nrows;
// start, cnt: [n] i32; out: [n, 16] f32, 16-byte aligned.
extern "C" int gsplat_fold_rows(const void* rows, int nrows,
                                const void* start, const void* cnt, int n,
                                void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (nrows < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kGauss - 1) / kGauss;
  fold_rows_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(rows), static_cast<const int*>(start),
      static_cast<const int*>(cnt), n, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
