// The gradient fold's boundary gathers: each gaussian's sum over its
// enumeration range [start, start + cnt) from the inclusive prefix sum cs
// [rows, 16] f32 that kernel B3 (csrc/cumsum_rows.cu) leaves:
//
//   out[g] = cnt > 0 ? cs[clamp(start + cnt - 1, 0, rows - 1)]
//                      - (start > 0 ? cs[start - 1] : 0) : 0
//
// Replaces XLA glue, not a Pallas kernel: the two row gathers, the
// subtraction and the selects of gsplat_tpu/render/api.py:156-160, which
// the JAX package leaves to XLA around B3. The plain version is
// render/api.py::_segment_sums_plain; this kernel does the same f32
// subtraction (hi - 0 where start is 0), so the two agree bit for bit.
//
// Bound on the card: bytes. Each gaussian reads its start and count (8
// bytes) and writes a 64-byte row; one with cnt > 0 reads its hi row and,
// past the first slot, its lo row (64 bytes each; a lo row is its
// predecessor's hi row, so distinct rows are read once at best). Design:
// one thread a (gaussian, 4-column group), 16-byte loads and stores, so the
// four threads of a gaussian read its 64-byte rows whole and a warp writes
// 512 contiguous bytes; start and count are read as int32 directly, and a
// gaussian with no slot reads no row.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) fold_segments_kernel(
    const float4* __restrict__ cs, int rows,
    const int* __restrict__ start, const int* __restrict__ cnt, int n,
    float4* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= 4 * n) return;
  const int g = t >> 2;
  const int q = t & 3;
  const long long s = __ldg(start + g);
  const long long k = __ldg(cnt + g);
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (k > 0) {
    const long long hi = min(max(s + k - 1, 0LL), rows - 1LL);
    const float4 h = __ldg(cs + hi * 4 + q);
    float4 l = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (s > 0) l = __ldg(cs + min(s - 1, rows - 1LL) * 4 + q);
    v = make_float4(h.x - l.x, h.y - l.y, h.z - l.z, h.w - l.w);
  }
  out[t] = v;
}

}  // namespace

// cs: [rows, 16] f32, 16-byte aligned, rows >= 1; start, cnt: [n] i32;
// out: [n, 16] f32, 16-byte aligned; 4 n < 2^31.
extern "C" int gsplat_fold_segments(const void* cs, int rows,
                                    const void* start, const void* cnt, int n,
                                    void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((4LL * n + kThreads - 1) / kThreads);
  fold_segments_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(cs), rows, static_cast<const int*>(start),
      static_cast<const int*>(cnt), n, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
