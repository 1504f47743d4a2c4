// Kernels P1a / P1b: the card-peak probes, an FMA chain and an expf chain.
//
// Replaces: scripts/roofline.py::_fma_kernel and ::_exp_kernel (Pallas,
// launched by _run over a grid of 2048 steps that re-read one [8, 256] VMEM
// block). Per element both do the TPU kernels' work: 8 independent chains
// started at x * (1 + s i), then 48 unrolled steps of c <- c a + b (P1a) or
// 6 unrolled steps of c <- expf(-|c| a) (P1b), and the chains summed in
// order into the output, so no chain is dead code. Here thread t reads
// element t % n of a small input that stays in L1/L2 (the TPU's re-read
// VMEM block) and repeats the unrolled steps `iters` times, carrying the
// chains on; with iters = 1 each output is the TPU kernel's.
//
// What the probes measure, and why each piece is as it is:
// - The FMA chain calls __fmaf_rn: every source is built with -fmad=false,
//   under which c * a + b compiles to FMUL + FADD, two instructions.
// - The exp chain calls IEEE expf under the same flags as the blend kernels
//   (blend_fwd.cu, blend_vis.cu, blend_bwd.cu), so its rate is the rate of the expf
//   those kernels issue: a range reduction, one MUFU.EX2 and fix-ups, not
//   one special-function operation. Each step also takes |c| (an operand
//   modifier) and one FMUL, which the rate's reckoning charges at the FMA
//   rate (gsplat_tpu_torch/utils/roofline.py).
// - a, b and iters are kernel arguments, so the compiler can neither fold
//   the chains nor unroll the outer loop; the output is held against the
//   plain version (utils/roofline.py), so a folded chain cannot pass.
// - Bound on the card: operations. One launch fills every SM (the caller
//   passes blocks = SMs x 8 of 256 threads, 64 warps an SM) and lasts about
//   2 ms; 8 independent chains a thread hide the FMA latency. Besides the
//   chain steps a thread spends 8 FMULs (the starts) and 7 FADDs (the sum)
//   once, under 0.1% of a launch of hundreds of rounds.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;

template <int kWhich>
struct Chain;

// P1a: 48 steps of c <- c a + b, one rounding each; starts x (1 + 1e-6 i).
template <>
struct Chain<0> {
  static constexpr int kSteps = 48;
  static constexpr double kStart = 1e-6;
  __device__ __forceinline__ static float step(float c, float a, float b) {
    return __fmaf_rn(c, a, b);
  }
};

// P1b: 6 steps of c <- expf(-|c| a); starts x (1 + 1e-3 i).
template <>
struct Chain<1> {
  static constexpr int kSteps = 6;
  static constexpr double kStart = 1e-3;
  __device__ __forceinline__ static float step(float c, float a, float) {
    return expf(-fabsf(c) * a);
  }
};

template <int kWhich>
__global__ void __launch_bounds__(kThreads) peak_chain_kernel(
    const float* __restrict__ x, int n, float* __restrict__ out, int iters,
    float a, float b) {
  using C = Chain<kWhich>;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const float xv = x[t % n];
  float c[kChains];
#pragma unroll
  for (int i = 0; i < kChains; ++i) {
    // the TPU kernel's start x * f32(1 + s i), the factor rounded from
    // double as Python rounds the constant
    c[i] = xv * static_cast<float>(1.0 + C::kStart * i);
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < C::kSteps; ++s) {
#pragma unroll
      for (int i = 0; i < kChains; ++i) c[i] = C::step(c[i], a, b);
    }
  }
  float acc = c[0];
#pragma unroll
  for (int i = 1; i < kChains; ++i) acc = acc + c[i];
  out[t] = acc;
}

}  // namespace

// which: 0 = the FMA chain (a, b), 1 = the expf chain (scale a; b unused).
// x: [n] f32; out: [blocks * 256] f32. Anything else, or n, blocks or
// iters below 1: cudaErrorInvalidValue, and nothing is launched.
extern "C" int gsplat_peak_probe(int which, const void* x, int n, void* out,
                                 int blocks, int iters, float a, float b,
                                 void* stream) {
  if ((which != 0 && which != 1) || n < 1 || blocks < 1 || iters < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (which == 0) {
    peak_chain_kernel<0><<<blocks, kThreads, 0, st>>>(xf, n, of, iters, a, b);
  } else {
    peak_chain_kernel<1><<<blocks, kThreads, 0, st>>>(xf, n, of, iters, a, b);
  }
  return static_cast<int>(cudaGetLastError());
}
