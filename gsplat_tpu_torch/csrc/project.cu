// The projection stage: every gaussian projected into one camera and its
// SH colour evaluated, the whole of render/projection.py::_project_plain
// (with render/sh.py::eval_sh_soa) in one launch.
//
// Replaces XLA glue, not a Pallas kernel: the JAX package leaves its
// projection and SH (gsplat_tpu/render/projection.py::project,
// gsplat_tpu/render/sh.py::eval_sh_soa) to XLA, as it left the fold's
// gathers (csrc/fold_segments.cu). The plain version dispatches each
// elementwise operation as a kernel of its own, ~510 launches a view at
// SH degree 3. This kernel keeps the plain version's operations and their
// order, one f32 rounding each (the per-gaussian arithmetic lives in
// project.cuh, shared with the backward kernel project_bwd.cu, which
// recomputes the same values), so the two agree bit for bit: -fmad=false
// (no a*b+c contraction), IEEE division and sqrtf, full-precision expf and
// logf, and the rounding of PyTorch's CUDA operators where it differs from
// the written formula (PyTorch 2.11): sigmoid is 1 / (1 + exp(-x)); x / s
// for a Python scalar s is x * f32(1 / s), the reciprocal taken in double
// (the wrapper passes it); a Python scalar enters as f32; the quaternion's
// norm sums its squares as (w^2 + y^2) + (x^2 + z^2), the order in which
// torch.linalg.vector_norm's reduction adds its four lanes.
//
// Bound on the card: bytes. At SH degree 3 each gaussian reads 236 bytes
// (means 12, log-scales 12, quaternion 16, opacity 4, SH 192) and writes 57
// (14 f32 fields and valid); its few hundred f32 operations, four expf
// and a logf are far below the card's rates. Design: one thread a gaussian,
// 128 a block. The block copies its gaussians' rows of each input (an
// [N, R] array holds them contiguously) into shared memory with 16-byte
// loads, all of a field's loads in flight before any store, and transposes
// them on the way (column j of the block's rows at j * kPitch), so no warp
// reads global memory with a stride and each thread then reads its own
// values from shared memory without bank conflicts. Rows that do not start
// on 16 bytes (a scene sliced at an odd row) and the last, partial block
// take 4-byte loads, still coalesced. Each output field is a row of one
// [14, N] array, stored coalesced along N.

#include <cuda_runtime.h>

#include "project.cuh"

namespace {

using namespace proj;

constexpr int kFields = 14;           // f32 output rows

template <int K>
__global__ void __launch_bounds__(kThreads) project_kernel(
    const float* __restrict__ means, const float* __restrict__ log_scales,
    const float* __restrict__ quats, const float* __restrict__ opacities,
    const float* __restrict__ sh, int n, int bands,
    const float* __restrict__ rot, const float* __restrict__ pos,
    const float* __restrict__ fx_p, const float* __restrict__ fy_p,
    int width, int height, float z_near, float z_far, float blur,
    float alpha_min, float inv_alpha_min, float sigma_cutoff,
    float* __restrict__ out, bool* __restrict__ valid_out) {
  __shared__ float s_means[3 * kPitch];
  __shared__ float s_scales[3 * kPitch];
  __shared__ float s_quats[4 * kPitch];
  __shared__ float s_opac[kPitch];
  __shared__ float s_sh[3 * K * kPitch];

  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const int count = static_cast<int>(min(static_cast<long long>(kThreads),
                                         n - first));
  stage<3>(means, first, count, s_means);
  stage<3>(log_scales, first, count, s_scales);
  stage<4>(quats, first, count, s_quats);
  stage<1>(opacities, first, count, s_opac);
  stage<3 * K>(sh, first, count, s_sh);
  __syncthreads();
  const int g = threadIdx.x;
  if (g >= count) return;
  const long long i = first + g;

  const Camera cam = load_camera(rot, pos, fx_p, fy_p);
  const float mx = s_means[g], my = s_means[kPitch + g],
              mz = s_means[2 * kPitch + g];
  const Geometry G = geometry(
      cam, mx, my, mz, s_scales[g], s_scales[kPitch + g],
      s_scales[2 * kPitch + g], s_quats[g], s_quats[kPitch + g],
      s_quats[2 * kPitch + g], s_quats[3 * kPitch + g], blur, z_near, z_far);
  bool valid = G.in_depth;
  const float u = cam.fx * G.pcx / G.zs + static_cast<float>(width / 2.0);
  const float v = cam.fy * G.pcy / G.zs + static_cast<float>(height / 2.0);
  const float a = G.a, b = G.b, c = G.c;
  valid = valid && (G.det > 0.0f);

  const float opacity = 1.0f / (1.0f + expf(-s_opac[g]));
  const float mid = 0.5f * (a + c);
  const float lam1 = mid + sqrtf(clamp_min(mid * mid - G.det_safe, 0.0f));
  // opacity-aware cutoff: alpha >= alpha_min is impossible beyond
  // sqrt(2 ln(opacity / alpha_min)) sigmas
  float cutoff = sqrtf(2.0f * logf(clamp_min(opacity * inv_alpha_min,
                                             1.0f)));
  cutoff = clamp_max(cutoff, sigma_cutoff);
  const float ex = cutoff * sqrtf(clamp_min(a, 0.0f));
  const float ey = cutoff * sqrtf(clamp_min(c, 0.0f));
  valid = valid && (opacity >= alpha_min);
  valid = valid && (u + ex > 0.0f) && (u - ex < static_cast<float>(width));
  valid = valid && (v + ey > 0.0f) && (v - ey < static_cast<float>(height));

  // SH colour along the unit view direction (1e-12 floor on its length)
  const Direction d = direction(cam, mx, my, mz);
  float rgb[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    rgb[ch] = clamp_min(sh_colour<K>(s_sh + ch * kPitch + g, bands, d), 0.0f);

  // the fields of render/projection.py::Projected, in its order
  const float vals[kFields] = {
      u, v, c * G.inv_det, -b * G.inv_det, a * G.inv_det, G.z,
      cutoff * sqrtf(clamp_min(lam1, 0.0f)), ex, ey, cutoff * cutoff,
      rgb[0], rgb[1], rgb[2], opacity};
#pragma unroll
  for (int f = 0; f < kFields; ++f) out[f * static_cast<long long>(n) + i] =
      vals[f];
  valid_out[i] = valid;
}

template <int K>
cudaError_t launch(const void* means, const void* log_scales,
                   const void* quats, const void* opacities, const void* sh,
                   int n, int bands, const void* rot, const void* pos,
                   const void* fx, const void* fy, int width, int height,
                   float z_near, float z_far, float blur, float alpha_min,
                   float inv_alpha_min, float sigma_cutoff, void* out,
                   void* valid, cudaStream_t stream) {
  const int blocks = static_cast<int>((n + kThreads - 1LL) / kThreads);
  project_kernel<K><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(means), static_cast<const float*>(log_scales),
      static_cast<const float*>(quats), static_cast<const float*>(opacities),
      static_cast<const float*>(sh), n, bands,
      static_cast<const float*>(rot), static_cast<const float*>(pos),
      static_cast<const float*>(fx), static_cast<const float*>(fy), width,
      height, z_near, z_far, blur, alpha_min, inv_alpha_min, sigma_cutoff,
      static_cast<float*>(out), static_cast<bool*>(valid));
  return cudaGetLastError();
}

}  // namespace

// means, log_scales: [n, 3] f32; quats: [n, 4] f32; opacities: [n] f32
// logits; sh: [n, k, 3] f32 with k in {1, 4, 9, 16}, of which the first
// bands (0-3) SH bands are evaluated; rot [3, 3], pos [3], fx [], fy []:
// f32 on the card; inv_alpha_min: f32(1 / alpha_min) of the double;
// out: [14, n] f32 (the fields of Projected but valid, in
// its order); valid: [n] bool. Every array contiguous; 0 < n < 2^31.
extern "C" int gsplat_project(const void* means, const void* log_scales,
                              const void* quats, const void* opacities,
                              const void* sh, int n, int k, int bands,
                              const void* rot, const void* pos,
                              const void* fx, const void* fy, int width,
                              int height, float z_near, float z_far,
                              float blur, float alpha_min,
                              float inv_alpha_min, float sigma_cutoff,
                              void* out, void* valid, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define GSPLAT_PROJECT_CASE(K)                                             \
  case K:                                                                  \
    return static_cast<int>(launch<K>(                                     \
        means, log_scales, quats, opacities, sh, n, bands, rot, pos, fx,  \
        fy, width, height, z_near, z_far, blur, alpha_min, inv_alpha_min, \
        sigma_cutoff, out, valid, s));
    GSPLAT_PROJECT_CASE(1)
    GSPLAT_PROJECT_CASE(4)
    GSPLAT_PROJECT_CASE(9)
    GSPLAT_PROJECT_CASE(16)
#undef GSPLAT_PROJECT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
