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
// order, one f32 rounding each, so the two agree bit for bit: -fmad=false
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

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;         // gaussians and threads a block
constexpr int kPitch = kThreads + 1;  // odd: column reads hit 32 banks
constexpr int kFields = 14;           // f32 output rows

// Python's SH constants (render/sh.py) as PyTorch passes them: the f32 of
// the double (a float literal would round the decimal once, not twice).
#define F32(x) static_cast<float>(x)
constexpr float kC0 = F32(0.28209479177387814);
constexpr float kC1 = F32(0.4886025119029199);
constexpr float kC2_0 = F32(1.0925484305920792);
constexpr float kC2_1 = F32(-1.0925484305920792);
constexpr float kC2_2 = F32(0.31539156525252005);
constexpr float kC2_3 = F32(-1.0925484305920792);
constexpr float kC2_4 = F32(0.5462742152960396);
constexpr float kC3_0 = F32(-0.5900435899266435);
constexpr float kC3_1 = F32(2.890611442640554);
constexpr float kC3_2 = F32(-0.4570457994644658);
constexpr float kC3_3 = F32(0.3731763325901154);
constexpr float kC3_4 = F32(-0.4570457994644658);
constexpr float kC3_5 = F32(1.445305721320277);
constexpr float kC3_6 = F32(-0.5900435899266435);
constexpr float kNormFloor = F32(1e-12);
#undef F32

// torch.clamp_min / clamp_max with a scalar on the card: NaN passes.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

// Rows [first, first + count) of an [N, R] f32 array into dst, transposed:
// element j of row first + g at dst[j * kPitch + g].
template <int R>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      long long first, int count,
                                      float* __restrict__ dst) {
  const float* base = src + first * R;
  const int t = threadIdx.x;
  if (count == kThreads &&
      (reinterpret_cast<uintptr_t>(base) & 15) == 0) {
    // kThreads * R / 4 float4s, loaded before any is stored
    constexpr int kVec = kThreads * R / 4;
    constexpr int kPer = (kVec + kThreads - 1) / kThreads;
    const float4* b4 = reinterpret_cast<const float4*>(base);
    float4 v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = t + k * kThreads;
      if (i < kVec) v[k] = __ldg(b4 + i);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = t + k * kThreads;
      if (i < kVec) {
        const float e[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int f = 4 * i + c;
          dst[(f % R) * kPitch + f / R] = e[c];
        }
      }
    }
  } else {
    for (int f = t; f < count * R; f += kThreads)
      dst[(f % R) * kPitch + f / R] = __ldg(base + f);
  }
}

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

  // camera: R, its position and the translation -(R @ pos), written out
  float r[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) r[k] = __ldg(rot + k);
  const float p0 = __ldg(pos), p1 = __ldg(pos + 1), p2 = __ldg(pos + 2);
  const float fx = __ldg(fx_p), fy = __ldg(fy_p);
  const float tr0 = -((r[0] * p0 + r[1] * p1) + r[2] * p2);
  const float tr1 = -((r[3] * p0 + r[4] * p1) + r[5] * p2);
  const float tr2 = -((r[6] * p0 + r[7] * p1) + r[8] * p2);

  const float mx = s_means[g], my = s_means[kPitch + g],
              mz = s_means[2 * kPitch + g];
  const float pcx = ((r[0] * mx + r[1] * my) + r[2] * mz) + tr0;
  const float pcy = ((r[3] * mx + r[4] * my) + r[5] * mz) + tr1;
  const float z = ((r[6] * mx + r[7] * my) + r[8] * mz) + tr2;
  bool valid = (z > z_near) && (z < z_far);
  const float zs = valid ? z : 1.0f;
  const float u = fx * pcx / zs + static_cast<float>(width / 2.0);
  const float v = fy * pcy / zs + static_cast<float>(height / 2.0);

  // Sigma3 = R_q diag(exp(2 s)) R_q^T from the normalised quaternion
  const float w0 = s_quats[g], x0 = s_quats[kPitch + g],
              y0 = s_quats[2 * kPitch + g], q0 = s_quats[3 * kPitch + g];
  const float norm = sqrtf((w0 * w0 + y0 * y0) + (x0 * x0 + q0 * q0));
  const float qw = w0 / norm, qx = x0 / norm, qy = y0 / norm,
              qz = q0 / norm;
  const float r00 = 1.0f - 2.0f * (qy * qy + qz * qz);
  const float r01 = 2.0f * (qx * qy - qw * qz);
  const float r02 = 2.0f * (qx * qz + qw * qy);
  const float r10 = 2.0f * (qx * qy + qw * qz);
  const float r11 = 1.0f - 2.0f * (qx * qx + qz * qz);
  const float r12 = 2.0f * (qy * qz - qw * qx);
  const float r20 = 2.0f * (qx * qz - qw * qy);
  const float r21 = 2.0f * (qy * qz + qw * qx);
  const float r22 = 1.0f - 2.0f * (qx * qx + qy * qy);
  const float e0 = expf(2.0f * s_scales[g]);
  const float e1 = expf(2.0f * s_scales[kPitch + g]);
  const float e2 = expf(2.0f * s_scales[2 * kPitch + g]);
  const float s00 = (r00 * e0 * r00 + r01 * e1 * r01) + r02 * e2 * r02;
  const float s01 = (r00 * e0 * r10 + r01 * e1 * r11) + r02 * e2 * r12;
  const float s02 = (r00 * e0 * r20 + r01 * e1 * r21) + r02 * e2 * r22;
  const float s11 = (r10 * e0 * r10 + r11 * e1 * r11) + r12 * e2 * r12;
  const float s12 = (r10 * e0 * r20 + r11 * e1 * r21) + r12 * e2 * r22;
  const float s22 = (r20 * e0 * r20 + r21 * e1 * r21) + r22 * e2 * r22;

  // T = J R, with J the 2x3 perspective Jacobian; Sigma2 = T Sigma3 T^T
  const float inv_z = 1.0f / zs;
  const float inv_z2 = inv_z * inv_z;
  const float f0 = fx * inv_z;
  const float g0 = fx * pcx * inv_z2;
  const float f1 = fy * inv_z;
  const float g1 = fy * pcy * inv_z2;
  const float t00 = f0 * r[0] - g0 * r[6];
  const float t01 = f0 * r[1] - g0 * r[7];
  const float t02 = f0 * r[2] - g0 * r[8];
  const float t10 = f1 * r[3] - g1 * r[6];
  const float t11 = f1 * r[4] - g1 * r[7];
  const float t12 = f1 * r[5] - g1 * r[8];
  const float st00 = (s00 * t00 + s01 * t01) + s02 * t02;
  const float st01 = (s01 * t00 + s11 * t01) + s12 * t02;
  const float st02 = (s02 * t00 + s12 * t01) + s22 * t02;
  const float st10 = (s00 * t10 + s01 * t11) + s02 * t12;
  const float st11 = (s01 * t10 + s11 * t11) + s12 * t12;
  const float st12 = (s02 * t10 + s12 * t11) + s22 * t12;
  const float a = ((t00 * st00 + t01 * st01) + t02 * st02) + blur;
  const float b = (t10 * st00 + t11 * st01) + t12 * st02;
  const float c = ((t10 * st10 + t11 * st11) + t12 * st12) + blur;
  const float det = a * c - b * b;
  valid = valid && (det > 0.0f);
  const float det_safe = det > 0.0f ? det : 1.0f;
  const float inv_det = 1.0f / det_safe;

  const float opacity = 1.0f / (1.0f + expf(-s_opac[g]));
  const float mid = 0.5f * (a + c);
  const float lam1 = mid + sqrtf(clamp_min(mid * mid - det_safe, 0.0f));
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
  const float dx = mx - p0, dy = my - p1, dz = mz - p2;
  const float inv_n = 1.0f / clamp_min(sqrtf((dx * dx + dy * dy) + dz * dz),
                                       kNormFloor);
  const float x = dx * inv_n, y = dy * inv_n, zd = dz * inv_n;
  const float xx = x * x, yy = y * y, zz = zd * zd;
  const float xy = x * y, yz = y * zd, xz = x * zd;
  float rgb[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float* s = s_sh + ch * kPitch + g;  // coefficient k at 3 k kPitch
    float col = kC0 * s[0];
    if (K > 1 && bands >= 1) {
      col = ((col - kC1 * y * s[3 * kPitch]) + kC1 * zd * s[6 * kPitch])
            - kC1 * x * s[9 * kPitch];
    }
    if (K > 4 && bands >= 2) {
      col = ((((col + kC2_0 * xy * s[12 * kPitch])
               + kC2_1 * yz * s[15 * kPitch])
              + kC2_2 * (2.0f * zz - xx - yy) * s[18 * kPitch])
             + kC2_3 * xz * s[21 * kPitch])
            + kC2_4 * (xx - yy) * s[24 * kPitch];
    }
    if (K > 9 && bands >= 3) {
      col = ((((((col + kC3_0 * y * (3.0f * xx - yy) * s[27 * kPitch])
                 + kC3_1 * xy * zd * s[30 * kPitch])
                + kC3_2 * y * (4.0f * zz - xx - yy) * s[33 * kPitch])
               + kC3_3 * zd * (2.0f * zz - 3.0f * xx - 3.0f * yy)
                     * s[36 * kPitch])
              + kC3_4 * x * (4.0f * zz - xx - yy) * s[39 * kPitch])
             + kC3_5 * zd * (xx - yy) * s[42 * kPitch])
            + kC3_6 * x * (xx - 3.0f * yy) * s[45 * kPitch];
    }
    rgb[ch] = clamp_min(col + 0.5f, 0.0f);
  }

  // the fields of render/projection.py::Projected, in its order
  const float vals[kFields] = {
      u, v, c * inv_det, -b * inv_det, a * inv_det, z,
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
