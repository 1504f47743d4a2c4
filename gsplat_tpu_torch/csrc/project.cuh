// The projection's per-gaussian arithmetic, shared by its forward kernel
// (project.cu) and its backward kernel (project_bwd.cu), with the two
// kernels' block layout: one thread a gaussian, kThreads a block, each input
// row staged through shared memory transposed.
//
// Every function keeps the operations of render/projection.py::_project_plain
// (and render/sh.py::eval_sh_soa) and their order, one f32 rounding each, so
// the forward equals the plain code bit for bit and the backward recomputes
// exactly the values the forward used: -fmad=false (no a*b+c contraction),
// IEEE division and sqrtf, full-precision expf, and the rounding of PyTorch's
// CUDA operators where it differs from the written formula (PyTorch 2.11): a
// Python scalar enters as f32; the quaternion's norm sums its squares as
// (w^2 + y^2) + (x^2 + z^2), the order in which torch.linalg.vector_norm's
// reduction adds its four lanes.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace proj {

constexpr int kThreads = 128;         // gaussians and threads a block
constexpr int kPitch = kThreads + 1;  // odd: column reads hit 32 banks

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
// element j of row first + g at dst[j * kPitch + g]. With kLive, only the
// pieces that hold a row g with live[g] are read (the others are left as
// they are): a 16-byte piece spans at most the rows of its four floats.
template <int R, bool kLive = false>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      long long first, int count,
                                      float* __restrict__ dst,
                                      const bool* live = nullptr) {
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
      bool want = i < kVec;
      if (kLive && want) {
        want = false;
        for (int r = 4 * i / R; r <= (4 * i + 3) / R; ++r) want |= live[r];
      }
      if (want) v[k] = __ldg(b4 + i);
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
      if (!kLive || live[f / R]) dst[(f % R) * kPitch + f / R] = __ldg(base + f);
  }
}

// The camera: R, its position, the focal lengths and the translation
// -(R @ pos), written out.
struct Camera {
  float r[9];
  float p0, p1, p2, fx, fy, tr0, tr1, tr2;
};

__device__ __forceinline__ Camera load_camera(const float* __restrict__ rot,
                                              const float* __restrict__ pos,
                                              const float* __restrict__ fx_p,
                                              const float* __restrict__ fy_p) {
  Camera c;
#pragma unroll
  for (int k = 0; k < 9; ++k) c.r[k] = __ldg(rot + k);
  c.p0 = __ldg(pos);
  c.p1 = __ldg(pos + 1);
  c.p2 = __ldg(pos + 2);
  c.fx = __ldg(fx_p);
  c.fy = __ldg(fy_p);
  c.tr0 = -((c.r[0] * c.p0 + c.r[1] * c.p1) + c.r[2] * c.p2);
  c.tr1 = -((c.r[3] * c.p0 + c.r[4] * c.p1) + c.r[5] * c.p2);
  c.tr2 = -((c.r[6] * c.p0 + c.r[7] * c.p1) + c.r[8] * c.p2);
  return c;
}

// A gaussian's camera-space mean, its Sigma3 = R_q diag(exp(2 s)) R_q^T
// from the normalised quaternion, the perspective Jacobian's rows T = J R
// and Sigma2 = T Sigma3 T^T + blur, with what the backward reads of each.
struct Geometry {
  float pcx, pcy, z, zs;
  bool in_depth;                 // z_near < z < z_far
  float norm, qw, qx, qy, qz;    // the quaternion's norm, the unit quaternion
  float rq[9];                   // R_q, row-major
  float e0, e1, e2;              // exp(2 s)
  float s00, s01, s02, s11, s12, s22;
  float inv_z, inv_z2, f0, g0, f1, g1;
  float t00, t01, t02, t10, t11, t12;
  float st00, st01, st02, st10, st11, st12;   // Sigma3 T^T's columns
  float a, b, c, det, det_safe, inv_det;
};

__device__ __forceinline__ Geometry geometry(const Camera& cam, float mx,
                                             float my, float mz, float ls0,
                                             float ls1, float ls2, float w0,
                                             float x0, float y0, float q0,
                                             float blur, float z_near,
                                             float z_far) {
  const float* r = cam.r;
  Geometry G;
  G.pcx = ((r[0] * mx + r[1] * my) + r[2] * mz) + cam.tr0;
  G.pcy = ((r[3] * mx + r[4] * my) + r[5] * mz) + cam.tr1;
  G.z = ((r[6] * mx + r[7] * my) + r[8] * mz) + cam.tr2;
  G.in_depth = (G.z > z_near) && (G.z < z_far);
  G.zs = G.in_depth ? G.z : 1.0f;

  G.norm = sqrtf((w0 * w0 + y0 * y0) + (x0 * x0 + q0 * q0));
  const float qw = w0 / G.norm, qx = x0 / G.norm, qy = y0 / G.norm,
              qz = q0 / G.norm;
  G.qw = qw;
  G.qx = qx;
  G.qy = qy;
  G.qz = qz;
  float* R = G.rq;
  R[0] = 1.0f - 2.0f * (qy * qy + qz * qz);
  R[1] = 2.0f * (qx * qy - qw * qz);
  R[2] = 2.0f * (qx * qz + qw * qy);
  R[3] = 2.0f * (qx * qy + qw * qz);
  R[4] = 1.0f - 2.0f * (qx * qx + qz * qz);
  R[5] = 2.0f * (qy * qz - qw * qx);
  R[6] = 2.0f * (qx * qz - qw * qy);
  R[7] = 2.0f * (qy * qz + qw * qx);
  R[8] = 1.0f - 2.0f * (qx * qx + qy * qy);
  const float e0 = expf(2.0f * ls0), e1 = expf(2.0f * ls1),
              e2 = expf(2.0f * ls2);
  G.e0 = e0;
  G.e1 = e1;
  G.e2 = e2;
  G.s00 = (R[0] * e0 * R[0] + R[1] * e1 * R[1]) + R[2] * e2 * R[2];
  G.s01 = (R[0] * e0 * R[3] + R[1] * e1 * R[4]) + R[2] * e2 * R[5];
  G.s02 = (R[0] * e0 * R[6] + R[1] * e1 * R[7]) + R[2] * e2 * R[8];
  G.s11 = (R[3] * e0 * R[3] + R[4] * e1 * R[4]) + R[5] * e2 * R[5];
  G.s12 = (R[3] * e0 * R[6] + R[4] * e1 * R[7]) + R[5] * e2 * R[8];
  G.s22 = (R[6] * e0 * R[6] + R[7] * e1 * R[7]) + R[8] * e2 * R[8];

  G.inv_z = 1.0f / G.zs;
  G.inv_z2 = G.inv_z * G.inv_z;
  G.f0 = cam.fx * G.inv_z;
  G.g0 = cam.fx * G.pcx * G.inv_z2;
  G.f1 = cam.fy * G.inv_z;
  G.g1 = cam.fy * G.pcy * G.inv_z2;
  G.t00 = G.f0 * r[0] - G.g0 * r[6];
  G.t01 = G.f0 * r[1] - G.g0 * r[7];
  G.t02 = G.f0 * r[2] - G.g0 * r[8];
  G.t10 = G.f1 * r[3] - G.g1 * r[6];
  G.t11 = G.f1 * r[4] - G.g1 * r[7];
  G.t12 = G.f1 * r[5] - G.g1 * r[8];
  G.st00 = (G.s00 * G.t00 + G.s01 * G.t01) + G.s02 * G.t02;
  G.st01 = (G.s01 * G.t00 + G.s11 * G.t01) + G.s12 * G.t02;
  G.st02 = (G.s02 * G.t00 + G.s12 * G.t01) + G.s22 * G.t02;
  G.st10 = (G.s00 * G.t10 + G.s01 * G.t11) + G.s02 * G.t12;
  G.st11 = (G.s01 * G.t10 + G.s11 * G.t11) + G.s12 * G.t12;
  G.st12 = (G.s02 * G.t10 + G.s12 * G.t11) + G.s22 * G.t12;
  G.a = ((G.t00 * G.st00 + G.t01 * G.st01) + G.t02 * G.st02) + blur;
  G.b = (G.t10 * G.st00 + G.t11 * G.st01) + G.t12 * G.st02;
  G.c = ((G.t10 * G.st10 + G.t11 * G.st11) + G.t12 * G.st12) + blur;
  G.det = G.a * G.c - G.b * G.b;
  G.det_safe = G.det > 0.0f ? G.det : 1.0f;
  G.inv_det = 1.0f / G.det_safe;
  return G;
}

// The unit view direction from the camera centre to the mean (a 1e-12
// floor on its length, nrm) and its products.
struct Direction {
  float nrm, inv_n, x, y, z, xx, yy, zz, xy, yz, xz;
};

__device__ __forceinline__ Direction direction(const Camera& cam, float mx,
                                               float my, float mz) {
  Direction d;
  const float dx = mx - cam.p0, dy = my - cam.p1, dz = mz - cam.p2;
  d.nrm = sqrtf((dx * dx + dy * dy) + dz * dz);
  d.inv_n = 1.0f / clamp_min(d.nrm, kNormFloor);
  d.x = dx * d.inv_n;
  d.y = dy * d.inv_n;
  d.z = dz * d.inv_n;
  d.xx = d.x * d.x;
  d.yy = d.y * d.y;
  d.zz = d.z * d.z;
  d.xy = d.x * d.y;
  d.yz = d.y * d.z;
  d.xz = d.x * d.z;
  return d;
}

// One channel's SH sum plus 0.5, before the clamp at 0: s points at the
// channel's coefficient 0, coefficient k at s[3 k kPitch]; bands (0-3) of
// the K coefficients are evaluated.
template <int K>
__device__ __forceinline__ float sh_colour(const float* s, int bands,
                                           const Direction& d) {
  const float x = d.x, y = d.y, zd = d.z, xx = d.xx, yy = d.yy, zz = d.zz;
  float col = kC0 * s[0];
  if (K > 1 && bands >= 1) {
    col = ((col - kC1 * y * s[3 * kPitch]) + kC1 * zd * s[6 * kPitch])
          - kC1 * x * s[9 * kPitch];
  }
  if (K > 4 && bands >= 2) {
    col = ((((col + kC2_0 * d.xy * s[12 * kPitch])
             + kC2_1 * d.yz * s[15 * kPitch])
            + kC2_2 * (2.0f * zz - xx - yy) * s[18 * kPitch])
           + kC2_3 * d.xz * s[21 * kPitch])
          + kC2_4 * (xx - yy) * s[24 * kPitch];
  }
  if (K > 9 && bands >= 3) {
    col = ((((((col + kC3_0 * y * (3.0f * xx - yy) * s[27 * kPitch])
               + kC3_1 * d.xy * zd * s[30 * kPitch])
              + kC3_2 * y * (4.0f * zz - xx - yy) * s[33 * kPitch])
             + kC3_3 * zd * (2.0f * zz - 3.0f * xx - 3.0f * yy)
                   * s[36 * kPitch])
            + kC3_4 * x * (4.0f * zz - xx - yy) * s[39 * kPitch])
           + kC3_5 * zd * (xx - yy) * s[42 * kPitch])
          + kC3_6 * x * (xx - 3.0f * yy) * s[45 * kPitch];
  }
  return col + 0.5f;
}

}  // namespace proj
