// The projection's backward: the gradient of the scene's five float fields
// from the gradients of the projection's ten differentiable outputs (u, v,
// the conic, depth, the SH colour and the opacity), the analytic VJP of
// render/projection.py::_project_plain and render/sh.py::eval_sh_soa in one
// launch. render/projection.py::_project_vjp_plain is its plain version,
// operation for operation.
//
// Replaces XLA glue, not a Pallas kernel: the JAX package leaves the
// projection and its VJP to XLA and jax.grad. Through PyTorch's autograd the
// same VJP took ~1,100 launches a train step, among them a zero fill, a copy
// and an accumulating add over the whole [N, 16, 3] SH gradient for each of
// the 48 sh[:, k, ch] selects.
//
// Each thread recomputes its gaussian's forward values in registers with the
// forward kernel's own functions (project.cuh), so nothing but the inputs is
// saved between the passes, and chains the incoming gradients back through
// them. Where PyTorch's derivative picks a branch, this does too: the
// clamp_min of the colour passes the gradient where c + 0.5 >= 0, the
// where() of the depth range passes it to z only in range, that of the
// determinant only where det > 0, the view direction's 1e-12 floor cuts its
// normalisation's gradient where the length is below it. Bands past the
// evaluated ones get exact zeros. A gaussian whose ten incoming gradients
// are all exactly 0 gets all-zero gradient rows, and its rows are not read:
// most gaussians of a training view touch no pixel.
//
// Bound on the card: bytes. Each live gaussian reads its 59 parameter
// floats (236 bytes at SH degree 3), every gaussian its incoming gradients
// (one 64-byte row of the fold's [N, 16] output, read through autograd's
// strided views, a pointer and a stride each) and writes 59 floats. One
// thread a gaussian, 128 a block: the block decides which of its gaussians
// are live, copies the live rows of each input into shared memory
// transposed (project.cuh::stage, 16-byte loads, the pieces of dead rows
// skipped), and after the arithmetic writes the gradient rows back through
// the same shared arrays with 16-byte stores, coalesced. f32 throughout,
// -fmad=false, no atomics: each gaussian owns its rows, so the result is the
// same from run to run.

#include <cuda_runtime.h>

#include "project.cuh"

namespace {

using namespace proj;

constexpr int kGrads = 10;   // incoming gradients, in kernel order below

// Derivative constants of the SH basis, as render/projection.py passes them:
// the f32 of the double product.
#define F32(x) static_cast<float>(x)
constexpr float kD2_2m2 = F32(-2.0 * 0.31539156525252005);
constexpr float kD2_2p4 = F32(4.0 * 0.31539156525252005);
constexpr float kD2_4p2 = F32(2.0 * 0.5462742152960396);
constexpr float kD2_4m2 = F32(-2.0 * 0.5462742152960396);
constexpr float kD3_0p6 = F32(6.0 * -0.5900435899266435);
constexpr float kD3_0p3 = F32(3.0 * -0.5900435899266435);
constexpr float kD3_2m2 = F32(-2.0 * -0.4570457994644658);
constexpr float kD3_2p8 = F32(8.0 * -0.4570457994644658);
constexpr float kD3_3m6 = F32(-6.0 * 0.3731763325901154);
constexpr float kD3_3p3 = F32(3.0 * 0.3731763325901154);
constexpr float kD3_4m2 = F32(-2.0 * -0.4570457994644658);
constexpr float kD3_4p8 = F32(8.0 * -0.4570457994644658);
constexpr float kD3_5p2 = F32(2.0 * 1.445305721320277);
constexpr float kD3_5m2 = F32(-2.0 * 1.445305721320277);
constexpr float kD3_6p3 = F32(3.0 * -0.5900435899266435);
constexpr float kD3_6m6 = F32(-6.0 * -0.5900435899266435);
#undef F32

// The incoming gradients: u, v, ca, cb, cc, depth, red, green, blue,
// opacity, each an [N] f32 view (a pointer and a stride in elements); a null
// pointer is a gradient of zeros.
struct Incoming {
  const float* p[kGrads];
  long long stride[kGrads];
};

// One gaussian's VJP (file comment). s points at its SH coefficient 0 of
// channel 0 in the staged block (coefficient k, channel ch at
// s[(3 k + ch) kPitch]). Writes the gradients of the mean, the log-scales,
// the quaternion and the opacity logit, and the colour gradient past each
// channel's clamp with the SH basis, whose products are the SH gradient.
template <int K>
__device__ __forceinline__ void vjp(const Camera& cam, const Geometry& G,
                                    const Direction& d, float logit,
                                    const float* s, int bands,
                                    const float* gi, float* g_mean,
                                    float* g_ls, float* g_q, float* g_o,
                                    float* gcol, float* basis) {
  const float gu = gi[0], gv = gi[1], gca = gi[2], gcb = gi[3],
              gcc = gi[4], gdepth = gi[5], gop = gi[9];
  const float* r = cam.r;

  // conic = (c, -b, a) / det_safe
  const float g_inv = (gca * G.c - gcb * G.b) + gcc * G.a;
  const float g_det =
      G.det > 0.0f ? -(g_inv * (G.inv_det * G.inv_det)) : 0.0f;
  const float g_a = gcc * G.inv_det + g_det * G.c;
  const float g_b = -(gcb * G.inv_det) - 2.0f * (g_det * G.b);
  const float g_c = gca * G.inv_det + g_det * G.a;

  // Sigma2 = T Sigma3 T^T: the rows of T, and Sigma3's gradient as a
  // symmetric matrix gS = T^T [[g_a, g_b/2], [g_b/2, g_c]] T
  const float hb = 0.5f * g_b;
  const float t0[3] = {G.t00, G.t01, G.t02}, t1[3] = {G.t10, G.t11, G.t12};
  const float st0[3] = {G.st00, G.st01, G.st02},
              st1[3] = {G.st10, G.st11, G.st12};
  float w0[3], w1[3], g_t0[3], g_t1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    w0[k] = g_a * t0[k] + hb * t1[k];
    w1[k] = hb * t0[k] + g_c * t1[k];
    g_t0[k] = 2.0f * (g_a * st0[k]) + g_b * st1[k];
    g_t1[k] = 2.0f * (g_c * st1[k]) + g_b * st0[k];
  }
  float gS[3][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int k = j; k < 3; ++k) {
      gS[j][k] = t0[j] * w0[k] + t1[j] * w1[k];
      gS[k][j] = gS[j][k];
    }
  }

  // Sigma3 = R_q E R_q^T: P = gS R_q, g_Rq = 2 P E, g_e = diag(R_q^T P)
  const float* R = G.rq;
  const float e[3] = {G.e0, G.e1, G.e2};
  float gR[9];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float P[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      P[j] = (gS[j][0] * R[k] + gS[j][1] * R[3 + k]) + gS[j][2] * R[6 + k];
      gR[3 * j + k] = 2.0f * (P[j] * e[k]);
    }
    const float g_e = (R[k] * P[0] + R[3 + k] * P[1]) + R[6 + k] * P[2];
    g_ls[k] = 2.0f * (g_e * e[k]);
  }

  // R_q from the unit quaternion, then its normalisation
  const float qw = G.qw, qx = G.qx, qy = G.qy, qz = G.qz;
  const float gqw = 2.0f * ((qz * (gR[3] - gR[1]) + qy * (gR[2] - gR[6]))
                            + qx * (gR[7] - gR[5]));
  const float gqx = 2.0f * (((qy * (gR[1] + gR[3]) + qz * (gR[2] + gR[6]))
                             + qw * (gR[7] - gR[5]))
                            - 2.0f * (qx * (gR[4] + gR[8])));
  const float gqy = 2.0f * (((qx * (gR[1] + gR[3]) + qz * (gR[5] + gR[7]))
                             + qw * (gR[2] - gR[6]))
                            - 2.0f * (qy * (gR[0] + gR[8])));
  const float gqz = 2.0f * (((qx * (gR[2] + gR[6]) + qy * (gR[5] + gR[7]))
                             + qw * (gR[3] - gR[1]))
                            - 2.0f * (qz * (gR[0] + gR[4])));
  const float dot = ((gqw * qw + gqx * qx) + gqy * qy) + gqz * qz;
  g_q[0] = (gqw - dot * qw) / G.norm;
  g_q[1] = (gqx - dot * qx) / G.norm;
  g_q[2] = (gqy - dot * qy) / G.norm;
  g_q[3] = (gqz - dot * qz) / G.norm;

  // T = J R: its rows from f0 = fx / zs, g0 = fx pcx / zs^2 (and f1, g1)
  const float g_f0 = (g_t0[0] * r[0] + g_t0[1] * r[1]) + g_t0[2] * r[2];
  const float g_g0 = -((g_t0[0] * r[6] + g_t0[1] * r[7]) + g_t0[2] * r[8]);
  const float g_f1 = (g_t1[0] * r[3] + g_t1[1] * r[4]) + g_t1[2] * r[5];
  const float g_g1 = -((g_t1[0] * r[6] + g_t1[1] * r[7]) + g_t1[2] * r[8]);
  const float g_pcx = gu * G.f0 + g_g0 * (cam.fx * G.inv_z2);
  const float g_pcy = gv * G.f1 + g_g1 * (cam.fy * G.inv_z2);
  const float g_zs =
      -((gu * G.g0 + gv * G.g1)
        + ((g_f0 * G.f0 + g_f1 * G.f1) + 2.0f * (g_g0 * G.g0 + g_g1 * G.g1))
              * G.inv_z);
  const float g_z = (G.in_depth ? g_zs : 0.0f) + gdepth;

  // the colour: clamp_min(c + 0.5, 0) passes where c + 0.5 >= 0
  const int keval = bands >= 3 ? 16 : bands == 2 ? 9 : bands == 1 ? 4 : 1;
  const float x = d.x, y = d.y, zd = d.z, xx = d.xx, yy = d.yy, zz = d.zz;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    gcol[ch] = sh_colour<K>(s + ch * kPitch, bands, d) >= 0.0f ? gi[6 + ch]
                                                               : 0.0f;
  basis[0] = kC0;
  basis[1] = -(kC1 * y);
  basis[2] = kC1 * zd;
  basis[3] = -(kC1 * x);
  basis[4] = kC2_0 * d.xy;
  basis[5] = kC2_1 * d.yz;
  basis[6] = kC2_2 * (2.0f * zz - xx - yy);
  basis[7] = kC2_3 * d.xz;
  basis[8] = kC2_4 * (xx - yy);
  basis[9] = kC3_0 * y * (3.0f * xx - yy);
  basis[10] = kC3_1 * d.xy * zd;
  basis[11] = kC3_2 * y * (4.0f * zz - xx - yy);
  basis[12] = kC3_3 * zd * (2.0f * zz - 3.0f * xx - 3.0f * yy);
  basis[13] = kC3_4 * x * (4.0f * zz - xx - yy);
  basis[14] = kC3_5 * zd * (xx - yy);
  basis[15] = kC3_6 * x * (xx - 3.0f * yy);

  // the direction's gradient: sum_k (sum_ch gcol sh[k, ch]) d basis_k
  float vk[16];
#pragma unroll
  for (int k = 1; k < 16; ++k) {
    vk[k] = k < K && k < keval
                ? (gcol[0] * s[3 * k * kPitch]
                   + gcol[1] * s[(3 * k + 1) * kPitch])
                      + gcol[2] * s[(3 * k + 2) * kPitch]
                : 0.0f;
  }
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
  if (K > 1 && keval > 1) {
    gx = -kC1 * vk[3];
    gy = -kC1 * vk[1];
    gz = kC1 * vk[2];
  }
  if (K > 4 && keval > 4) {
    gx = gx + (kC2_0 * y) * vk[4];
    gy = gy + (kC2_0 * x) * vk[4];
    gy = gy + (kC2_1 * zd) * vk[5];
    gz = gz + (kC2_1 * y) * vk[5];
    gx = gx + (kD2_2m2 * x) * vk[6];
    gy = gy + (kD2_2m2 * y) * vk[6];
    gz = gz + (kD2_2p4 * zd) * vk[6];
    gx = gx + (kC2_3 * zd) * vk[7];
    gz = gz + (kC2_3 * x) * vk[7];
    gx = gx + (kD2_4p2 * x) * vk[8];
    gy = gy + (kD2_4m2 * y) * vk[8];
  }
  if (K > 9 && keval > 9) {
    gx = gx + (kD3_0p6 * d.xy) * vk[9];
    gy = gy + (kD3_0p3 * (xx - yy)) * vk[9];
    gx = gx + (kC3_1 * d.yz) * vk[10];
    gy = gy + (kC3_1 * d.xz) * vk[10];
    gz = gz + (kC3_1 * d.xy) * vk[10];
    gx = gx + (kD3_2m2 * d.xy) * vk[11];
    gy = gy + (kC3_2 * (4.0f * zz - xx - 3.0f * yy)) * vk[11];
    gz = gz + (kD3_2p8 * d.yz) * vk[11];
    gx = gx + (kD3_3m6 * d.xz) * vk[12];
    gy = gy + (kD3_3m6 * d.yz) * vk[12];
    gz = gz + (kD3_3p3 * (2.0f * zz - xx - yy)) * vk[12];
    gx = gx + (kC3_4 * (4.0f * zz - 3.0f * xx - yy)) * vk[13];
    gy = gy + (kD3_4m2 * d.xy) * vk[13];
    gz = gz + (kD3_4p8 * d.xz) * vk[13];
    gx = gx + (kD3_5p2 * d.xz) * vk[14];
    gy = gy + (kD3_5m2 * d.yz) * vk[14];
    gz = gz + (kC3_5 * (xx - yy)) * vk[14];
    gx = gx + (kD3_6p3 * (xx - yy)) * vk[15];
    gy = gy + (kD3_6m6 * d.xy) * vk[15];
  }
  // x = dx / max(|d|, 1e-12): below the floor only the direct term
  float gdx = gx, gdy = gy, gdz = gz;
  if (d.nrm >= kNormFloor) {
    const float dd = (gx * x + gy * y) + gz * zd;
    gdx = gx - dd * x;
    gdy = gy - dd * y;
    gdz = gz - dd * zd;
  }
  gdx = gdx * d.inv_n;
  gdy = gdy * d.inv_n;
  gdz = gdz * d.inv_n;

  // the camera-space mean is R m + t; the direction is m - pos
  g_mean[0] = ((r[0] * g_pcx + r[3] * g_pcy) + r[6] * g_z) + gdx;
  g_mean[1] = ((r[1] * g_pcx + r[4] * g_pcy) + r[7] * g_z) + gdy;
  g_mean[2] = ((r[2] * g_pcx + r[5] * g_pcy) + r[8] * g_z) + gdz;

  // opacity = sigmoid(logit) = 1 / (1 + exp(-logit))
  const float op = 1.0f / (1.0f + expf(-logit));
  *g_o = gop * (op * (1.0f - op));
}

// The transpose of stage: rows [first, first + count) of an [N, R] f32
// array from src (element j of row first + g at src[j * kPitch + g]), with
// 16-byte stores where the block's rows are whole and 16-byte aligned.
template <int R>
__device__ __forceinline__ void unstage(const float* __restrict__ src,
                                        long long first, int count,
                                        float* __restrict__ dst) {
  float* base = dst + first * R;
  const int t = threadIdx.x;
  if (count == kThreads &&
      (reinterpret_cast<uintptr_t>(base) & 15) == 0) {
    constexpr int kVec = kThreads * R / 4;
    float4* b4 = reinterpret_cast<float4*>(base);
    for (int i = t; i < kVec; i += kThreads) {
      float e[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int f = 4 * i + c;
        e[c] = src[(f % R) * kPitch + f / R];
      }
      b4[i] = make_float4(e[0], e[1], e[2], e[3]);
    }
  } else {
    for (int f = t; f < count * R; f += kThreads)
      base[f] = src[(f % R) * kPitch + f / R];
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads) project_bwd_kernel(
    const float* __restrict__ means, const float* __restrict__ log_scales,
    const float* __restrict__ quats, const float* __restrict__ opacities,
    const float* __restrict__ sh, int n, int bands,
    const float* __restrict__ rot, const float* __restrict__ pos,
    const float* __restrict__ fx_p, const float* __restrict__ fy_p,
    float z_near, float z_far, float blur, Incoming gin,
    float* __restrict__ g_means, float* __restrict__ g_scales,
    float* __restrict__ g_quats, float* __restrict__ g_opac,
    float* __restrict__ g_sh) {
  __shared__ float s_means[3 * kPitch];
  __shared__ float s_scales[3 * kPitch];
  __shared__ float s_quats[4 * kPitch];
  __shared__ float s_opac[kPitch];
  __shared__ float s_sh[3 * K * kPitch];
  __shared__ bool s_live[kThreads];

  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const int count = static_cast<int>(min(static_cast<long long>(kThreads),
                                         n - first));
  const int g = threadIdx.x;
  const long long i = first + g;
  float gi[kGrads];
  bool live = false;
#pragma unroll
  for (int f = 0; f < kGrads; ++f) {
    gi[f] = g < count && gin.p[f] != nullptr
                ? __ldg(gin.p[f] + i * gin.stride[f])
                : 0.0f;
    live = live || gi[f] != 0.0f;
  }
  s_live[g] = live;
  if (__syncthreads_or(live)) {
    stage<3, true>(means, first, count, s_means, s_live);
    stage<3, true>(log_scales, first, count, s_scales, s_live);
    stage<4, true>(quats, first, count, s_quats, s_live);
    stage<1, true>(opacities, first, count, s_opac, s_live);
    stage<3 * K, true>(sh, first, count, s_sh, s_live);
  }
  __syncthreads();

  float g_mean[3] = {0.0f, 0.0f, 0.0f}, g_ls[3] = {0.0f, 0.0f, 0.0f},
        g_q[4] = {0.0f, 0.0f, 0.0f, 0.0f}, g_o = 0.0f,
        gcol[3] = {0.0f, 0.0f, 0.0f}, basis[16];
  if (live) {
    const Camera cam = load_camera(rot, pos, fx_p, fy_p);
    const float mx = s_means[g], my = s_means[kPitch + g],
                mz = s_means[2 * kPitch + g];
    const Geometry G = geometry(
        cam, mx, my, mz, s_scales[g], s_scales[kPitch + g],
        s_scales[2 * kPitch + g], s_quats[g], s_quats[kPitch + g],
        s_quats[2 * kPitch + g], s_quats[3 * kPitch + g], blur, z_near,
        z_far);
    const Direction d = direction(cam, mx, my, mz);
    vjp<K>(cam, G, d, s_opac[g], s_sh + g, bands, gi, g_mean, g_ls, g_q,
           &g_o, gcol, basis);
  }
  __syncthreads();   // every staged input read: the arrays take the output

  if (g < count) {
    const int keval = bands >= 3 ? 16 : bands == 2 ? 9 : bands == 1 ? 4 : 1;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s_means[k * kPitch + g] = g_mean[k];
      s_scales[k * kPitch + g] = g_ls[k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) s_quats[k * kPitch + g] = g_q[k];
    s_opac[g] = g_o;
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        s_sh[(3 * k + ch) * kPitch + g] =
            live && k < keval ? gcol[ch] * basis[k] : 0.0f;
      }
    }
  }
  __syncthreads();
  unstage<3>(s_means, first, count, g_means);
  unstage<3>(s_scales, first, count, g_scales);
  unstage<4>(s_quats, first, count, g_quats);
  unstage<1>(s_opac, first, count, g_opac);
  unstage<3 * K>(s_sh, first, count, g_sh);
}

template <int K>
cudaError_t launch(const void* means, const void* log_scales,
                   const void* quats, const void* opacities, const void* sh,
                   int n, int bands, const void* rot, const void* pos,
                   const void* fx, const void* fy, float z_near, float z_far,
                   float blur, const Incoming& gin, void* g_means,
                   void* g_scales, void* g_quats, void* g_opac, void* g_sh,
                   cudaStream_t stream) {
  const int blocks = static_cast<int>((n + kThreads - 1LL) / kThreads);
  project_bwd_kernel<K><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(means), static_cast<const float*>(log_scales),
      static_cast<const float*>(quats), static_cast<const float*>(opacities),
      static_cast<const float*>(sh), n, bands,
      static_cast<const float*>(rot), static_cast<const float*>(pos),
      static_cast<const float*>(fx), static_cast<const float*>(fy), z_near,
      z_far, blur, gin, static_cast<float*>(g_means),
      static_cast<float*>(g_scales), static_cast<float*>(g_quats),
      static_cast<float*>(g_opac), static_cast<float*>(g_sh));
  return cudaGetLastError();
}

}  // namespace

// The inputs of gsplat_project (project.cu), but the cutoff's, and the
// gradients of its ten differentiable outputs: grads and strides are host
// arrays of 10, in the order u, v, ca, cb, cc, depth, red, green, blue,
// opacity, each an [n] f32 view on the card at grads[f] with stride
// strides[f] (elements), or a null pointer for zeros. Writes g_means,
// g_scales [n, 3], g_quats [n, 4], g_opac [n] and g_sh [n, k, 3], f32,
// contiguous, 16-byte aligned. Inputs contiguous; 0 < n < 2^31.
extern "C" int gsplat_project_bwd(
    const void* means, const void* log_scales, const void* quats,
    const void* opacities, const void* sh, int n, int k, int bands,
    const void* rot, const void* pos, const void* fx, const void* fy,
    float z_near, float z_far, float blur, const void* const* grads,
    const long long* strides, void* g_means, void* g_scales, void* g_quats,
    void* g_opac, void* g_sh, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  Incoming gin;
  for (int f = 0; f < kGrads; ++f) {
    gin.p[f] = static_cast<const float*>(grads[f]);
    gin.stride[f] = strides[f];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define GSPLAT_PROJECT_BWD_CASE(K)                                        \
  case K:                                                                 \
    return static_cast<int>(launch<K>(                                    \
        means, log_scales, quats, opacities, sh, n, bands, rot, pos, fx, \
        fy, z_near, z_far, blur, gin, g_means, g_scales, g_quats, g_opac, \
        g_sh, s));
    GSPLAT_PROJECT_BWD_CASE(1)
    GSPLAT_PROJECT_BWD_CASE(4)
    GSPLAT_PROJECT_BWD_CASE(9)
    GSPLAT_PROJECT_BWD_CASE(16)
#undef GSPLAT_PROJECT_BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
