// The skip test of kernels B5 (blend_vis.cu) and B2 (blend_bwd.cu): which
// instance-pixel pairs may be passed over without computing their alpha.
//
// The blend kernels compute, for a pixel at tile-local offset (dx, dy) from
// an instance's mean,
//   q = (ca*dx + cb2*dy)*dx + cc*dy*dy,  alpha = fminf(op*expf(-0.5f*q), amax)
// and cut the pair when alpha < alpha_min. The cut is a test of q alone:
// alpha >= alpha_min needs op*exp(-q/2) >= alpha_min, i.e. q <= q_cut =
// 2 (ln op - ln alpha_min). A pair may be skipped only where that arithmetic
// would certainly have cut it, so every test here is conservative:
//
// * q_cut() is 2 (logf(op) - logf(alpha_min)) plus a margin of
//   kCutMargin * (1 + |ln op| + |ln alpha_min|). It absorbs expf's error
//   (2 ulp), the product with op (0.5 ulp), and logf's error (1 ulp of each
//   log) with the rounding of their difference, which together stay below
//   1e-6 * (1 + |ln op| + |ln alpha_min|) in q: the margin is 100 times
//   that. A pixel whose own q exceeds q_cut() is cut for certain.
//
// * rect_q_lower() bounds from below the q the kernel computes at every
//   pixel centre of a rectangle. The caller passes the rectangle as the
//   ranges [x0, x1], [y0, y1] of the kernel's own dx = px - mx and dy =
//   py - my at its corner pixels: rounding is monotone, so every pixel's dx
//   and dy lie in those ranges exactly. rect_min_q() is the exact minimum of
//   q over that box for a positive definite conic (0 when the mean lies
//   inside; else the least of the four closed-form edge minima), in float.
//   Two roundings separate it from any pixel's q: the kernel's own q
//   (5 roundings) and the edge minima (the same q, plus the rounded argmin,
//   which moves q by cc*(2u y*)^2 <= 4u^2 ca x^2). Both are relative to the
//   terms' magnitude |ca|dx^2 + 2|cb||dx dy| + cc dy^2, not to q, which
//   cancellation in a thin rotated conic can make far smaller; so the margin
//   is kRectMargin (1e-5, 30 times the ~3e-7 the roundings reach) times that
//   magnitude at the box's farthest corner. An absolute margin would be
//   unsafe for a long conic far from its mean.
//
// * A conic that is not positive definite with room to spare (ca > 0 and
//   ca*cc - cb^2 > kDetMargin * ca*cc) is never skipped by a rectangle: the
//   edge formulae are the minimum only for a convex q. Such conics are 600
//   times longer than wide; they are blended pair by pair as before.
//
// Any NaN or infinity in the inputs makes the comparisons false, so nothing
// is skipped. Every pair that is not skipped is computed with the kernels'
// operations in their order, so outputs are unchanged. render/blend.py
// (_cull_q_cut, _cull_rect_skip) mirrors these functions with the same f32
// operations for the tests.

#pragma once

#include <cuda_runtime.h>

namespace cull {

constexpr float kCutMargin = 1e-4f;
constexpr float kRectMargin = 1e-5f;
constexpr float kDetMargin = 1e-5f;

// q beyond which op * expf(-q / 2) is certainly below alpha_min
__device__ __forceinline__ float q_cut(float op, float log_alpha_min) {
  const float lop = logf(op);
  const float qc = 2.0f * (lop - log_alpha_min);
  return qc + kCutMargin * (1.0f + fabsf(lop) + fabsf(log_alpha_min));
}

__device__ __forceinline__ bool definite(float ca, float cb, float cc) {
  const float acc = ca * cc;
  return ca > 0.0f && acc - cb * cb > kDetMargin * acc;
}

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// min of q over dx in [x0, x1], dy in [y0, y1] for a definite conic
__device__ __forceinline__ float rect_min_q(float ca, float cb, float cc,
                                            float x0, float x1, float y0,
                                            float y1) {
  if ((x0 <= 0.0f) && (0.0f <= x1) && (y0 <= 0.0f) && (0.0f <= y1)) {
    return 0.0f;
  }
  const float ncb = -cb;
  const float cb2 = 2.0f * cb;
  const float ysa = clip(ncb * x0 / cc, y0, y1);
  const float qxa = (ca * x0 + cb2 * ysa) * x0 + cc * ysa * ysa;
  const float ysb = clip(ncb * x1 / cc, y0, y1);
  const float qxb = (ca * x1 + cb2 * ysb) * x1 + cc * ysb * ysb;
  const float xsa = clip(ncb * y0 / ca, x0, x1);
  const float qya = (cc * y0 + cb2 * xsa) * y0 + ca * xsa * xsa;
  const float xsb = clip(ncb * y1 / ca, x0, x1);
  const float qyb = (cc * y1 + cb2 * xsb) * y1 + ca * xsb * xsb;
  return fminf(fminf(qxa, qxb), fminf(qya, qyb));
}

// a lower bound of the kernel's q at every pixel whose dx lies in [x0, x1]
// and dy in [y0, y1], for a definite conic
__device__ __forceinline__ float rect_q_lower(float ca, float cb, float cc,
                                              float x0, float x1, float y0,
                                              float y1) {
  const float m = rect_min_q(ca, cb, cc, x0, x1, y0, y1);
  const float ax = fmaxf(fabsf(x0), fabsf(x1));
  const float ay = fmaxf(fabsf(y0), fabsf(y1));
  const float mag = (ca * ax + 2.0f * fabsf(cb) * ay) * ax + cc * ay * ay;
  return m - kRectMargin * mag;
}

// true when no pixel centre of the rectangle [cx0, cx1] x [cy0, cy1]
// (tile-local, as the kernel's px and py) can pass the cut of an instance
// whose tile-local mean is (mx, my) and whose q_cut() is thr
__device__ __forceinline__ bool rect_skips(float mx, float my, float ca,
                                           float cb, float cc, float thr,
                                           float cx0, float cx1, float cy0,
                                           float cy1) {
  return definite(ca, cb, cc) &&
         rect_q_lower(ca, cb, cc, cx0 - mx, cx1 - mx, cy0 - my, cy1 - my) >
             thr;
}

}  // namespace cull
