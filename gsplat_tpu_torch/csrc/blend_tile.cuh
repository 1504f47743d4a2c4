// The forward tile blend of kernel B1 (blend_fwd.cu): front-to-back
// compositing of one image tile per block, with the best-weight label
// channel. Kernel B5 has its own kernel (blend_vis.cu).
//
// Design: one block of 256 threads per tile (tile_size^2 <= 1024 pixels, at
// most 4 per thread, pixel p = threadIdx.x + k * 256 so that stores of one
// row are contiguous). The block walks its tile's [start, end) range of the
// depth-sorted instance stream in batches of `chunk` instances. Each batch
// gathers the 10 parameter columns it needs straight from the [N, 16]
// per-gaussian table at the sorted gaussian indices into shared memory; no
// window array exists. Each thread keeps T, RGB and (with labels) the best
// weight and its label of its pixels in registers and composites front to
// back: w = T * alpha, C += w * c, T *= 1 - alpha. The label moves on a
// strict w > best_w, so the front-most maximum wins, as in the JAX kernels
// and the oracle. Output goes straight to image layout, cropped at the image
// edge; an empty tile writes T = 1, RGB = 0, label UNLABELED.
//
// Early stop keeps the JAX rule: a batch is skipped only when the whole
// tile's max T is below early_eps (__syncthreads_count at each batch
// boundary). blend_fwd.cu instantiates blend_tile_kernel<false>; kVis =
// true is refused.
//
// Exactness: alpha is computed as blend_pallas.py::_chunk_alphas does
// (tile-local dx, dy, the same q, expf, not __expf), and the including file
// is built with -fmad=false, so the alpha_min cut agrees with the plain
// version (render/blend.py) and the two differ only where the compositing
// is associated differently.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPixelsPerThread = 4;   // tile_size^2 <= 1024
constexpr int kCols = 10;                // staged parameter columns
constexpr int kUnlabeled = -1;

// parameter columns of the [N, 16] table (render/blend.py P_*)
constexpr int P_MX = 0, P_MY = 1, P_CA = 2, P_CB = 3, P_CC = 4, P_OP = 5,
              P_R = 6, P_G = 7, P_B = 8, P_LABEL = 10, PARAM_ROWS = 16;

// Dynamic shared memory: kCols columns of `chunk` floats. inst_w is not
// read; blend_fwd.cu passes nullptr.
template <bool kVis>
__global__ void __launch_bounds__(kThreads) blend_tile_kernel(
    const float* __restrict__ ptab, const int* __restrict__ inst_gauss,
    const int* __restrict__ bounds, int tiles_x, int tile_size, int width,
    int height, int chunk, float alpha_min, float alpha_max, float early_eps,
    int with_labels, float* __restrict__ rgb, float* __restrict__ trans,
    float* __restrict__ best_w, int* __restrict__ label,
    float* __restrict__ inst_w) {
  static_assert(!kVis, "B5 has its own kernel in blend_vis.cu");
  extern __shared__ float smem[];
  float* s_mx = smem;
  float* s_my = s_mx + chunk;
  float* s_ca = s_my + chunk;
  float* s_cb2 = s_ca + chunk;
  float* s_cc = s_cb2 + chunk;
  float* s_op = s_cc + chunk;
  float* s_r = s_op + chunk;
  float* s_g = s_r + chunk;
  float* s_b = s_g + chunk;
  float* s_lab = s_b + chunk;

  const int tile = blockIdx.x;
  const int trow = tile / tiles_x;
  const int tcol = tile - trow * tiles_x;
  const float x0f = static_cast<float>(tcol * tile_size);
  const float y0f = static_cast<float>(trow * tile_size);
  const int npix = tile_size * tile_size;

  float px[kMaxPixelsPerThread], py[kMaxPixelsPerThread];
  float T[kMaxPixelsPerThread], cr[kMaxPixelsPerThread],
      cg[kMaxPixelsPerThread], cbl[kMaxPixelsPerThread],
      bw[kMaxPixelsPerThread];
  int lab[kMaxPixelsPerThread];
#pragma unroll
  for (int k = 0; k < kMaxPixelsPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    px[k] = static_cast<float>(p % tile_size) + 0.5f;
    py[k] = static_cast<float>(p / tile_size) + 0.5f;
    T[k] = 1.0f;
    cr[k] = cg[k] = cbl[k] = bw[k] = 0.0f;
    lab[k] = kUnlabeled;
  }

  const int start = bounds[tile];
  const int end = bounds[tile + 1];
  for (int b0 = start; b0 < end; b0 += chunk) {
    // Also the barrier that keeps the previous batch's readers ahead of
    // this batch's writers of shared memory.
    float tmax = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxPixelsPerThread; ++k) {
      if (threadIdx.x + k * kThreads < npix) tmax = fmaxf(tmax, T[k]);
    }
    if (__syncthreads_count(tmax >= early_eps) == 0) break;
    const int n = min(chunk, end - b0);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float* row =
          ptab + static_cast<size_t>(inst_gauss[b0 + i]) * PARAM_ROWS;
      s_mx[i] = row[P_MX] - x0f;
      s_my[i] = row[P_MY] - y0f;
      s_ca[i] = row[P_CA];
      s_cb2[i] = 2.0f * row[P_CB];
      s_cc[i] = row[P_CC];
      s_op[i] = row[P_OP];
      s_r[i] = row[P_R];
      s_g[i] = row[P_G];
      s_b[i] = row[P_B];
      s_lab[i] = row[P_LABEL];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float mx = s_mx[i], my = s_my[i], ca = s_ca[i], cb2 = s_cb2[i],
                  cc = s_cc[i], op = s_op[i];
#pragma unroll
      for (int k = 0; k < kMaxPixelsPerThread; ++k) {
        if (threadIdx.x + k * kThreads >= npix) continue;
        const float dx = px[k] - mx;
        const float dy = py[k] - my;
        const float q = (ca * dx + cb2 * dy) * dx + cc * dy * dy;
        const float alpha = fminf(op * expf(-0.5f * q), alpha_max);
        if (alpha >= alpha_min) {
          const float w = T[k] * alpha;
          cr[k] = cr[k] + w * s_r[i];
          cg[k] = cg[k] + w * s_g[i];
          cbl[k] = cbl[k] + w * s_b[i];
          if (w > bw[k]) {
            bw[k] = w;
            lab[k] = __float2int_rn(s_lab[i]);
          }
          T[k] = T[k] * (1.0f - alpha);
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kMaxPixelsPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    if (p >= npix) continue;
    const int yy = trow * tile_size + p / tile_size;
    const int xx = tcol * tile_size + p % tile_size;
    if (yy >= height || xx >= width) continue;
    const size_t o = static_cast<size_t>(yy) * width + xx;
    rgb[3 * o + 0] = cr[k];
    rgb[3 * o + 1] = cg[k];
    rgb[3 * o + 2] = cbl[k];
    trans[o] = T[k];
    if (with_labels) {
      best_w[o] = bw[k];
      label[o] = lab[k];
    }
  }
}

}  // namespace
