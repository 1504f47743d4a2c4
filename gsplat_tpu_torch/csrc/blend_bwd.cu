// Kernel B2: backward of the tile blend. Per-instance gradients of
// (mx, my, ca, cb, cc, opacity, r, g, b) for one image tile per block.
//
// Replaces: gsplat_tpu/render/blend_pallas.py::_bwd_win_kernel (Pallas,
// reached through blend_windows_bwd), which re-walks 8-aligned windows of
// the materialised [B, 128] parameter array, rebuilds each window's alphas
// with a cumulative product and writes [chunk, 16] gradient rows per window.
//
// Design: one block of 256 threads per tile, as B1 (csrc/blend_fwd.cu). The
// block walks its tile's [start, end) range FRONT TO BACK in batches of
// `chunk` instances, the batches B1 walked, and recomputes every alpha with
// B1's exact operations, so T is bit-identical to the forward's and the
// tile-wide early-stop test (__syncthreads_count(tmax >= early_eps) at each
// batch boundary) skips exactly the batches B1 skipped. The suffix-sum trick
// of the JAX kernel needs no reverse walk: each pixel forms the seed
// D = C.dC + T_final.dT from the forward's outputs and keeps the inclusive
// prefix p of w.cg; the suffix is S = D - p. Per live pair:
//   dq = -0.5 (w.cg - S alpha / (1 - alpha))   (0 where alpha is clamped)
// and the pair adds dq.dx, dq.dy, dq.dx^2, dq.dy^2, dq.dx.dy, dq and w.dC to
// the instance's 9 partial sums. Each warp owns a compact strip of the tile
// (pixel p = warp * 32 * ppt + k * 32 + lane), so a small splat touches few
// warps. A batch is staged in sub-batches of 64 instances: parameters in
// shared memory, and per instance a warp-shuffle sum of the 9 partials
// (skipped, with zeros written, when __any_sync finds no live pixel in the
// warp), then a fixed-order sum over the 8 warps through shared memory
// (8 x 9 x 64 f32 = 18 KB). The sums are therefore the same from run to run.
// The finish is blend_pallas.py:385-390: d_mx = -2(ca cx + cb cy), d_my =
// -2(cc cy + cb cx), d_cb = 2 sum dq dx dy, d_op = -2 sum dq / max(op, 1e-20).
//
// Output: drows [total_rows, 16] in sorted-stream order, columns 9-15 zero.
// Every row is written by the kernel: rows of batches that early stop
// skipped are zero, and rows past bounds[num_tiles] (the filtered slots at
// the end of the sorted stream) are zeroed by a grid-stride loop.
//
// Bound on the card: operations (one expf and ~14 f32 operations per
// evaluated pair, ~33 more per live pair; bytes are a few per instance).
// What the naive design pays beyond that is the reduction: 45 shuffles per
// instance in every warp that has a live pixel, and a block barrier per 64
// instances; redesigning it is later work.
//
// Exactness: built with -fmad=false, expf (not __expf), B1's operation order
// for alpha and T; the sums differ from the plain version's by association.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPixelsPerThread = 4;   // tile_size^2 <= 1024
constexpr int kSub = 64;                 // instances per staged sub-batch
constexpr int kParts = 9;                // partial sums per instance
constexpr int kCols = 9;                 // staged parameter columns
constexpr unsigned kFull = 0xffffffffu;

constexpr int P_MX = 0, P_MY = 1, P_CA = 2, P_CB = 3, P_CC = 4, P_OP = 5,
              P_R = 6, P_G = 7, P_B = 8, PARAM_ROWS = 16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads) blend_bwd_kernel(
    const float* __restrict__ ptab, const int* __restrict__ inst_gauss,
    const int* __restrict__ bounds, int num_tiles, int tiles_x,
    int tile_size, int width, int height, int chunk, float alpha_min,
    float alpha_max, float early_eps, const float* __restrict__ rgb,
    const float* __restrict__ trans, const float* __restrict__ drgb,
    const float* __restrict__ dtrans, int total_rows,
    float* __restrict__ drows) {
  __shared__ float s_par[kCols][kSub];
  __shared__ float s_red[kWarps][kParts][kSub];

  const int tile = blockIdx.x;
  const int trow = tile / tiles_x;
  const int tcol = tile - trow * tiles_x;
  const float x0f = static_cast<float>(tcol * tile_size);
  const float y0f = static_cast<float>(trow * tile_size);
  const int npix = tile_size * tile_size;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ppt = (npix + kThreads - 1) / kThreads;   // pixels per thread

  int pix[kMaxPixelsPerThread];
  float px[kMaxPixelsPerThread], py[kMaxPixelsPerThread];
  float T[kMaxPixelsPerThread], P[kMaxPixelsPerThread],
      D[kMaxPixelsPerThread], gr[kMaxPixelsPerThread],
      gg[kMaxPixelsPerThread], gb[kMaxPixelsPerThread];
#pragma unroll
  for (int k = 0; k < kMaxPixelsPerThread; ++k) {
    const int p = warp * 32 * ppt + k * 32 + lane;
    pix[k] = (k < ppt && p < npix) ? p : -1;
    const int pp = pix[k] < 0 ? 0 : p;
    px[k] = static_cast<float>(pp % tile_size) + 0.5f;
    py[k] = static_cast<float>(pp / tile_size) + 0.5f;
    T[k] = 1.0f;
    P[k] = 0.0f;
    D[k] = gr[k] = gg[k] = gb[k] = 0.0f;
    if (pix[k] >= 0) {
      const int yy = trow * tile_size + pp / tile_size;
      const int xx = tcol * tile_size + pp % tile_size;
      if (yy < height && xx < width) {
        const size_t o = static_cast<size_t>(yy) * width + xx;
        gr[k] = drgb[3 * o + 0];
        gg[k] = drgb[3 * o + 1];
        gb[k] = drgb[3 * o + 2];
        D[k] = rgb[3 * o + 0] * gr[k] + rgb[3 * o + 1] * gg[k] +
               rgb[3 * o + 2] * gb[k] + trans[o] * dtrans[o];
      }
    }
  }

  const int start = bounds[tile];
  const int end = bounds[tile + 1];
  int stop = end;
  for (int b0 = start; b0 < end; b0 += chunk) {
    float tmax = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxPixelsPerThread; ++k) {
      if (pix[k] >= 0) tmax = fmaxf(tmax, T[k]);
    }
    if (__syncthreads_count(tmax >= early_eps) == 0) {
      stop = b0;
      break;
    }
    const int nb = min(chunk, end - b0);
    for (int s0 = 0; s0 < nb; s0 += kSub) {
      const int ns = min(kSub, nb - s0);
      // the previous sub-batch's readers of s_par and s_red are done
      __syncthreads();
      for (int i = threadIdx.x; i < ns; i += kThreads) {
        const float* row =
            ptab + static_cast<size_t>(inst_gauss[b0 + s0 + i]) * PARAM_ROWS;
        s_par[0][i] = row[P_MX] - x0f;
        s_par[1][i] = row[P_MY] - y0f;
        s_par[2][i] = row[P_CA];
        s_par[3][i] = 2.0f * row[P_CB];
        s_par[4][i] = row[P_CC];
        s_par[5][i] = row[P_OP];
        s_par[6][i] = row[P_R];
        s_par[7][i] = row[P_G];
        s_par[8][i] = row[P_B];
      }
      __syncthreads();
      for (int i = 0; i < ns; ++i) {
        const float mx = s_par[0][i], my = s_par[1][i], ca = s_par[2][i],
                    cb2 = s_par[3][i], cc = s_par[4][i], op = s_par[5][i],
                    cr = s_par[6][i], cg = s_par[7][i], cbl = s_par[8][i];
        float a[kParts];
#pragma unroll
        for (int j = 0; j < kParts; ++j) a[j] = 0.0f;
        bool any = false;
#pragma unroll
        for (int k = 0; k < kMaxPixelsPerThread; ++k) {
          if (pix[k] < 0) continue;
          const float dx = px[k] - mx;
          const float dy = py[k] - my;
          const float q = (ca * dx + cb2 * dy) * dx + cc * dy * dy;
          const float raw = op * expf(-0.5f * q);
          const float alpha = fminf(raw, alpha_max);
          if (alpha >= alpha_min) {
            any = true;
            const float w = T[k] * alpha;
            const float cgrad = cr * gr[k] + cg * gg[k] + cbl * gb[k];
            const float contrib = w * cgrad;
            P[k] = P[k] + contrib;
            const float s = D[k] - P[k];
            const float one_m = 1.0f - alpha;
            const float dq = raw < alpha_max
                                 ? -0.5f * (contrib - s * (alpha / one_m))
                                 : 0.0f;
            const float t1 = dq * dx;
            const float t2 = dq * dy;
            a[0] += t1;
            a[1] += t2;
            a[2] += t1 * dx;
            a[3] += t2 * dy;
            a[4] += t1 * dy;
            a[5] += dq;
            a[6] += w * gr[k];
            a[7] += w * gg[k];
            a[8] += w * gb[k];
            T[k] = T[k] * one_m;
          }
        }
        if (__any_sync(kFull, any)) {
#pragma unroll
          for (int j = 0; j < kParts; ++j) a[j] = warp_sum(a[j]);
        }
        if (lane == 0) {
#pragma unroll
          for (int j = 0; j < kParts; ++j) s_red[warp][j][i] = a[j];
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < ns; i += kThreads) {
        float t[kParts];
#pragma unroll
        for (int j = 0; j < kParts; ++j) {
          float acc = 0.0f;
#pragma unroll
          for (int v = 0; v < kWarps; ++v) acc += s_red[v][j][i];
          t[j] = acc;
        }
        const float ca = s_par[2][i], cb = 0.5f * s_par[3][i],
                    cc = s_par[4][i], op = s_par[5][i];
        float* out = drows + static_cast<size_t>(b0 + s0 + i) * PARAM_ROWS;
        out[0] = -2.0f * ca * t[0] - 2.0f * cb * t[1];   // d_mx
        out[1] = -2.0f * cc * t[1] - 2.0f * cb * t[0];   // d_my
        out[2] = t[2];                                   // d_ca
        out[3] = 2.0f * t[4];                            // d_cb
        out[4] = t[3];                                   // d_cc
        out[5] = -2.0f * t[5] / fmaxf(op, 1e-20f);       // d_op
        out[6] = t[6];
        out[7] = t[7];
        out[8] = t[8];
#pragma unroll
        for (int j = kParts; j < PARAM_ROWS; ++j) out[j] = 0.0f;
      }
    }
  }

  // rows of the batches early stop skipped
  for (size_t j = static_cast<size_t>(stop) * PARAM_ROWS + threadIdx.x;
       j < static_cast<size_t>(end) * PARAM_ROWS; j += kThreads) {
    drows[j] = 0.0f;
  }
  // rows past the last tile: the filtered slots at the end of the stream
  const size_t tail0 = static_cast<size_t>(bounds[num_tiles]) * PARAM_ROWS;
  const size_t tail1 = static_cast<size_t>(total_rows) * PARAM_ROWS;
  for (size_t j = tail0 + static_cast<size_t>(blockIdx.x) * kThreads +
                  threadIdx.x;
       j < tail1; j += static_cast<size_t>(gridDim.x) * kThreads) {
    drows[j] = 0.0f;
  }
}

}  // namespace

extern "C" int gsplat_blend_bwd(
    const void* ptab, const void* inst_gauss, const void* bounds,
    int num_tiles, int tiles_x, int tile_size, int width, int height,
    int chunk, float alpha_min, float alpha_max, float early_eps,
    const void* rgb, const void* trans, const void* drgb, const void* dtrans,
    int total_rows, void* drows, void* stream) {
  if (num_tiles > 0) {
    blend_bwd_kernel<<<num_tiles, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(ptab),
        static_cast<const int*>(inst_gauss),
        static_cast<const int*>(bounds), num_tiles, tiles_x, tile_size,
        width, height, chunk, alpha_min, alpha_max, early_eps,
        static_cast<const float*>(rgb), static_cast<const float*>(trans),
        static_cast<const float*>(drgb), static_cast<const float*>(dtrans),
        total_rows, static_cast<float*>(drows));
  }
  return static_cast<int>(cudaGetLastError());
}
