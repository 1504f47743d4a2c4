// Kernel B1: forward front-to-back compositing of one image tile per block,
// with the optional best-weight label channel.
//
// Replaces: gsplat_tpu/render/blend_pallas.py::_fwd_win_kernel (Pallas,
// reached through blend_windows_fwd), which walks 8-aligned windows of a
// materialised, lane-padded [B, 128] parameter array and carries the
// per-pixel state in the resident output block.
//
// Design: one block of 256 threads per tile (tile_size^2 <= 1024 pixels, at
// most 4 a thread), because the early stop needs the whole tile's T. The
// block walks its tile's [start, end) range of the depth-sorted stream in
// batches of `chunk` instances, the batches of the JAX kernel: a batch runs
// only while the tile's max T, over all tile_size^2 pixels (those past the
// image's right and bottom edges too, as the JAX kernel's whole-tile max),
// is at least early_eps (__syncthreads_count at each batch boundary). Each
// warp owns a compact strip of the tile, 32x4 pixels at 32-px tiles: at a
// tile size that is a multiple of 8 lane l's k-th pixel lies in 8x4 patch
// k, so a small splat's live pixels fall in few of a lane's pixels and the
// warp runs the alpha path only for the k some lane needs; other sizes map
// row-major. A batch is staged in sub-batches of 64 instances:
//   1. the 10 parameter columns, gathered from the [N, 16] table at the
//      sorted gaussian indices, and each instance's q_cut()
//      (blend_cull.cuh) into shared memory;
//   2. each warp tests the sub-batch against its strip with the
//      conservative rect_skips() of blend_cull.cuh, two instances a lane,
//      ballots the instances that reach it and walks those in stream order;
//      each pixel tests its q against q_cut() before expf.
// The composite stays in registers: w = T * alpha, C += w * c, T *= 1 -
// alpha; the label moves on a strict w > best_w, so the front-most maximum
// wins, as in the JAX kernels and the oracle. Warps share nothing but the
// staged parameters, so a sub-batch costs two barriers. Output goes
// straight to image layout, cropped at the image edge; an empty tile writes
// T = 1, RGB = 0, label UNLABELED.
//
// The interleaved tile lattice of the sharded render: block t is a shard's
// local tile (trow, tcol), global tile (row_phase + trow * row_stride,
// col_phase + tcol * col_stride). Pixel positions, and so the staged
// tile-local means, take the global tile's origin, as the TPU kernel's
// window rcg (blend_pallas.py:92-106); the stores go to the local tile of
// the shard's [tiles_y * ts, tiles_x * ts] image. At strides of 1 and phases
// of 0 both are the single-device tile.
//
// Exactness: a pair is skipped only where blend_cull.cuh proves that
// alpha < alpha_min, and such a pair changes nothing; every other pair is
// computed as blend_pallas.py::_chunk_alphas does, in the plain version's
// order (tile-local dx, dy, the same q, IEEE expf, not __expf; this file is
// built with -fmad=false). So T, RGB, the best weight and the label do not
// depend on the skip: kernel B2 (blend_bwd.cu) replays this T and every
// early-stop decision bit for bit, B5 (blend_vis.cu) equals this kernel at
// early_eps 0 bit for bit, and the plain version (render/blend.py) differs
// only where its exp does.
//
// Bound on the card: bytes (the table, the stream and the image), with the
// operations close behind: the q test of the pixels inside each instance's
// cutoff box and an expf and ~9 f32 operations per pair past the alpha cut.
// What this design still pays beyond that, per instance: its staging, the 8
// strip tests, and in every warp it reaches the q test of all the warp's
// 128 pixels and the alpha path for each 8x4 patch any lane needs; two
// barriers per 64 instances. One block per tile leaves the blocks uneven:
// each takes time in step with its tile's length.

#include <cuda_runtime.h>

#include "blend_cull.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPixelsPerThread = 4;   // tile_size^2 <= 1024
constexpr int kSub = 64;                 // instances per staged sub-batch
constexpr int kUnlabeled = -1;
constexpr unsigned kFull = 0xffffffffu;

// parameter columns of the [N, 16] table (render/blend.py P_*)
constexpr int P_MX = 0, P_MY = 1, P_CA = 2, P_CB = 3, P_CC = 4, P_OP = 5,
              P_R = 6, P_G = 7, P_B = 8, P_LABEL = 10, PARAM_ROWS = 16;

// a staged sub-batch: tile-local means, conic, opacity, q_cut(), colour
// and label
struct Staged {
  float mx[kSub], my[kSub], ca[kSub], cb[kSub], cc[kSub], op[kSub],
      thr[kSub], r[kSub], g[kSub], b[kSub];
  int lab[kSub];
};

// The pixel-centre rectangle of warp w's pixels p0..p1 (row-major in the
// tile): its rows, and the columns it covers (all when it spans several
// rows). False when the warp has no pixel.
__device__ __forceinline__ bool strip_rect(int w, int ppt, int npix,
                                           int tile_size, float& cx0,
                                           float& cx1, float& cy0,
                                           float& cy1) {
  const int p0 = w * 32 * ppt;
  if (p0 >= npix) return false;
  const int p1 = min(p0 + 32 * ppt, npix) - 1;
  const int r0 = p0 / tile_size, r1 = p1 / tile_size;
  const int c0 = r0 == r1 ? p0 - r0 * tile_size : 0;
  const int c1 = r0 == r1 ? p1 - r1 * tile_size : tile_size - 1;
  cx0 = static_cast<float>(c0) + 0.5f;
  cx1 = static_cast<float>(c1) + 0.5f;
  cy0 = static_cast<float>(r0) + 0.5f;
  cy1 = static_cast<float>(r1) + 0.5f;
  return true;
}

// At most 64 registers, so that 4 blocks fit an SM and the 475 tiles of an
// 800x608 frame run in one wave on 132 SMs. kLabels: the best weight and
// its label are kept and written.
template <bool kLabels>
__global__ void __launch_bounds__(kThreads, 4) blend_fwd_kernel(
    const float* __restrict__ ptab, const int* __restrict__ inst_gauss,
    const int* __restrict__ bounds, int tiles_x, int tile_size, int width,
    int height, int chunk, int row_stride, int row_phase, int col_stride,
    int col_phase, float alpha_min, float alpha_max, float early_eps,
    float* __restrict__ rgb, float* __restrict__ trans,
    float* __restrict__ best_w, int* __restrict__ label) {
  __shared__ Staged s;

  const int tile = blockIdx.x;
  const int trow = tile / tiles_x;
  const int tcol = tile - trow * tiles_x;
  const float x0f =
      static_cast<float>((col_phase + tcol * col_stride) * tile_size);
  const float y0f =
      static_cast<float>((row_phase + trow * row_stride) * tile_size);
  const int npix = tile_size * tile_size;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ppt = (npix + kThreads - 1) / kThreads;   // pixels per thread
  // At a tile size that is a multiple of 8, warp w owns rows [w R, w R + R)
  // (R = 32 ppt / tile_size) and lane l's k-th pixel is column k pw + l % pw
  // of row w R + l / pw (pw = 32 / R: an 8x4 patch per k at 32 px). Other
  // sizes map row-major. Either way the warp owns pixels [w 32 ppt,
  // (w + 1) 32 ppt) of the tile, as strip_rect assumes.
  const bool patches = tile_size % 8 == 0;
  const int rows_w = patches ? 32 * ppt / tile_size : 1;
  const int pw = 32 / rows_w;
  const float log_amin = logf(alpha_min);
  float sx0 = 0.0f, sx1 = 0.0f, sy0 = 0.0f, sy1 = 0.0f;
  const bool has_strip =
      strip_rect(warp, ppt, npix, tile_size, sx0, sx1, sy0, sy1);

  int pix[kMaxPixelsPerThread];
  float px[kMaxPixelsPerThread], py[kMaxPixelsPerThread];
  float T[kMaxPixelsPerThread], cr[kMaxPixelsPerThread],
      cg[kMaxPixelsPerThread], cbl[kMaxPixelsPerThread],
      bw[kMaxPixelsPerThread];
  int lab[kMaxPixelsPerThread];
#pragma unroll
  for (int k = 0; k < kMaxPixelsPerThread; ++k) {
    const int p = patches ? (warp * rows_w + lane / pw) * tile_size +
                                k * pw + lane % pw
                          : warp * 32 * ppt + k * 32 + lane;
    pix[k] = (k < ppt && p < npix) ? p : -1;
    const int pp = pix[k] < 0 ? 0 : p;
    px[k] = static_cast<float>(pp % tile_size) + 0.5f;
    py[k] = static_cast<float>(pp / tile_size) + 0.5f;
    T[k] = 1.0f;
    cr[k] = cg[k] = cbl[k] = bw[k] = 0.0f;
    lab[k] = kUnlabeled;
  }

  const int start = bounds[tile];
  const int end = bounds[tile + 1];
  for (int b0 = start; b0 < end; b0 += chunk) {
    // Also the barrier that keeps the previous sub-batch's readers of
    // shared memory ahead of this batch's writers.
    float tmax = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxPixelsPerThread; ++k) {
      if (pix[k] >= 0) tmax = fmaxf(tmax, T[k]);
    }
    if (__syncthreads_count(tmax >= early_eps) == 0) break;
    const int nb = min(chunk, end - b0);
    for (int s0 = 0; s0 < nb; s0 += kSub) {
      const int ns = min(kSub, nb - s0);
      if (s0 > 0) __syncthreads();
      // 1. stage
      for (int i = threadIdx.x; i < ns; i += kThreads) {
        const float* row =
            ptab + static_cast<size_t>(inst_gauss[b0 + s0 + i]) * PARAM_ROWS;
        s.mx[i] = row[P_MX] - x0f;
        s.my[i] = row[P_MY] - y0f;
        s.ca[i] = row[P_CA];
        s.cb[i] = row[P_CB];
        s.cc[i] = row[P_CC];
        s.op[i] = row[P_OP];
        s.thr[i] = cull::q_cut(row[P_OP], log_amin);
        s.r[i] = row[P_R];
        s.g[i] = row[P_G];
        s.b[i] = row[P_B];
        s.lab[i] = __float2int_rn(row[P_LABEL]);
      }
      __syncthreads();
      if (!has_strip) continue;
      // 2. the instances that reach this warp's strip, in stream order
      for (int ib = 0; ib < ns; ib += 32) {
        const int il = ib + lane;
        const bool live =
            il < ns && !cull::rect_skips(s.mx[il], s.my[il], s.ca[il],
                                         s.cb[il], s.cc[il], s.thr[il], sx0,
                                         sx1, sy0, sy1);
        unsigned todo = __ballot_sync(kFull, live);
        while (todo != 0u) {
          const int i = ib + __ffs(todo) - 1;
          todo &= todo - 1u;
          const float mx = s.mx[i], my = s.my[i], ca = s.ca[i],
                      cb2 = 2.0f * s.cb[i], cc = s.cc[i], op = s.op[i],
                      thr = s.thr[i];
#pragma unroll
          for (int k = 0; k < kMaxPixelsPerThread; ++k) {
            if (pix[k] < 0) continue;
            const float dx = px[k] - mx;
            const float dy = py[k] - my;
            const float q = (ca * dx + cb2 * dy) * dx + cc * dy * dy;
            if (q > thr) continue;   // cut for certain
            const float alpha = fminf(op * expf(-0.5f * q), alpha_max);
            if (alpha >= alpha_min) {
              const float w = T[k] * alpha;
              cr[k] = cr[k] + w * s.r[i];
              cg[k] = cg[k] + w * s.g[i];
              cbl[k] = cbl[k] + w * s.b[i];
              if (kLabels && w > bw[k]) {
                bw[k] = w;
                lab[k] = s.lab[i];
              }
              T[k] = T[k] * (1.0f - alpha);
            }
          }
        }
      }
    }
  }

  // the stores
#pragma unroll
  for (int k = 0; k < kMaxPixelsPerThread; ++k) {
    const int p = pix[k];
    if (p < 0) continue;
    const int yy = trow * tile_size + p / tile_size;
    const int xx = tcol * tile_size + p % tile_size;
    if (yy >= height || xx >= width) continue;
    const size_t o = static_cast<size_t>(yy) * width + xx;
    rgb[3 * o + 0] = cr[k];
    rgb[3 * o + 1] = cg[k];
    rgb[3 * o + 2] = cbl[k];
    trans[o] = T[k];
    if (kLabels) {
      best_w[o] = bw[k];
      label[o] = lab[k];
    }
  }
}

}  // namespace

extern "C" int gsplat_blend_fwd(
    const void* ptab, const void* inst_gauss, const void* bounds,
    int num_tiles, int tiles_x, int tile_size, int width, int height,
    int chunk, int row_stride, int row_phase, int col_stride, int col_phase,
    float alpha_min, float alpha_max, float early_eps, int with_labels,
    void* rgb, void* trans, void* best_w, void* label, void* stream) {
  if (num_tiles > 0) {
    auto kernel = with_labels ? blend_fwd_kernel<true>
                              : blend_fwd_kernel<false>;
    kernel<<<num_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(ptab),
        static_cast<const int*>(inst_gauss),
        static_cast<const int*>(bounds), tiles_x, tile_size, width, height,
        chunk, row_stride, row_phase, col_stride, col_phase, alpha_min,
        alpha_max, early_eps, static_cast<float*>(rgb),
        static_cast<float*>(trans), static_cast<float*>(best_w),
        static_cast<int*>(label));
  }
  return static_cast<int>(cudaGetLastError());
}

// The labelled kernel's (the render's) registers, local (spill) bytes,
// static shared memory and resident blocks an SM, for the logs.
extern "C" int gsplat_blend_fwd_occupancy(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, blend_fwd_kernel<true>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, blend_fwd_kernel<true>, kThreads, 0);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = blocks;
  return static_cast<int>(err);
}
