// Kernel B5: the forward blend of kernel B1 with no early stop, plus each
// instance's maximum blend weight over its tile's pixels (the per-gaussian
// visibility evidence of the occlusion-aware vote).
//
// Replaces: gsplat_tpu/render/blend_pallas.py::_fwd_win_vis_kernel (Pallas,
// reached through blend_windows_vis), which walks every live window of the
// materialised [B, 128] parameter array and writes, per window row, the
// row's max blend weight and its original gaussian index into a
// [K * chunk, 8] array for a segment max outside the kernel.
//
// Design: one 256-thread block per 16x16 sub-tile, one pixel a thread: four
// blocks per 32-px tile (one at tile_size <= 16, partial sub-tiles at other
// sizes). The keys and tile ranges stay on the tile_size grid; each
// sub-tile block walks its whole tile's [start, end) range of the sorted
// stream in batches of 256 instances (B5 has no early stop, so `chunk`
// changes nothing and the kernel does not take it):
//   1. cull: thread i gathers instance i's mean, conic and opacity (one
//      32-byte sector of its [N, 16] table row) and tests it against the
//      sub-tile's pixel-centre rectangle with blend_cull.cuh's conservative
//      rect_skips();
//   2. compact: a ballot and the warps' counts give each survivor its slot,
//      in stream order, in shared memory;
//   3. per survivor: its colour and label are gathered (the survivors alone
//      read the row's second sector), and each of the 8 warps' strips
//      (16x2 pixels) is tested with rect_skips();
//   4. composite: each warp ballots which survivors reach its strip and
//      walks those in stream order; each pixel tests its q against q_cut()
//      before it calls expf, then composites as B1 does (w = T alpha,
//      C += w c, T *= 1 - alpha, label on a strict w > best_w). Per survivor
//      the warp's max weight (one __reduce_max_sync on the f32 bit pattern,
//      exact and order-free because w >= 0) goes into a shared-memory
//      atomicMax;
//   5. the block's max of each survivor goes to row b0 + i of inst_w with a
//      global atomicMax on the bits: max is order-free, so the four blocks
//      of a tile give the same row in any order and the rows are the same
//      from run to run. The C entry point zeroes inst_w first, so instances
//      no pixel reaches, and the filtered slots past bounds[num_tiles], stay
//      0.
// The max runs over all tile_size^2 pixels of the tile, also those past the
// image's right and bottom edges, as the JAX kernel's whole-tile blocks do;
// only the image stores are cropped. An empty tile writes T = 1, RGB = 0,
// label UNLABELED.
//
// Exactness: a pair is skipped only where blend_cull.cuh proves that
// alpha < alpha_min (its margins and why they suffice are stated there);
// every other pair is computed with B1's operations in B1's order (tile-
// local dx, dy from the tile origin, the same q, IEEE expf, -fmad=false).
// So T, RGB, the best weight, the label and the rows equal the plain
// version's (render/blend.py::_blend_tiles_vis_plain) wherever expf does.
//
// Bound on the card: the least work is the q test for the pixels inside
// each instance's cutoff box and an expf and ~10 f32 operations per pair
// past the alpha cut (operations, with the table rows as the bytes). What
// this design still pays beyond that: every sub-tile block stages and tests
// its whole tile's range (4 row gathers and cull tests per instance at 32-px
// tiles), so a block's time follows its tile's length and the busiest tile
// sets the kernel's; each batch costs four barriers; a warp spends a ballot
// per 32 survivors and the full q test on all 32 lanes of a strip it
// reaches.

#include <cuda_runtime.h>

#include "blend_cull.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSide = 16;          // sub-tile side: kSide^2 == kThreads
constexpr int kBatch = kThreads;   // instances staged per batch
constexpr int kStripRows = kSide / kWarps;
constexpr int kUnlabeled = -1;
constexpr unsigned kFull = 0xffffffffu;

// parameter columns of the [N, 16] table (render/blend.py P_*): mx, my,
// ca, cb | cc, op, r, g | b, valid, label, gid | 0 ...; a 64-byte row
constexpr int P_MX = 0, P_CC = 4, P_B = 8, PARAM_ROWS = 16;

__global__ void __launch_bounds__(kThreads) blend_vis_kernel(
    const float* __restrict__ ptab, const int* __restrict__ inst_gauss,
    const int* __restrict__ bounds, int tiles_x, int tile_size, int width,
    int height, float alpha_min, float alpha_max, int with_labels,
    float* __restrict__ rgb, float* __restrict__ trans,
    float* __restrict__ best_w, int* __restrict__ label,
    unsigned* __restrict__ inst_w) {
  // survivors of the batch, in stream order
  __shared__ float s_mx[kBatch], s_my[kBatch], s_ca[kBatch], s_cb[kBatch],
      s_cc[kBatch], s_op[kBatch], s_thr[kBatch], s_r[kBatch], s_g[kBatch],
      s_b[kBatch];
  __shared__ int s_lab[kBatch], s_gid[kBatch], s_row[kBatch];
  __shared__ unsigned s_wmax[kBatch];
  __shared__ unsigned char s_live[kWarps][kBatch];   // strip reached
  __shared__ int s_count[kWarps];

  const int per_side = (tile_size + kSide - 1) / kSide;
  const int nsub = per_side * per_side;
  const int tile = blockIdx.x / nsub;
  const int sub = blockIdx.x - tile * nsub;
  const int trow = tile / tiles_x;
  const int tcol = tile - trow * tiles_x;
  const float x0f = static_cast<float>(tcol * tile_size);
  const float y0f = static_cast<float>(trow * tile_size);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // the sub-tile's first and last pixel column and row in the tile
  const int sx0 = (sub % per_side) * kSide;
  const int sy0 = (sub / per_side) * kSide;
  const int sx1 = min(sx0 + kSide, tile_size) - 1;
  const int sy1 = min(sy0 + kSide, tile_size) - 1;
  const float cx0 = static_cast<float>(sx0) + 0.5f;
  const float cx1 = static_cast<float>(sx1) + 0.5f;
  const float cy0 = static_cast<float>(sy0) + 0.5f;
  const float cy1 = static_cast<float>(sy1) + 0.5f;
  // this thread's pixel: warp w owns rows sy0 + 2w, sy0 + 2w + 1
  const int lx = sx0 + (threadIdx.x % kSide);
  const int ly = sy0 + (threadIdx.x / kSide);
  const bool on = lx <= sx1 && ly <= sy1;
  const float px = static_cast<float>(lx) + 0.5f;
  const float py = static_cast<float>(ly) + 0.5f;

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cbl = 0.0f, bw = 0.0f;
  int lab = kUnlabeled;
  const float log_amin = logf(alpha_min);
  s_wmax[threadIdx.x] = 0u;

  const int start = bounds[tile];
  const int end = bounds[tile + 1];
  for (int b0 = start; b0 < end; b0 += kBatch) {
    const int n = min(kBatch, end - b0);
    // 1. cull against the sub-tile
    bool keep = false;
    int g = 0;
    float mx = 0.0f, my = 0.0f, ca = 0.0f, cb = 0.0f, cc = 0.0f, op = 0.0f,
          thr = 0.0f;
    if (threadIdx.x < n) {
      g = inst_gauss[b0 + threadIdx.x];
      const float* row = ptab + static_cast<size_t>(g) * PARAM_ROWS;
      const float4 a = *reinterpret_cast<const float4*>(row + P_MX);
      const float2 b = *reinterpret_cast<const float2*>(row + P_CC);
      mx = a.x - x0f;
      my = a.y - y0f;
      ca = a.z;
      cb = a.w;
      cc = b.x;
      op = b.y;
      thr = cull::q_cut(op, log_amin);
      keep = !cull::rect_skips(mx, my, ca, cb, cc, thr, cx0, cx1, cy0, cy1);
    }
    // 2. compact the survivors in stream order. The barrier also keeps the
    // previous batch's readers of the survivor arrays ahead of the writers.
    const unsigned ballot = __ballot_sync(kFull, keep);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int slot = 0, ns = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_count[w];
      slot += w < warp ? c : 0;
      ns += c;
    }
    if (keep) {
      const int k = slot + __popc(ballot & ((1u << lane) - 1u));
      s_mx[k] = mx;
      s_my[k] = my;
      s_ca[k] = ca;
      s_cb[k] = cb;
      s_cc[k] = cc;
      s_op[k] = op;
      s_thr[k] = thr;
      s_gid[k] = g;
      s_row[k] = b0 + static_cast<int>(threadIdx.x);
    }
    __syncthreads();
    if (ns == 0) continue;

    // 3. the survivors' colours and labels, and which strips they reach
    for (int k = threadIdx.x; k < ns; k += kThreads) {
      const float* row = ptab + static_cast<size_t>(s_gid[k]) * PARAM_ROWS;
      const float4 c0 = *reinterpret_cast<const float4*>(row + P_CC);
      const float4 c1 = *reinterpret_cast<const float4*>(row + P_B);
      s_r[k] = c0.z;
      s_g[k] = c0.w;
      s_b[k] = c1.x;
      s_lab[k] = __float2int_rn(c1.z);
    }
    for (int j = threadIdx.x; j < ns * kWarps; j += kThreads) {
      const int k = j / kWarps;
      const int w = j - k * kWarps;
      const int ry0 = sy0 + w * kStripRows;
      const int ry1 = min(ry0 + kStripRows - 1, sy1);
      bool live = false;
      if (ry0 <= sy1) {
        live = !cull::rect_skips(
            s_mx[k], s_my[k], s_ca[k], s_cb[k], s_cc[k], s_thr[k], cx0, cx1,
            static_cast<float>(ry0) + 0.5f, static_cast<float>(ry1) + 0.5f);
      }
      s_live[w][k] = live;
    }
    __syncthreads();

    // 4. composite the survivors that reach this warp's strip
    for (int kb = 0; kb < ns; kb += 32) {
      unsigned todo =
          __ballot_sync(kFull, kb + lane < ns && s_live[warp][kb + lane]);
      while (todo != 0u) {
        const int k = kb + __ffs(todo) - 1;
        todo &= todo - 1u;
        float w = 0.0f;
        if (on) {
          const float dx = px - s_mx[k];
          const float dy = py - s_my[k];
          const float cb2 = 2.0f * s_cb[k];
          const float q = (s_ca[k] * dx + cb2 * dy) * dx + s_cc[k] * dy * dy;
          if (!(q > s_thr[k])) {
            const float alpha = fminf(s_op[k] * expf(-0.5f * q), alpha_max);
            if (alpha >= alpha_min) {
              w = T * alpha;
              cr = cr + w * s_r[k];
              cg = cg + w * s_g[k];
              cbl = cbl + w * s_b[k];
              if (w > bw) {
                bw = w;
                lab = s_lab[k];
              }
              T = T * (1.0f - alpha);
            }
          }
        }
        const unsigned m = __reduce_max_sync(kFull, __float_as_uint(w));
        if (lane == 0 && m != 0u) atomicMax(&s_wmax[k], m);
      }
    }
    __syncthreads();

    // 5. the block's max of each survivor into its row
    for (int k = threadIdx.x; k < ns; k += kThreads) {
      const unsigned m = s_wmax[k];
      if (m != 0u) {
        atomicMax(inst_w + s_row[k], m);
        s_wmax[k] = 0u;
      }
    }
  }

  if (!on) return;
  const int yy = trow * tile_size + ly;
  const int xx = tcol * tile_size + lx;
  if (yy >= height || xx >= width) return;
  const size_t o = static_cast<size_t>(yy) * width + xx;
  rgb[3 * o + 0] = cr;
  rgb[3 * o + 1] = cg;
  rgb[3 * o + 2] = cbl;
  trans[o] = T;
  if (with_labels) {
    best_w[o] = bw;
    label[o] = lab;
  }
}

}  // namespace

// inst_w has `total` = B rows: all are zeroed first, then the blocks raise
// the rows of their tiles' ranges, so the filtered slots stay 0 without the
// host reading bounds[num_tiles] back.
extern "C" int gsplat_blend_vis(
    const void* ptab, const void* inst_gauss, const void* bounds,
    int num_tiles, int tiles_x, int tile_size, int width, int height,
    float alpha_min, float alpha_max, int with_labels, void* rgb,
    void* trans, void* best_w, void* label, void* inst_w, int total,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total > 0) {
    cudaError_t err = cudaMemsetAsync(inst_w, 0,
                                      static_cast<size_t>(total) * 4, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (num_tiles > 0) {
    const int per_side = (tile_size + kSide - 1) / kSide;
    blend_vis_kernel<<<num_tiles * per_side * per_side, kThreads, 0, s>>>(
        static_cast<const float*>(ptab),
        static_cast<const int*>(inst_gauss),
        static_cast<const int*>(bounds), tiles_x, tile_size, width, height,
        alpha_min, alpha_max, with_labels, static_cast<float*>(rgb),
        static_cast<float*>(trans), static_cast<float*>(best_w),
        static_cast<int*>(label), static_cast<unsigned*>(inst_w));
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernel's registers, local (spill) bytes, static shared memory and
// resident blocks an SM, for the logs.
extern "C" int gsplat_blend_vis_occupancy(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, blend_vis_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, blend_vis_kernel, kThreads, 0);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = blocks;
  return static_cast<int>(err);
}
