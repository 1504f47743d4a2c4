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
// `chunk` instances, the batches B1 walked, and recomputes every alpha that
// can pass the cut with B1's exact operations, so T is bit-identical to the
// forward's and the tile-wide early-stop test (__syncthreads_count(tmax >=
// early_eps) at each batch boundary) skips exactly the batches B1 skipped.
// The suffix-sum trick of the JAX kernel needs no reverse walk: each pixel
// forms the seed D = C.dC + T_final.dT from the forward's outputs and keeps
// the inclusive prefix p of w.cg; the suffix is S = D - p. Per live pair:
//   dq = -0.5 (w.cg - S alpha / (1 - alpha))   (0 where alpha is clamped)
// and the pair adds dq.dx, dq.dy, dq.dx^2, dq.dy^2, dq.dx.dy, dq and w.dC to
// the instance's 9 partial sums. Each warp owns a compact strip of the tile
// (32x4 pixels at 32-px tiles; each lane's k-th pixel in an 8x4 patch k).
// A batch is staged in sub-batches of 64 instances:
//   1. parameters and each instance's q_cut() (blend_cull.cuh) into shared
//      memory;
//   2. each (instance, warp strip) pair is tested with the conservative
//      rect_skips() of blend_cull.cuh, two tests a thread;
//   3. each warp ballots which instances reach its strip and walks those in
//      stream order; each pixel tests its q against q_cut() before expf. A
//      warp with a live pixel reduces its 9 partials with a butterfly that
//      halves the values each lane holds at every step (12 shuffles, not
//      9 x 5 = 45), after which lanes 0, 2, 4, 8, 10, 16, 18, 20 and 24 hold
//      the 9 warp sums; a warp with none writes zeros. A warp whose strip
//      the instance misses writes nothing;
//   4. thread i sums instance i's partials over the warps that reached it,
//      in warp order, and writes the row. Skipping a warp adds the same as
//      adding its zeros (the sum starts at +0, so it is never -0), so the
//      sums stay in a fixed order and the rows are the same from run to
//      run.
// The finish is blend_pallas.py:385-390: d_mx = -2(ca cx + cb cy), d_my =
// -2(cc cy + cb cx), d_cb = 2 sum dq dx dy, d_op = -2 sum dq / max(op, 1e-20).
//
// Output: drows [total_rows, 16] in sorted-stream order, columns 9-15 zero.
// Every row is written by the kernel: rows of batches that early stop
// skipped are zero, and rows past bounds[num_tiles] (the filtered slots at
// the end of the sorted stream) are zeroed by a grid-stride loop.
//
// Exactness: a pair is skipped only where blend_cull.cuh proves alpha <
// alpha_min (its margins and why they suffice are stated there); the others
// are computed with B1's operations in B1's order (-fmad=false, expf, not
// __expf), so T is replayed bit for bit and every early-stop decision equals
// B1's; the sums differ from the plain version's by association.
//
// Bound on the card: operations (the q test of the pixels inside each
// instance's cutoff box, one expf and ~27 f32 operations per pair past the
// cut; bytes are a few per instance). What this design still pays beyond
// that, per instance: the 8 strip tests, and in every warp it reaches the q
// test of all the warp's 128 pixels, the alpha path for each 8x4 patch any
// lane needs and the 12-shuffle butterfly; four barriers per 64 instances.
// One block per tile (the early stop needs the whole tile's T) leaves the
// blocks uneven: each takes time in step with its tile's length.

#include <cuda_runtime.h>

#include "blend_cull.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPixelsPerThread = 4;   // tile_size^2 <= 1024
constexpr int kSub = 64;                 // instances per staged sub-batch
constexpr int kParts = 9;                // partial sums per instance
constexpr int kCols = 9;                 // staged parameter columns
constexpr unsigned kFull = 0xffffffffu;
// the lanes that hold a warp sum after warp_sums(): 0, 2, 4, 8, 10, 16, 18,
// 20, 24, holding sums 0-8
constexpr unsigned kSumLanes = 0x01150515u;

constexpr int P_MX = 0, P_MY = 1, P_CA = 2, P_CB = 3, P_CC = 4, P_OP = 5,
              P_R = 6, P_G = 7, P_B = 8, PARAM_ROWS = 16;

// One step of the halving butterfly: a lane holding n values pairs value i
// with value i + h (h = ceil(n / 2); 0 past n) and exchanges with lane ^ o;
// the lower lane keeps the sums of the first h, the upper of the last. The
// arrays hold one slot more than the 9 partials, so v[i + h] stays in range.
template <int kN>
__device__ __forceinline__ void halve(float (&v)[kParts + 1], int o,
                                      bool upper) {
  constexpr int kH = (kN + 1) / 2;
#pragma unroll
  for (int i = 0; i < kH; ++i) {
    const float lo = v[i];
    const float hi = i + kH < kN ? v[i + kH] : 0.0f;
    const float got = __shfl_xor_sync(kFull, upper ? lo : hi, o);
    v[i] = (upper ? hi : lo) + got;
  }
}

// The warp sums of the 9 partials in 12 shuffles: after the steps 16, 8, 4,
// 2 (9 -> 5 -> 3 -> 2 -> 1 values a lane) and a last full exchange, lane l
// holds sum 5 b4 + 3 b3 + 2 b2 + b1 (b the bits of l) where kSumLanes has
// bit l set. Returns that sum's index.
__device__ __forceinline__ int warp_sums(float (&v)[kParts + 1], int lane) {
  halve<9>(v, 16, lane & 16);
  halve<5>(v, 8, lane & 8);
  halve<3>(v, 4, lane & 4);
  halve<2>(v, 2, lane & 2);
  v[0] = v[0] + __shfl_xor_sync(kFull, v[0], 1);
  return ((lane & 16) ? 5 : 0) + ((lane & 8) ? 3 : 0) + ((lane & 4) ? 2 : 0) +
         ((lane & 2) ? 1 : 0);
}

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

// At most 64 registers (a few spill), so that 4 blocks fit an SM and the
// 475 tiles of an 800x608 frame run in one wave on 132 SMs; unbounded the
// kernel takes 93 and fits 2 blocks an SM, and runs slower
// (utils/blend_probe.py times both).
__global__ void __launch_bounds__(kThreads, 4) blend_bwd_kernel(
    const float* __restrict__ ptab, const int* __restrict__ inst_gauss,
    const int* __restrict__ bounds, int num_tiles, int tiles_x,
    int tile_size, int width, int height, int chunk, int row_stride,
    int row_phase, int col_stride, int col_phase, float alpha_min,
    float alpha_max, float early_eps, const float* __restrict__ rgb,
    const float* __restrict__ trans, const float* __restrict__ drgb,
    const float* __restrict__ dtrans, int total_rows,
    float* __restrict__ drows) {
  __shared__ float s_par[kCols][kSub];
  __shared__ float s_thr[kSub];
  __shared__ unsigned char s_live[kWarps][kSub];   // strip reached
  __shared__ float s_red[kWarps][kParts][kSub];

  const int tile = blockIdx.x;
  const int trow = tile / tiles_x;
  const int tcol = tile - trow * tiles_x;
  // pixel positions at the global tile of the sharded render's lattice,
  // reads of the image at the shard's local tile (blend_fwd.cu)
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
  // of row w R + l / pw (pw = 32 / R: an 8x4 patch per k at 32 px): a small
  // splat's live pixels then fall in few k, and the live path runs for a k
  // only when some lane needs it. Other sizes map row-major. Either way the
  // warp owns pixels [w 32 ppt, (w + 1) 32 ppt) of the tile, as strip_rect
  // assumes.
  const bool patches = tile_size % 8 == 0;
  const int rows_w = patches ? 32 * ppt / tile_size : 1;
  const int pw = 32 / rows_w;
  const float log_amin = logf(alpha_min);

  int pix[kMaxPixelsPerThread];
  float px[kMaxPixelsPerThread], py[kMaxPixelsPerThread];
  float T[kMaxPixelsPerThread], P[kMaxPixelsPerThread],
      D[kMaxPixelsPerThread], gr[kMaxPixelsPerThread],
      gg[kMaxPixelsPerThread], gb[kMaxPixelsPerThread];
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
      // 1. stage; the barrier keeps the previous sub-batch's readers of
      // shared memory ahead of this one's writers
      __syncthreads();
      for (int i = threadIdx.x; i < ns; i += kThreads) {
        const float* row =
            ptab + static_cast<size_t>(inst_gauss[b0 + s0 + i]) * PARAM_ROWS;
        s_par[0][i] = row[P_MX] - x0f;
        s_par[1][i] = row[P_MY] - y0f;
        s_par[2][i] = row[P_CA];
        s_par[3][i] = row[P_CB];
        s_par[4][i] = row[P_CC];
        s_par[5][i] = row[P_OP];
        s_par[6][i] = row[P_R];
        s_par[7][i] = row[P_G];
        s_par[8][i] = row[P_B];
        s_thr[i] = cull::q_cut(row[P_OP], log_amin);
      }
      __syncthreads();
      // 2. which warp strips each instance reaches
      for (int j = threadIdx.x; j < ns * kWarps; j += kThreads) {
        const int i = j / kWarps;
        const int w = j - i * kWarps;
        float cx0, cx1, cy0, cy1;
        bool live = false;
        if (strip_rect(w, ppt, npix, tile_size, cx0, cx1, cy0, cy1)) {
          live = !cull::rect_skips(s_par[0][i], s_par[1][i], s_par[2][i],
                                   s_par[3][i], s_par[4][i], s_thr[i], cx0,
                                   cx1, cy0, cy1);
        }
        s_live[w][i] = live;
      }
      __syncthreads();
      // 3. this warp's partial sums of the instances that reach its strip
      for (int ib = 0; ib < ns; ib += 32) {
        unsigned todo =
            __ballot_sync(kFull, ib + lane < ns && s_live[warp][ib + lane]);
        while (todo != 0u) {
          const int i = ib + __ffs(todo) - 1;
          todo &= todo - 1u;
          const float mx = s_par[0][i], my = s_par[1][i], ca = s_par[2][i],
                      cb2 = 2.0f * s_par[3][i], cc = s_par[4][i],
                      op = s_par[5][i], cr = s_par[6][i], cg = s_par[7][i],
                      cbl = s_par[8][i], thr = s_thr[i];
          float a[kParts + 1];
#pragma unroll
          for (int j = 0; j <= kParts; ++j) a[j] = 0.0f;
          bool any = false;
#pragma unroll
          for (int k = 0; k < kMaxPixelsPerThread; ++k) {
            if (pix[k] < 0) continue;
            const float dx = px[k] - mx;
            const float dy = py[k] - my;
            const float q = (ca * dx + cb2 * dy) * dx + cc * dy * dy;
            if (q > thr) continue;   // cut for certain
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
            const int idx = warp_sums(a, lane);
            if ((kSumLanes >> lane) & 1u) s_red[warp][idx][i] = a[0];
          } else if (lane < kParts) {
            s_red[warp][lane][i] = 0.0f;
          }
        }
      }
      __syncthreads();
      // 4. the rows: partials summed over the warps that reached them
      for (int i = threadIdx.x; i < ns; i += kThreads) {
        float t[kParts];
#pragma unroll
        for (int j = 0; j < kParts; ++j) t[j] = 0.0f;
#pragma unroll
        for (int v = 0; v < kWarps; ++v) {
          if (!s_live[v][i]) continue;
#pragma unroll
          for (int j = 0; j < kParts; ++j) t[j] += s_red[v][j][i];
        }
        const float ca = s_par[2][i], cb = s_par[3][i], cc = s_par[4][i],
                    op = s_par[5][i];
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
    int chunk, int row_stride, int row_phase, int col_stride, int col_phase,
    float alpha_min, float alpha_max, float early_eps, const void* rgb,
    const void* trans, const void* drgb, const void* dtrans, int total_rows,
    void* drows, void* stream) {
  if (num_tiles > 0) {
    blend_bwd_kernel<<<num_tiles, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(ptab),
        static_cast<const int*>(inst_gauss),
        static_cast<const int*>(bounds), num_tiles, tiles_x, tile_size,
        width, height, chunk, row_stride, row_phase, col_stride, col_phase,
        alpha_min, alpha_max, early_eps,
        static_cast<const float*>(rgb), static_cast<const float*>(trans),
        static_cast<const float*>(drgb), static_cast<const float*>(dtrans),
        total_rows, static_cast<float*>(drows));
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernel's registers, local (spill) bytes, static shared memory and
// resident blocks an SM, for the logs.
extern "C" int gsplat_blend_bwd_occupancy(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, blend_bwd_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, blend_bwd_kernel, kThreads, 0);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = blocks;
  return static_cast<int>(err);
}
