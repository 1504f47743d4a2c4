// Kernel B1: forward front-to-back compositing of the image tiles, with the
// optional best-weight label channel.
//
// Replaces: gsplat_tpu/render/blend_pallas.py::_fwd_win_kernel (Pallas,
// reached through blend_windows_fwd), which walks 8-aligned windows of a
// materialised, lane-padded [B, 128] parameter array and carries the
// per-pixel state in the resident output block.
//
// The walk: a block of 256 threads composites one tile's pixels
// (tile_size^2 <= 1024, at most 4 a thread) over a range of the tile's
// [start, end) of the depth-sorted stream, in batches of `chunk` instances,
// the batches of the JAX kernel: a batch runs only while the tile's max T,
// over all tile_size^2 pixels (those past the image's right and bottom
// edges too, as the JAX kernel's whole-tile max), is at least early_eps
// (__syncthreads_count at each batch boundary). Each warp owns a compact
// strip of the tile, 32x4 pixels at 32-px tiles: at a tile size that is a
// multiple of 8 lane l's k-th pixel lies in 8x4 patch k, so a small splat's
// live pixels fall in few of a lane's pixels and the warp runs the alpha
// path only for the k some lane needs; other sizes map row-major. A batch
// is staged in sub-batches of 64 instances:
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
// One block a tile (seg_len 0): each block walks its whole tile, and so
// takes time in step with its tile's length. Kernel B2 (blend_bwd.cu)
// replays this walk's T and stop decisions bit for bit, so a launch whose
// table records a gradient takes this grid.
//
// Long tiles split (seg_len > 0, a multiple of chunk): a tile longer than
// split_above (>= seg_len) is cut into segments of seg_len instances from
// its start, so every cut is a batch boundary of the one-block walk, and
// the segments are walked by blocks of the same launch. Block t takes tile
// t's first segment, or the whole tile when it is not split, which then
// runs the one-block walk above, bit for bit; blocks [num_tiles, num_tiles
// + extra) take the segments after the first, tile by tile (each finds its
// tile by a scan of the tile lengths). The first segments come first, so
// that a dense tile's first segment has mostly stopped, and published its
// stop, before its later segments start. A segment block walks from T = 1
// and stops at a batch boundary once its own tile max T is below early_eps
// (the true T, its product with the T in front, is no larger), or once the
// first segment has published the tile's stop; it writes its partial
// composite to seg_f and seg_i. The last of a tile's blocks to finish (a
// per-tile counter, reset by that block) merges the partials in segment
// order, front to back: at each segment boundary the one-block walk's stop
// test on the composite so far; then C += T C_k, T *= T_k, and best weight
// T best_k where it beats the best so far (strictly, so the front-most
// maximum still wins), when segment k ran to its end and the tile max of
// the product is still at least early_eps, so that no boundary inside the
// segment could have stopped the walk; else it walks segment k again from
// the composite so far, which is what the one-block walk does there. Only
// the merge's products are associated differently from the one-block walk.
//
// The interleaved tile lattice of the sharded render: tile t is a shard's
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
// depend on the skip: B2 replays the one-block walk bit for bit, B5
// (blend_vis.cu) equals it at early_eps 0 bit for bit, and the plain
// versions (render/blend.py: _blend_tiles_fwd_plain, and
// _blend_tiles_fwd_split_plain for the split) differ only where their exp
// does.
//
// Bound on the card: bytes (the table, the stream and the image), with the
// operations close behind: the q test of the pixels inside each instance's
// cutoff box and an expf and ~9 f32 operations per pair past the alpha cut.
// What this design still pays beyond that, per instance: its staging, the 8
// strip tests, and in every warp it reaches the q test of all the warp's
// 128 pixels and the alpha path for each 8x4 patch any lane needs; two
// barriers per 64 instances. A split tile adds its segments' walks past the
// true stop (each stops at its own, or at the first segment's), a merge
// that reads 24 bytes a pixel of every segment, and at most one segment
// walked again, so the wrapper splits only a tile far longer than the
// others (render/blend.py::split_lengths). The split kernel spills under
// its register cap, and its blocks past the last segment scan the tile
// lengths before they leave: where it splits nothing it runs 4-10% behind
// the one-block kernel (PERF.md).

#include <cuda_runtime.h>

#include "blend_cull.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPixelsPerThread = 4;   // tile_size^2 <= 1024
constexpr int kSub = 64;                 // instances per staged sub-batch
constexpr int kUnlabeled = -1;
constexpr unsigned kFull = 0xffffffffu;
// a split tile's words in tile_state: its segments finished, the stop its
// first segment publishes, the block of its second segment
constexpr int kTileWords = 3;
// a segment's partial composite in seg_f: planes of R, G, B, T and the best
// weight; in seg_i: the plane of labels, then whether it ran to its end
constexpr int kPartPlanes = 5;

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

// The launch's arguments. The table, the stream and the bounds are read
// through the read-only path (__ldg), as the kernel never writes them.
struct FwdArgs {
  const float* ptab;
  const int* inst_gauss;
  const int* bounds;
  int num_tiles, tiles_x, tile_size, width, height, chunk;
  int row_stride, row_phase, col_stride, col_phase;
  float alpha_min, alpha_max, early_eps;
  int seg_len, split_above;
  int* tile_state;
  float* seg_f;
  int* seg_i;
  unsigned long long* stats;   // tiles split, segments, segments walked again
  float* rgb;
  float* trans;
  float* best_w;
  int* label;
};

// A thread's pixels (tile-local index, -1 for none; centre) and their
// composite, kept in registers.
struct Pixels {
  int pix[kMaxPixelsPerThread];
  float px[kMaxPixelsPerThread], py[kMaxPixelsPerThread];
  float T[kMaxPixelsPerThread], cr[kMaxPixelsPerThread],
      cg[kMaxPixelsPerThread], cbl[kMaxPixelsPerThread],
      bw[kMaxPixelsPerThread];
  int lab[kMaxPixelsPerThread];
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

// At a tile size that is a multiple of 8, warp w owns rows [w R, w R + R)
// (R = 32 ppt / tile_size) and lane l's k-th pixel is column k pw + l % pw
// of row w R + l / pw (pw = 32 / R: an 8x4 patch per k at 32 px). Other
// sizes map row-major. Either way the warp owns pixels [w 32 ppt,
// (w + 1) 32 ppt) of the tile, as strip_rect assumes. The composite starts
// at T = 1, RGB = 0, no label.
__device__ __forceinline__ void init_pixels(Pixels& st, int tile_size,
                                            int npix, int ppt, int warp,
                                            int lane) {
  const bool patches = tile_size % 8 == 0;
  const int rows_w = patches ? 32 * ppt / tile_size : 1;
  const int pw = 32 / rows_w;
#pragma unroll
  for (int k = 0; k < kMaxPixelsPerThread; ++k) {
    const int p = patches ? (warp * rows_w + lane / pw) * tile_size +
                                k * pw + lane % pw
                          : warp * 32 * ppt + k * 32 + lane;
    st.pix[k] = (k < ppt && p < npix) ? p : -1;
    const int pp = st.pix[k] < 0 ? 0 : p;
    st.px[k] = static_cast<float>(pp % tile_size) + 0.5f;
    st.py[k] = static_cast<float>(pp / tile_size) + 0.5f;
    st.T[k] = 1.0f;
    st.cr[k] = st.cg[k] = st.cbl[k] = st.bw[k] = 0.0f;
    st.lab[k] = kUnlabeled;
  }
}

__device__ __forceinline__ float thread_tmax(const Pixels& st) {
  float tmax = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxPixelsPerThread; ++k) {
    if (st.pix[k] >= 0) tmax = fmaxf(tmax, st.T[k]);
  }
  return tmax;
}

// Where a block stands: its tile's pixel origin, its warp's strip, and
// log(alpha_min).
struct Place {
  float x0f, y0f, log_amin, sx0, sx1, sy0, sy1;
  bool has_strip;
  int lane;
};

// The walk of instances [b_begin, b_end) of the stream into the composite,
// in batches of chunk from b_begin. A batch runs only while the tile's max T
// is at least early_eps and, where `quit` is given, while the word it
// points to is 0. True when the walk reached b_end.
template <bool kLabels>
__device__ __forceinline__ bool walk(const FwdArgs& a, Staged& s,
                                     int& s_quit, Pixels& st, const Place& pl,
                                     int b_begin, int b_end,
                                     const int* quit) {
  const int lane = pl.lane;
  for (int b0 = b_begin; b0 < b_end; b0 += a.chunk) {
    // Also the barrier that keeps the previous sub-batch's readers of
    // shared memory ahead of this batch's writers.
    const float tmax = thread_tmax(st);
    if (quit != nullptr && threadIdx.x == 0) {
      s_quit = *static_cast<const volatile int*>(quit);
    }
    if (__syncthreads_count(tmax >= a.early_eps) == 0) return false;
    if (quit != nullptr && s_quit != 0) return false;
    const int nb = min(a.chunk, b_end - b0);
    for (int s0 = 0; s0 < nb; s0 += kSub) {
      const int ns = min(kSub, nb - s0);
      if (s0 > 0) __syncthreads();
      // 1. stage
      for (int i = threadIdx.x; i < ns; i += kThreads) {
        const float* row =
            a.ptab +
            static_cast<size_t>(__ldg(a.inst_gauss + b0 + s0 + i)) *
                PARAM_ROWS;
        const float op = __ldg(row + P_OP);
        s.mx[i] = __ldg(row + P_MX) - pl.x0f;
        s.my[i] = __ldg(row + P_MY) - pl.y0f;
        s.ca[i] = __ldg(row + P_CA);
        s.cb[i] = __ldg(row + P_CB);
        s.cc[i] = __ldg(row + P_CC);
        s.op[i] = op;
        s.thr[i] = cull::q_cut(op, pl.log_amin);
        s.r[i] = __ldg(row + P_R);
        s.g[i] = __ldg(row + P_G);
        s.b[i] = __ldg(row + P_B);
        s.lab[i] = __float2int_rn(__ldg(row + P_LABEL));
      }
      __syncthreads();
      if (!pl.has_strip) continue;
      // 2. the instances that reach this warp's strip, in stream order
      for (int ib = 0; ib < ns; ib += 32) {
        const int il = ib + lane;
        const bool live =
            il < ns && !cull::rect_skips(s.mx[il], s.my[il], s.ca[il],
                                         s.cb[il], s.cc[il], s.thr[il],
                                         pl.sx0, pl.sx1, pl.sy0, pl.sy1);
        unsigned todo = __ballot_sync(kFull, live);
        while (todo != 0u) {
          const int i = ib + __ffs(todo) - 1;
          todo &= todo - 1u;
          const float mx = s.mx[i], my = s.my[i], ca = s.ca[i],
                      cb2 = 2.0f * s.cb[i], cc = s.cc[i], op = s.op[i],
                      thr = s.thr[i];
#pragma unroll
          for (int k = 0; k < kMaxPixelsPerThread; ++k) {
            if (st.pix[k] < 0) continue;
            const float dx = st.px[k] - mx;
            const float dy = st.py[k] - my;
            const float q = (ca * dx + cb2 * dy) * dx + cc * dy * dy;
            if (q > thr) continue;   // cut for certain
            const float alpha = fminf(op * expf(-0.5f * q), a.alpha_max);
            if (alpha >= a.alpha_min) {
              const float w = st.T[k] * alpha;
              st.cr[k] = st.cr[k] + w * s.r[i];
              st.cg[k] = st.cg[k] + w * s.g[i];
              st.cbl[k] = st.cbl[k] + w * s.b[i];
              if (kLabels && w > st.bw[k]) {
                st.bw[k] = w;
                st.lab[k] = s.lab[i];
              }
              st.T[k] = st.T[k] * (1.0f - alpha);
            }
          }
        }
      }
    }
  }
  return true;
}

// A tile longer than split_above (>= seg_len) is cut into segments of
// seg_len; any other is one.
__device__ __forceinline__ int num_segments(int n, const FwdArgs& a) {
  return n > a.split_above ? (n - 1) / a.seg_len + 1 : 1;
}

// Block num_tiles + e of a split launch walks segment e - P(t) + 1 of the
// tile t with P(t) <= e < P(t + 1), where P(t) counts the segments after
// the first of the tiles before t: a scan of the tile lengths, 256 tiles a
// round, until the round that holds e. False for a block past the last.
__device__ __forceinline__ bool find_segment(const FwdArgs& a, int e,
                                             int* s_word, int& tile,
                                             int& seg) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) s_word[kWarps] = -1;
  int base = 0;   // P of the round's first tile
  for (int t0 = 0; t0 < a.num_tiles && base <= e; t0 += kThreads) {
    const int t = t0 + static_cast<int>(threadIdx.x);
    const int more =
        t < a.num_tiles
            ? num_segments(__ldg(a.bounds + t + 1) - __ldg(a.bounds + t),
                           a) - 1
            : 0;
    int incl = more;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) s_word[warp] = incl;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_word[w];
      if (w < warp) incl += c;
      total += c;
    }
    const int p = base + incl - more;
    if (more > 0 && p <= e && e < p + more) {
      s_word[kWarps] = t;
      s_word[kWarps + 1] = e - p + 1;
    }
    base += total;
    __syncthreads();
  }
  __syncthreads();
  tile = s_word[kWarps];
  seg = s_word[kWarps + 1];
  return tile >= 0;
}

template <bool kLabels>
__device__ __forceinline__ void store_partial(const FwdArgs& a, int slot,
                                              int npix, const Pixels& st,
                                              bool done) {
  float* f = a.seg_f + static_cast<size_t>(slot) * kPartPlanes * npix;
  int* w = a.seg_i + static_cast<size_t>(slot) * (npix + 1);
#pragma unroll
  for (int k = 0; k < kMaxPixelsPerThread; ++k) {
    const int p = st.pix[k];
    if (p < 0) continue;
    f[p] = st.cr[k];
    f[npix + p] = st.cg[k];
    f[2 * npix + p] = st.cbl[k];
    f[3 * npix + p] = st.T[k];
    if (kLabels) {
      f[4 * npix + p] = st.bw[k];
      w[p] = st.lab[k];
    }
  }
  if (threadIdx.x == 0) w[npix] = done ? 1 : 0;
}

template <bool kLabels>
__device__ __forceinline__ void load_partial(const FwdArgs& a, int slot,
                                             int npix, Pixels& st) {
  const float* f = a.seg_f + static_cast<size_t>(slot) * kPartPlanes * npix;
  const int* w = a.seg_i + static_cast<size_t>(slot) * (npix + 1);
#pragma unroll
  for (int k = 0; k < kMaxPixelsPerThread; ++k) {
    const int p = st.pix[k];
    if (p < 0) continue;
    st.cr[k] = __ldcg(f + p);
    st.cg[k] = __ldcg(f + npix + p);
    st.cbl[k] = __ldcg(f + 2 * npix + p);
    st.T[k] = __ldcg(f + 3 * npix + p);
    if (kLabels) {
      st.bw[k] = __ldcg(f + 4 * npix + p);
      st.lab[k] = __ldcg(w + p);
    }
  }
}

// The merging block's work: tile's segments [0, nseg), whose partials lie
// in slot tile (the first) and first + k - 1 (segment k >= 1; first is
// segment 1's block), composed front to back into st as the one-block walk
// would leave it.
template <bool kLabels>
__device__ __forceinline__ void merge(const FwdArgs& a, Staged& s,
                                      int& s_quit, Pixels& st,
                                      const Place& pl, int tile, int nseg,
                                      int first, int start, int end,
                                      int npix) {
  load_partial<kLabels>(a, tile, npix, st);
  int again = 0;
  for (int k = 1; k < nseg; ++k) {
    // the one-block walk's stop test at the segment's first batch
    if (__syncthreads_count(thread_tmax(st) >= a.early_eps) == 0) break;
    const int slot = first + k - 1;
    const float* f = a.seg_f + static_cast<size_t>(slot) * kPartPlanes * npix;
    const int* w = a.seg_i + static_cast<size_t>(slot) * (npix + 1);
    float tn[kMaxPixelsPerThread];
    float tmax = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxPixelsPerThread; ++q) {
      tn[q] = 0.0f;
      if (st.pix[q] < 0) continue;
      tn[q] = st.T[q] * __ldcg(f + 3 * npix + st.pix[q]);
      tmax = fmaxf(tmax, tn[q]);
    }
    const bool ran = __ldcg(w + npix) != 0;
    if (__syncthreads_count(tmax >= a.early_eps) > 0 && ran) {
#pragma unroll
      for (int q = 0; q < kMaxPixelsPerThread; ++q) {
        const int p = st.pix[q];
        if (p < 0) continue;
        const float t = st.T[q];
        st.cr[q] = st.cr[q] + t * __ldcg(f + p);
        st.cg[q] = st.cg[q] + t * __ldcg(f + npix + p);
        st.cbl[q] = st.cbl[q] + t * __ldcg(f + 2 * npix + p);
        if (kLabels) {
          const float bw = t * __ldcg(f + 4 * npix + p);
          if (bw > st.bw[q]) {
            st.bw[q] = bw;
            st.lab[q] = __ldcg(w + p);
          }
        }
        st.T[q] = tn[q];
      }
    } else {
      // the walk stops inside segment k, or the product crossed early_eps
      // there: walk it again from the composite so far
      const int b0 = start + k * a.seg_len;
      walk<kLabels>(a, s, s_quit, st, pl, b0,
                    k == nseg - 1 ? end : b0 + a.seg_len, nullptr);
      ++again;
    }
  }
  if (threadIdx.x == 0) {
    int* words = a.tile_state + kTileWords * tile;
    words[0] = 0;
    words[1] = 0;
    atomicAdd(a.stats, 1ull);
    atomicAdd(a.stats + 1, static_cast<unsigned long long>(nseg));
    atomicAdd(a.stats + 2, static_cast<unsigned long long>(again));
  }
}

// At most 64 registers, so that 4 blocks fit an SM and the 475 tiles of an
// 800x608 frame run in one wave on 132 SMs. kLabels: the best weight and
// its label are kept and written. kSplit: long tiles are split (seg_len >
// 0); else one block a tile.
template <bool kLabels, bool kSplit>
__device__ __forceinline__ void blend_block(const FwdArgs& a, int lane) {
  __shared__ Staged s;
  // the scan's warp sums, then its tile and segment, the quit word, the
  // merge's election
  __shared__ int s_word[kWarps + 4];

  const int warp = threadIdx.x >> 5;
  int tile = blockIdx.x, seg = 0, nseg = 1;
  if (kSplit) {
    if (static_cast<int>(blockIdx.x) >= a.num_tiles &&
        !find_segment(a, blockIdx.x - a.num_tiles, s_word, tile, seg)) {
      return;
    }
    nseg = num_segments(__ldg(a.bounds + tile + 1) - __ldg(a.bounds + tile),
                        a);
  }
  const int trow = tile / a.tiles_x;
  const int tcol = tile - trow * a.tiles_x;
  const int tile_size = a.tile_size;
  const int npix = tile_size * tile_size;
  const int ppt = (npix + kThreads - 1) / kThreads;   // pixels per thread
  Place pl;
  pl.x0f = static_cast<float>((a.col_phase + tcol * a.col_stride) *
                              tile_size);
  pl.y0f = static_cast<float>((a.row_phase + trow * a.row_stride) *
                              tile_size);
  pl.log_amin = logf(a.alpha_min);
  pl.sx0 = pl.sx1 = pl.sy0 = pl.sy1 = 0.0f;
  pl.has_strip =
      strip_rect(warp, ppt, npix, tile_size, pl.sx0, pl.sx1, pl.sy0, pl.sy1);
  pl.lane = lane;

  Pixels st;
  init_pixels(st, tile_size, npix, ppt, warp, lane);

  const int start = __ldg(a.bounds + tile);
  const int end = __ldg(a.bounds + tile + 1);
  const int b0 = start + seg * a.seg_len;
  int* words = kSplit ? a.tile_state + kTileWords * tile : nullptr;
  const bool ran =
      walk<kLabels>(a, s, s_word[kWarps + 2], st, pl, b0,
                    nseg == 1 ? end : min(b0 + a.seg_len, end),
                    seg > 0 ? words + 1 : nullptr);

  if (kSplit && nseg > 1) {
    if (seg == 0 &&
        __syncthreads_count(thread_tmax(st) >= a.early_eps) == 0 &&
        threadIdx.x == 0) {
      // the one-block walk stops here: the later segments may quit
      *static_cast<volatile int*>(words + 1) = 1;
    }
    store_partial<kLabels>(a, blockIdx.x, npix, st, ran);
    if (seg == 1 && threadIdx.x == 0) words[2] = blockIdx.x;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      s_word[kWarps + 3] = atomicAdd(words, 1) == nseg - 1;
    }
    __syncthreads();
    if (!s_word[kWarps + 3]) return;
    __threadfence();
    const int first = seg > 0 ? blockIdx.x - seg + 1 : __ldcg(words + 2);
    merge<kLabels>(a, s, s_word[kWarps + 2], st, pl, tile, nseg, first, start,
                   end, npix);
  }

  // the stores
#pragma unroll
  for (int k = 0; k < kMaxPixelsPerThread; ++k) {
    const int p = st.pix[k];
    if (p < 0) continue;
    const int yy = trow * tile_size + p / tile_size;
    const int xx = tcol * tile_size + p % tile_size;
    if (yy >= a.height || xx >= a.width) continue;
    const size_t o = static_cast<size_t>(yy) * a.width + xx;
    a.rgb[3 * o + 0] = st.cr[k];
    a.rgb[3 * o + 1] = st.cg[k];
    a.rgb[3 * o + 2] = st.cbl[k];
    a.trans[o] = st.T[k];
    if (kLabels) {
      a.best_w[o] = st.bw[k];
      a.label[o] = st.lab[k];
    }
  }
}

template <bool kLabels, bool kSplit>
__global__ void __launch_bounds__(kThreads, 4)
    blend_fwd_kernel(const FwdArgs a) {
  const int lane = threadIdx.x & 31;
  blend_block<kLabels, kSplit>(a, lane);
  // the block's end
}

}  // namespace

extern "C" int gsplat_blend_fwd(
    const void* ptab, const void* inst_gauss, const void* bounds,
    int num_tiles, int tiles_x, int tile_size, int width, int height,
    int chunk, int row_stride, int row_phase, int col_stride, int col_phase,
    float alpha_min, float alpha_max, float early_eps, int with_labels,
    int seg_len, int split_above, int extra, void* tile_state, void* seg_f,
    void* seg_i, void* stats, void* rgb, void* trans, void* best_w,
    void* label, void* stream) {
  if (num_tiles > 0) {
    const bool split = seg_len > 0;
    const FwdArgs a{static_cast<const float*>(ptab),
                    static_cast<const int*>(inst_gauss),
                    static_cast<const int*>(bounds),
                    num_tiles, tiles_x, tile_size, width, height, chunk,
                    row_stride, row_phase, col_stride, col_phase,
                    alpha_min, alpha_max, early_eps,
                    split ? seg_len : 0, split ? split_above : 0,
                    static_cast<int*>(tile_state),
                    static_cast<float*>(seg_f), static_cast<int*>(seg_i),
                    static_cast<unsigned long long*>(stats),
                    static_cast<float*>(rgb), static_cast<float*>(trans),
                    static_cast<float*>(best_w), static_cast<int*>(label)};
    auto kernel = with_labels ? (split ? blend_fwd_kernel<true, true>
                                       : blend_fwd_kernel<true, false>)
                              : (split ? blend_fwd_kernel<false, true>
                                       : blend_fwd_kernel<false, false>);
    kernel<<<num_tiles + (split ? extra : 0), kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The labelled split kernel's (the viewer's and the render's) registers,
// local (spill) bytes, static shared memory and resident blocks an SM, for
// the logs and for the split's lengths (render/blend.py).
extern "C" int gsplat_blend_fwd_occupancy(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, blend_fwd_kernel<true, true>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, blend_fwd_kernel<true, true>, kThreads, 0);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = blocks;
  return static_cast<int>(err);
}
