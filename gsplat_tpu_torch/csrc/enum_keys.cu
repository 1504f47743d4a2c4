// Kernel B4: bbox enumeration with the exact ellipse/tile-rectangle filter,
// writing the packed (tile << db | qdepth) sort key of every enumeration slot.
//
// Replaces: gsplat_tpu/render/tiles.py::_enum_key_kernel (Pallas, reached
// through _enum_keys), which computes the key per slot from a gathered
// [B, 16] row table.
//
// Design: slot-parallel and block-cooperative. Gaussian g owns the slots
// [offsets[g], offsets[g] + cnt[g]) (offsets is the exclusive prefix sum of
// cnt), so 256 consecutive gaussians own one consecutive slot range. Each
// block of 256 threads takes 256 consecutive gaussians:
//   1. loads their offsets into shared memory, and the fields of those with
//      a slot (bbox, mean, conic, cutoff, depth key), coalesced;
//   2. strides its threads over the block's slot range; each thread finds
//      its slot's gaussian by an 8-step binary search of the offsets in
//      shared memory (the last gaussian whose offset is <= the slot: the
//      gaussians with no slot before it share its offset), decodes the
//      local slot row-major in the bbox (local = row * bw + col, the order
//      of the JAX decode and of the plain version), and writes the key
//      (tile << db | qd) for a kept pair or the sentinel
//      (num_tiles << db | qd), and the gaussian index.
// Neighbouring threads write neighbouring slots, and a large splat costs its
// block a few strided rounds instead of one thread a serial walk that holds
// its whole warp (the one-thread-per-gaussian design this replaces). Bbox,
// offsets and depth keys come from the wrapper (render/tiles.py::enum_keys);
// the stable sort runs outside.
//
// The interleaved tile lattice of the sharded render: the block's tiles are
// a shard's local ones, global row row_phase + trow * row_stride and column
// col_phase + tcol * col_stride. The key packs the local tile; the rectangle
// test takes the global tile's origin, as the TPU kernel's trow_g / tcol_g
// (tiles.py:150-151). At strides of 1 and phases of 0 both are the tile of
// the single-device render and the keys are those of the kernel before the
// lattice, bit for bit.
//
// Bound on the card: bytes. Each gaussian's 12 inputs (48 B) are read once
// and each slot writes 8 B; the ~54 f32 instructions of the rectangle test
// per slot are far below the f32 rate. At render sizes the kernel is tens of
// microseconds of traffic, so the design keeps every access coalesced.
//
// Exactness: the keep-set must equal the plain version (torch elementwise
// ops, one rounding per operation) bit for bit. So this file is compiled with
// -fmad=false (no a*b+c contraction into FMA), uses IEEE division, and keeps
// the operation order of tiles.py::_rect_min_q.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // gaussians and threads a block

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// min of q(p) = a dx^2 + 2 b dx dy + c dy^2 over the tile rectangle
// [rx0, rx0 + ts] x [ry0, ry0 + ts]: zero when the mean is inside, else the
// smallest of the four closed-form edge minima.
__device__ __forceinline__ float rect_min_q(float mx, float my, float ca,
                                            float cb, float cc, float rx0,
                                            float ry0, float ts) {
  const float x0 = rx0 - mx;
  const float x1 = x0 + ts;
  const float y0 = ry0 - my;
  const float y1 = y0 + ts;
  if ((x0 <= 0.0f) && (0.0f <= x1) && (y0 <= 0.0f) && (0.0f <= y1)) {
    return 0.0f;
  }
  const float ca_s = fmaxf(ca, 1e-12f);
  const float cc_s = fmaxf(cc, 1e-12f);
  const float ncb = -cb;
  const float cb2 = 2.0f * cb;
  const float ysa = clip(ncb * x0 / cc_s, y0, y1);
  const float qxa = (ca * x0 + cb2 * ysa) * x0 + cc * ysa * ysa;
  const float ysb = clip(ncb * x1 / cc_s, y0, y1);
  const float qxb = (ca * x1 + cb2 * ysb) * x1 + cc * ysb * ysb;
  const float xsa = clip(ncb * y0 / ca_s, x0, x1);
  const float qya = (cc * y0 + cb2 * xsa) * y0 + ca * xsa * xsa;
  const float xsb = clip(ncb * y1 / ca_s, x0, x1);
  const float qyb = (cc * y1 + cb2 * xsb) * y1 + ca * xsb * xsb;
  return fminf(fminf(qxa, qxb), fminf(qya, qyb));
}

// the block's gaussians: offsets of all, fields of those with a slot
struct Block {
  int off[kThreads], x0[kThreads], y0[kThreads], bw[kThreads], qd[kThreads];
  float u[kThreads], v[kThreads], ca[kThreads], cb[kThreads], cc[kThreads],
      qm[kThreads];
  int end;   // one past the block's last slot
};

__global__ void __launch_bounds__(kThreads) enum_keys_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ ca, const float* __restrict__ cb,
    const float* __restrict__ cc, const float* __restrict__ qmax,
    const int* __restrict__ bx0, const int* __restrict__ by0,
    const int* __restrict__ bw, const int* __restrict__ cnt,
    const int* __restrict__ offsets, const int* __restrict__ qd, int n,
    int tiles_x, int num_tiles, float ts, int db, int row_stride,
    int row_phase, int col_stride, int col_phase, int* __restrict__ keys,
    int* __restrict__ gauss) {
  __shared__ Block s;
  const int g0 = blockIdx.x * kThreads;
  const int nb = min(kThreads, n - g0);
  const int t = threadIdx.x;
  // 1. the block's gaussians
  if (t < nb) {
    const int g = g0 + t;
    const int c = cnt[g];
    s.off[t] = offsets[g];
    if (c > 0) {
      s.x0[t] = bx0[g];
      s.y0[t] = by0[g];
      s.bw[t] = bw[g];
      s.qd[t] = qd[g];
      s.u[t] = u[g];
      s.v[t] = v[g];
      s.ca[t] = ca[g];
      s.cb[t] = cb[g];
      s.cc[t] = cc[g];
      s.qm[t] = qmax[g];
    }
    if (t == nb - 1) s.end = s.off[t] + c;
  }
  __syncthreads();
  // 2. the block's slots, neighbouring threads on neighbouring slots
  const int end = s.end;
  for (int slot = s.off[0] + t; slot < end; slot += kThreads) {
    // the last gaussian j < nb whose offset is <= slot
    int j = 0;
#pragma unroll
    for (int step = kThreads / 2; step > 0; step >>= 1) {
      if (j + step < nb && s.off[j + step] <= slot) j += step;
    }
    const int local = slot - s.off[j];
    const int w = s.bw[j];
    const int r = local / w;
    const int trow = s.y0[j] + r;
    const int tcol = s.x0[j] + (local - r * w);
    const float mq = rect_min_q(
        s.u[j], s.v[j], s.ca[j], s.cb[j], s.cc[j],
        static_cast<float>(col_phase + tcol * col_stride) * ts,
        static_cast<float>(row_phase + trow * row_stride) * ts, ts);
    const int tile = (mq <= s.qm[j]) ? trow * tiles_x + tcol : num_tiles;
    keys[slot] = (tile << db) | s.qd[j];
    gauss[slot] = g0 + j;
  }
}

}  // namespace

extern "C" int gsplat_enum_keys(
    const void* u, const void* v, const void* ca, const void* cb,
    const void* cc, const void* qmax, const void* bx0, const void* by0,
    const void* bw, const void* cnt, const void* offsets, const void* qd,
    int n, int tiles_x, int num_tiles, float ts, int db, int row_stride,
    int row_phase, int col_stride, int col_phase, void* keys, void* gauss,
    void* stream) {
  if (n > 0) {
    enum_keys_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(u), static_cast<const float*>(v),
        static_cast<const float*>(ca), static_cast<const float*>(cb),
        static_cast<const float*>(cc), static_cast<const float*>(qmax),
        static_cast<const int*>(bx0), static_cast<const int*>(by0),
        static_cast<const int*>(bw), static_cast<const int*>(cnt),
        static_cast<const int*>(offsets), static_cast<const int*>(qd), n,
        tiles_x, num_tiles, ts, db, row_stride, row_phase, col_stride,
        col_phase, static_cast<int*>(keys), static_cast<int*>(gauss));
  }
  return static_cast<int>(cudaGetLastError());
}
