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
// Design: blend_tile.cuh's kernel with kVis = true (no early stop; a warp
// max per instance on the f32 bit pattern, then an 8-way max over the warps
// into row b0 + i of the [B] output). Rows past bounds[num_tiles] (filtered
// bbox slots) belong to no tile; the C entry point zeroes the whole output
// before the launch.
//
// Bound on the card: the least work. Only the pairs whose
// alpha passes the cut need an expf (the cut alpha >= alpha_min is a test of
// q alone); the q test needs ~10 f32 operations per pixel inside the
// instance's cutoff box; the bytes are the table rows gathered per instance
// and one f32 per instance written. The kernel evaluates every pair.

#include "blend_tile.cuh"

namespace {
// dynamic shared memory a block may use without opting in
constexpr size_t kDefaultSmem = 48 * 1024;
}  // namespace

// inst_w has `total` = B rows: all are zeroed first, then each tile's block
// overwrites the rows of its range, so the filtered slots stay 0 without the
// host reading bounds[num_tiles] back.
extern "C" int gsplat_blend_vis(
    const void* ptab, const void* inst_gauss, const void* bounds,
    int num_tiles, int tiles_x, int tile_size, int width, int height,
    int chunk, float alpha_min, float alpha_max, int with_labels, void* rgb,
    void* trans, void* best_w, void* label, void* inst_w, int total,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total > 0) {
    cudaError_t err = cudaMemsetAsync(inst_w, 0,
                                      static_cast<size_t>(total) * 4, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (num_tiles > 0) {
    const size_t smem =
        static_cast<size_t>(kCols + kWarps) * chunk * sizeof(float);
    if (smem > kDefaultSmem) {
      cudaError_t err = cudaFuncSetAttribute(
          blend_tile_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    blend_tile_kernel<true><<<num_tiles, kThreads, smem, s>>>(
        static_cast<const float*>(ptab),
        static_cast<const int*>(inst_gauss),
        static_cast<const int*>(bounds), tiles_x, tile_size, width, height,
        chunk, alpha_min, alpha_max, 0.0f, with_labels,
        static_cast<float*>(rgb), static_cast<float*>(trans),
        static_cast<float*>(best_w), static_cast<int*>(label),
        static_cast<float*>(inst_w));
  }
  return static_cast<int>(cudaGetLastError());
}
