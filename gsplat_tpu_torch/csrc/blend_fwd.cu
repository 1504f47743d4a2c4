// Kernel B1: forward front-to-back compositing of one image tile per block,
// with the optional best-weight label channel.
//
// Replaces: gsplat_tpu/render/blend_pallas.py::_fwd_win_kernel (Pallas,
// reached through blend_windows_fwd), which walks 8-aligned windows of a
// materialised, lane-padded [B, 128] parameter array and carries the
// per-pixel state in the resident output block.
//
// Design: blend_tile.cuh's kernel with early stop (kVis = false): one block
// of 256 threads per tile, batches of `chunk` instances staged in shared
// memory, the tile-wide early-stop rule of the JAX kernel.
//
// Bound on the card: the least work is an expf and ~13 f32 operations per
// pair whose alpha passes the cut (a test of q alone) and the q test (~10)
// per pixel inside an instance's cutoff box, against a few bytes per
// instance from memory; the kernel evaluates every pixel of a tile that
// runs.

#include "blend_tile.cuh"

extern "C" int gsplat_blend_fwd(
    const void* ptab, const void* inst_gauss, const void* bounds,
    int num_tiles, int tiles_x, int tile_size, int width, int height,
    int chunk, float alpha_min, float alpha_max, float early_eps,
    int with_labels, void* rgb, void* trans, void* best_w, void* label,
    void* stream) {
  if (num_tiles > 0) {
    const size_t smem = static_cast<size_t>(kCols) * chunk * sizeof(float);
    blend_tile_kernel<false><<<num_tiles, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(ptab),
        static_cast<const int*>(inst_gauss),
        static_cast<const int*>(bounds), tiles_x, tile_size, width, height,
        chunk, alpha_min, alpha_max, early_eps, with_labels,
        static_cast<float*>(rgb), static_cast<float*>(trans),
        static_cast<float*>(best_w), static_cast<int*>(label), nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
