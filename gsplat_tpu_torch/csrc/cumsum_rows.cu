// Kernel B3: inclusive prefix sum of a [rows, 16] f32 array along its rows.
//
// Replaces: gsplat_tpu/render/blend_pallas.py::_cumsum_rows_kernel (Pallas,
// reached through cumsum_rows), which streams 1024-row blocks through VMEM
// in grid order and carries a [1, C] running sum from one grid step to the
// next. Blocks of a CUDA grid run in no order, so the carry becomes a
// single-pass scan with a look-back of fixed order:
//
//   - a block takes its tile index P from an atomic counter (not from
//     blockIdx), so every tile before P belongs to a block that is already
//     resident and never waits on a later one: the launch cannot deadlock;
//   - it stages its 512 rows in shared memory with 1-D TMA bulk copies (one
//     per 32-row segment, completing on one mbarrier), scans each segment
//     in place and publishes its f64 column aggregate A[P];
//   - tiles form groups of kGroup = 64; the last tile of a group, once the
//     group's aggregates are there, publishes the group's total G[g] before
//     it waits on any earlier group;
//   - P's exclusive offset is the sum of G[0..g) plus the sum of
//     A[64g..P), each added in a fixed order: lane l of a column adds items
//     l, l + 16, l + 32, ... in turn, then the 16 lanes' sums are added in
//     lane order. At most rows / 32768 + 63 rows of 128 bytes come from L2,
//     all loaded at once. No chain of inclusive prefixes runs across the
//     grid, so every sum has one association whatever order the blocks run
//     in: the output is the same bit for bit from call to call (decoupled
//     look-back, which adds a run-dependent number of predecessors, is
//     not).
//
// Publishing without flags: each published f64 is its own flag. The C entry
// point fills the scratch (aggregates, group totals, the counter) with 0xff
// bytes in one cudaMemsetAsync before its one launch, so an unpublished
// value reads as the bit pattern kUnset, which no sum produces (a NaN sum
// is stored as the canonical NaN instead; see publish()). A value is
// written once with a relaxed 64-bit store and polled with relaxed 64-bit
// loads: an aligned 64-bit access is single-copy atomic, so a reader sees
// kUnset or the whole value, and nothing else is published behind it, so
// no fence is needed. Polling with acquire loads, an item at a time, and a
// __threadfence() before each publication doubled what the look-back costs
// (utils/blend_probe.py times both builds; numbers in PERF.md). The counter
// starts at 0xffffffff, so the first atomicAdd returns tile -1 + 1 = 0. No
// call sees a value of an earlier call, of any size.
//
// Bound on the card: bytes, 2 x rows x 64 (each row read once and written
// once). This design reads the array once and writes it once; the
// look-back moves 128 bytes a tile out and at most rows / 32768 + 63 rows
// of 128 bytes a tile in, which stay in L2 (at 2.5M rows: 4,870 tiles,
// 0.6 MB of aggregates against 160 MB of rows each way). kGroup = 64 keeps
// both terms near sqrt(tiles) at 2.5M rows (76 groups + 63).
//
// Rounding, as in the three-launch design before it: thread (column c,
// segment s) owns rows [32 s, 32 s + 32) of its tile and scans them in f32;
// the offsets (aggregates, group totals, their sums, and the totals of the
// segments before s) are carried in f64, so each output is the f32
// in-segment prefix (at most 32 terms) plus one f32 rounding of an exact-
// as-f64 offset. Each segment of 32 rows sits 528 floats from the next (16
// floats of padding), so the two segments a warp reads at once fall in
// different shared-memory banks.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 16;
constexpr int kThreads = 256;
constexpr int kSegRows = 32;
constexpr int kSegs = kThreads / kCols;            // 16 segments
constexpr int kBlockRows = kSegs * kSegRows;       // 512 rows per tile
constexpr int kSegStride = kSegRows * kCols + 16;  // padded segment
constexpr int kLanes = kThreads / kCols;           // 16 lanes a column
constexpr int kGroup = 64;                         // tiles a group (K)
constexpr long long kUnset = -1;                   // 0xff bytes
constexpr long long kCanonicalNaN = 0x7fffffffffffffffLL;

__device__ __forceinline__ int smem_index(int row, int col) {
  return (row / kSegRows) * kSegStride + (row % kSegRows) * kCols + col;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(1u)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  uint64_t state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;"
               : "=l"(state)
               : "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      " .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// 1-D TMA: `bytes` (a multiple of 16) from global `src` to shared `dst`,
// both 16-byte aligned, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ long long ld_relaxed(const double* p) {
  long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Publish one f64 of the look-back (a NaN as the canonical NaN, so that no
// value is kUnset).
__device__ __forceinline__ void publish(double* p, double v) {
  long long bits = __double_as_longlong(v);
  if (bits == kUnset) bits = kCanonicalNaN;
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(bits)
               : "memory");
}

// Lane l of column c adds items l, l + 16, l + 32, ... of rows [base,
// base + n) of `vals` ([*, 16] f64) in column c, in that order, into
// part[l][c], once all of them are published. Its loads go out at once:
// one round trip to L2 when the items are there.
__device__ __forceinline__ void lane_sum(const double* vals, int base, int n,
                                         int c, int l,
                                         double (*part)[kCols]) {
  double acc;
  for (;;) {
    acc = 0.0;
    bool ready = true;
#pragma unroll 8
    for (int i = l; i < n; i += kLanes) {
      const long long v =
          ld_relaxed(vals + static_cast<size_t>(base + i) * kCols + c);
      ready &= v != kUnset;
      acc += __longlong_as_double(v);
    }
    if (ready) break;
    __nanosleep(32);
  }
  part[l][c] = acc;
}

__global__ void __launch_bounds__(kThreads) cumsum_rows_kernel(
    const float* __restrict__ x, int rows, int nblk, double* agg,
    double* group, unsigned* counter, float* __restrict__ out) {
  __shared__ __align__(128) float tile[kSegs * kSegStride];
  __shared__ float seg_tot[kSegs][kCols];
  __shared__ double part[kLanes][kCols];
  __shared__ double blk_off[kCols];
  __shared__ float seg_off[kSegs][kCols];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int tile_id;

  const int t = threadIdx.x;
  const int c = t % kCols;
  const int s = t / kCols;

  if (t == 0) {
    tile_id = static_cast<int>(atomicAdd(counter, 1u) + 1u);
    mbar_init(&bar);
  }
  __syncthreads();
  const int p = tile_id;
  const int row0 = p * kBlockRows;
  const int nrows = min(kBlockRows, rows - row0);
  if (t == 0) {
    mbar_expect_tx(&bar, static_cast<unsigned>(nrows) * kCols * 4);
    for (int v = 0; v * kSegRows < nrows; ++v) {
      const int r = min(kSegRows, nrows - v * kSegRows);
      bulk_load(tile + v * kSegStride,
                x + static_cast<size_t>(row0 + v * kSegRows) * kCols,
                static_cast<unsigned>(r) * kCols * 4, &bar);
    }
  }
  // rows past the array's end are zeros (the copies do not reach them)
  for (int r = nrows + s; r < kBlockRows; r += kSegs) {
    tile[smem_index(r, c)] = 0.0f;
  }
  while (!mbar_try_wait(&bar, 0)) {
  }
  __syncthreads();

  // scan each segment in place; publish the tile's aggregate
  float acc = 0.0f;
  for (int j = 0; j < kSegRows; ++j) {
    const int i = smem_index(s * kSegRows + j, c);
    acc += tile[i];
    tile[i] = acc;
  }
  seg_tot[s][c] = acc;
  __syncthreads();
  double own = 0.0;
  if (t < kCols) {
    for (int v = 0; v < kSegs; ++v) own += seg_tot[v][c];
    publish(agg + static_cast<size_t>(p) * kCols + c, own);
  }

  // the aggregates before p in its group; the group's last tile publishes
  // the group's total before it waits on earlier groups
  const int g = p / kGroup;
  const int first = g * kGroup;
  lane_sum(agg, first, p - first, c, s, part);
  __syncthreads();
  double in_group = 0.0;
  if (t < kCols) {
    for (int l = 0; l < kLanes; ++l) in_group += part[l][c];
    if (p % kGroup == kGroup - 1 && p + 1 < nblk) {
      publish(group + static_cast<size_t>(g) * kCols + c, in_group + own);
    }
  }
  __syncthreads();

  // the group totals before g
  lane_sum(group, 0, g, c, s, part);
  __syncthreads();
  if (t < kCols) {
    double before = 0.0;
    for (int l = 0; l < kLanes; ++l) before += part[l][c];
    blk_off[c] = before + in_group;
  }
  __syncthreads();
  double off = blk_off[c];
  for (int v = 0; v < s; ++v) off += seg_tot[v][c];
  seg_off[s][c] = static_cast<float>(off);
  __syncthreads();

  float4* out4 = reinterpret_cast<float4*>(out);
  for (int f = t; f < nrows * (kCols / 4); f += kThreads) {
    const int r = f / (kCols / 4);
    const int cg = 4 * (f % (kCols / 4));
    const float4 v =
        *reinterpret_cast<const float4*>(tile + smem_index(r, cg));
    const float* o = &seg_off[r / kSegRows][cg];
    out4[static_cast<size_t>(row0 + r) * (kCols / 4) + cg / 4] =
        make_float4(v.x + o[0], v.y + o[1], v.z + o[2], v.w + o[3]);
  }
}

}  // namespace

// Bytes of scratch for `rows` rows: f64 aggregates [tiles, 16], f64 group
// totals [groups, 16], then the u32 tile counter. The wrapper sizes its
// scratch the same way (render/blend.py::cumsum_scratch_bytes).
static long long scratch_bytes(int rows, int* nblk, int* ngroups) {
  *nblk = (rows + kBlockRows - 1) / kBlockRows;
  *ngroups = (*nblk + kGroup - 1) / kGroup;
  return static_cast<long long>(*nblk + *ngroups) * kCols * 8 + 4;
}

// x, out: [rows, 16] f32, 16-byte aligned; scratch: at least
// scratch_bytes(rows) bytes, 8-byte aligned (else cudaErrorInvalidValue,
// and nothing is launched). One cudaMemsetAsync of the scratch, then one
// launch.
extern "C" int gsplat_cumsum_rows(const void* x, int rows, void* scratch,
                                  int scratch_len, void* out, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  int nblk, ngroups;
  const long long need = scratch_bytes(rows, &nblk, &ngroups);
  if (scratch_len < need) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* agg = static_cast<double*>(scratch);
  double* group = agg + static_cast<size_t>(nblk) * kCols;
  unsigned* counter = reinterpret_cast<unsigned*>(
      group + static_cast<size_t>(ngroups) * kCols);
  cudaError_t err =
      cudaMemsetAsync(scratch, 0xff, static_cast<size_t>(need), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  cumsum_rows_kernel<<<nblk, kThreads, 0, st>>>(
      static_cast<const float*>(x), rows, nblk, agg, group, counter,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
