// K1 pair_raster: exact-pair tiled visibility rasterizer (the shadow map).
//
// Replaces: zeldaengine_tpu/ops/rasterize_pallas.py::_pair_kernel (entry
// rasterize_pairs). Per (pixel, pair) it evaluates three edge functions at
// the pixel centre and the barycentric depth d = sum e_i * zc_i, and keeps
// the minimum depth and (unless depth_only) the lowest pair id at that
// depth, mapped to the original triangle id through pair_tri; init_depth
// wins ties.
//
// Bound on this card: operations (26 fp32 operations per pixel-pair test;
// the bytes are a 64-byte record per pair and one or two words per pixel).
// Shadow triangles are small: a (tile, pair) entry covers ~86 of a 64x32
// tile's 2,048 pixels. What the design does about it:
// - Phase 1 is the strip walk of strip_walk.cuh, shared with K2: warps own
//   8-row strips and skip, per staged chunk, every pair whose packed strip
//   span (record column y_row, which build_pairs(ysort_sub_rows=sub_rows)
//   appends) misses their rows or one of whose edges excludes all their
//   pixels; records arrive through a three-stage cp.async ring. With
//   y_row < 0 every pair is tested.
// - Crowded tiles are split. The shadow pairs fall unevenly on the tiles
//   (a few hold many times the mean), and a block walks its pairs alone,
//   so the grid gives each tile n_parts blocks, side by side: block
//   t * n_parts + p walks the p-th contiguous, chunk-aligned part of tile
//   t's pair sequence
//   (parts of at least min_chunks chunks; blocks past the end exit). A
//   part keeps ascending pair order, so its local winner is the lowest
//   pair id among its minimum-depth candidates. A tile whose sequence fits
//   in one part is stored directly. Split tiles merge exactly with
//   atomicMin on the 64-bit key (order-preserving bits of the depth with
//   -0.0 folded into +0.0) << 32 | (order + 1) << 1 | sign bit, where the
//   order is the pair id with ids and the part depth only (the parts
//   follow pair order). d < best treats -0.0 and +0.0 as one depth, so
//   the earlier of two zero candidates wins and keeps its sign; the key
//   orders them the same way and carries the sign. merge_parts_kernel
//   then takes the minimum with init_depth keyed as order 0 (it wins
//   ties) and writes depth and triangle id: a split tile's result equals
//   the one-block walk's bit for bit. Nothing is read back to the host,
//   so the launch can be captured in a CUDA graph.
// - Row bands (y0_tiles > 0, the multi-device path's bands): the buffers
//   hold the band's rows, and pixel centres and the strip span test count
//   viewport rows (TileCtx::y0), as the TPU kernel's y0_ref does.
//
// Arithmetic is written in the operation order of the plain PyTorch
// version (ops/rasterize_cuda.py) and the file is compiled with
// -fmad=false, so coverage and depth agree with it bit for bit.
#include <climits>

#include "strip_walk.cuh"

namespace {

using zk::strip::Seq;

// Three blocks of 256 threads a multiprocessor up to 8 pixels a thread, as
// in pair_raster_fused.cu.
template <int NPP>
constexpr int kMinBlocks = NPP <= 8 ? 3 : 1;

// The chunks [ch0, ch1) of part p of a tile's sequence; split: the
// sequence spans more than one part.
struct Part {
  int ch0, ch1;
  bool split;
};

__device__ __forceinline__ Part part_of(const Seq& s, int n_parts,
                                        int min_chunks, int p) {
  const int n = zk::strip::n_chunks(s);
  const int per = max((n + n_parts - 1) / n_parts, min_chunks);
  Part r;
  r.ch0 = p * per;
  r.ch1 = min(n, r.ch0 + per);
  r.split = per < n;
  return r;
}

// Order-preserving bits of a float (unsigned compare = float compare), with
// -0.0 taken as +0.0.
__device__ __forceinline__ unsigned ordered(float d) {
  const unsigned u = __float_as_uint(d == 0.0f ? 0.0f : d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The merge key of depth d found at order o (pair id, or part) + 1.
__device__ __forceinline__ unsigned long long merge_key(float d,
                                                        unsigned o1) {
  return ((unsigned long long)ordered(d) << 32) | (o1 << 1) |
         (__float_as_uint(d) >> 31);
}

// The depth of a key, its sign restored (only a zero's sign was folded).
__device__ __forceinline__ float key_depth(unsigned long long k) {
  const unsigned h = (unsigned)(k >> 32);
  const float d = __uint_as_float((h & 0x80000000u) ? (h ^ 0x80000000u) : ~h);
  return (k & 1ull) ? -d : d;
}

template <int NPP, bool X1, bool DEPTH_ONLY>
__global__ void __launch_bounds__(zk::kThreads, kMinBlocks<NPP>)
    pair_raster_kernel(
    const float* __restrict__ records, int rec_w,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ sstarts, const int* __restrict__ sends,
    const int* __restrict__ gbounds, const int* __restrict__ pair_tri,
    const float* __restrict__ init_depth, float* __restrict__ depth,
    int* __restrict__ tid, void* __restrict__ keys, int width, int tile_h,
    int tile_w, int n_tx, int n_sx, int super_h, int super_w, int sub_rows,
    int y_row, int y0_tiles, int n_parts, int min_chunks, int z_row,
    int eo_stride, int* __restrict__ skipped) {
  // Block b walks part b % n_parts of tile b / n_parts: the parts of a
  // crowded tile start together, early in the grid.
  const int p = blockIdx.x % n_parts;
  const zk::TileCtx c = zk::tile_context(starts, ends, sstarts, sends,
                                         gbounds, n_tx, n_sx, super_h,
                                         super_w, blockIdx.x / n_parts,
                                         y0_tiles, tile_h);
  const Seq s = zk::strip::make_seq(c);
  const Part part = part_of(s, n_parts, min_chunks, p);
  // Part 0 always runs: it stores a tile with no pairs.
  if (p > 0 && part.ch0 >= part.ch1) return;
  float px[NPP], py[NPP], best[NPP];
  int bid[NPP];
  zk::strip::pixel_setup<NPP>(c, tile_h, tile_w, width, init_depth, px, py,
                              best);
  // Each part stops on its own bound: its pairs stay in ascending order,
  // so each range's part is still sorted by z bucket.
  zk::strip::walk<NPP, X1>(c, s, part.ch0, part.ch1, records, rec_w, y_row,
                           sub_rows, tile_h, tile_w, px, py, best, bid,
                           {z_row, eo_stride, skipped});
#pragma unroll
  for (int k = 0; k < NPP; ++k) {
    const int g = zk::strip::pixel_index<NPP>(c, tile_h, tile_w, width, k);
    if (g < 0) continue;
    if (!part.split) {
      depth[g] = best[k];
      if (!DEPTH_ONLY) tid[g] = bid[k] >= 0 ? pair_tri[bid[k]] : -1;
    } else if (DEPTH_ONLY) {
      // best is init_depth where the part has no candidate, and init's
      // key (order 0) is below it at equal depth: the minimum over the
      // parts and init is init or the first minimum candidate.
      atomicMin(static_cast<unsigned long long*>(keys) + g,
                merge_key(best[k], (unsigned)p + 1u));
    } else if (bid[k] >= 0) {
      atomicMin(static_cast<unsigned long long*>(keys) + g,
                merge_key(best[k], (unsigned)bid[k] + 1u));
    }
  }
}

// Depth and triangle id of the split tiles from their merged keys.
template <bool DEPTH_ONLY>
__global__ void __launch_bounds__(zk::kThreads) merge_parts_kernel(
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ sstarts, const int* __restrict__ sends,
    const int* __restrict__ gbounds, const int* __restrict__ pair_tri,
    const float* __restrict__ init_depth, float* __restrict__ depth,
    int* __restrict__ tid, const void* __restrict__ keys, int width,
    int tile_h, int tile_w, int n_tx, int n_sx, int super_h, int super_w,
    int n_parts, int min_chunks) {
  const zk::TileCtx c = zk::tile_context(starts, ends, sstarts, sends,
                                         gbounds, n_tx, n_sx, super_h,
                                         super_w, blockIdx.x, 0, tile_h);
  if (!part_of(zk::strip::make_seq(c), n_parts, min_chunks, 0).split) return;
  for (int p = threadIdx.x; p < tile_h * tile_w; p += zk::kThreads) {
    const int g =
        (c.ty * tile_h + p / tile_w) * width + c.tx * tile_w + p % tile_w;
    const float init = init_depth ? init_depth[g] : 1.0f;
    const unsigned long long k =
        static_cast<const unsigned long long*>(keys)[g];
    // init_depth is keyed as order 0: below every candidate at its depth.
    const bool won = k < ((unsigned long long)ordered(init) << 32);
    depth[g] = won ? key_depth(k) : init;
    if (!DEPTH_ONLY)
      tid[g] = won ? pair_tri[(int)((k & 0xffffffffull) >> 1) - 1] : -1;
  }
}

}  // namespace

// height/width are multiples of tile_h/tile_w; records 16-byte aligned with
// rec_w a multiple of 4 (cp.async stages 16-byte pieces of each row).
// init_depth may be null (clear value 1.0); tid may be null when
// depth_only. y_row >= 0 names the packed strip span column (strips of
// sub_rows rows). y0_tiles >= 0: the buffers are the row band of viewport
// tile rows [y0_tiles, y0_tiles + height / tile_h) (0: the whole frame),
// and the pairs are binned for that band (build_pairs(y0_tiles=)).
// n_parts > 1 splits each tile's sequence into up to
// n_parts parts of at least min_chunks 64-pair chunks; keys is then a
// scratch buffer of height * width 64-bit words, which this function fills
// before the raster. z_row >= 0 (with y_row < 0 and eo_stride >= 1) turns
// the occlusion early-out on (strip_walk.cuh), each part of a split tile
// stopping on its own bound; skipped, if not null, gets the pair visits it
// skipped added. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments the kernels do not take.
extern "C" int zk_pair_raster(
    const void* records, int rec_w, const void* starts, const void* ends,
    const void* sstarts, const void* sends, const void* gbounds,
    const void* pair_tri, const void* init_depth, void* depth, void* tid,
    void* keys, int height, int width, int tile_h, int tile_w, int n_sx,
    int super_h, int super_w, int sub_rows, int y_row, int y0_tiles,
    int n_parts, int min_chunks, int depth_only, int z_row, int eo_stride,
    void* skipped, void* stream) {
  const int n_tx = width / tile_w;
  const int n_tiles = n_tx * (height / tile_h);
  if (rec_w % 4 != 0 || ((size_t)records & 15) != 0 || y_row >= rec_w ||
      (y_row >= 0 && sub_rows <= 0) || y0_tiles < 0 || n_parts < 1 ||
      min_chunks < 1 ||
      (n_parts > 1 && keys == nullptr) || z_row >= rec_w ||
      (z_row >= 0 && eo_stride < 1) ||
      (long long)n_tiles * n_parts > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_parts > 1) {
    const cudaError_t e =
        cudaMemsetAsync(keys, 0xff, (size_t)height * width * 8, s);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_tiles * n_parts);
  const bool x1 = tile_w == 32;  // a lane's pixels share one column
#define ZK_LAUNCH_V(NPP, X1, DO)                                            \
  pair_raster_kernel<NPP, X1, DO><<<grid, zk::kThreads, 0, s>>>(            \
      (const float*)records, rec_w, (const int*)starts, (const int*)ends,   \
      (const int*)sstarts, (const int*)sends, (const int*)gbounds,          \
      (const int*)pair_tri, (const float*)init_depth, (float*)depth,        \
      (int*)tid, keys, width, tile_h, tile_w, n_tx, n_sx, super_h, super_w, \
      sub_rows, y_row, y0_tiles, n_parts, min_chunks, z_row, eo_stride,    \
      (int*)skipped)
#define ZK_LAUNCH_X(NPP, DO)           \
  {                                     \
    if (x1) ZK_LAUNCH_V(NPP, true, DO); \
    else ZK_LAUNCH_V(NPP, false, DO);   \
  }
#define ZK_LAUNCH(NPP)                     \
  {                                        \
    if (depth_only) ZK_LAUNCH_X(NPP, true) \
    else ZK_LAUNCH_X(NPP, false)           \
  }
  switch (zk::pixels_per_thread(tile_h, tile_w)) {
    case 1: ZK_LAUNCH(1); break;
    case 2: ZK_LAUNCH(2); break;
    case 4: ZK_LAUNCH(4); break;
    case 8: ZK_LAUNCH(8); break;
    case 16: ZK_LAUNCH(16); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef ZK_LAUNCH
#undef ZK_LAUNCH_X
#undef ZK_LAUNCH_V
  if (n_parts > 1) {
#define ZK_MERGE(DO)                                                         \
  merge_parts_kernel<DO><<<n_tiles, zk::kThreads, 0, s>>>(                   \
      (const int*)starts, (const int*)ends, (const int*)sstarts,             \
      (const int*)sends, (const int*)gbounds, (const int*)pair_tri,          \
      (const float*)init_depth, (float*)depth, (int*)tid, keys, width,       \
      tile_h, tile_w, n_tx, n_sx, super_h, super_w, n_parts, min_chunks)
    if (depth_only) ZK_MERGE(true);
    else ZK_MERGE(false);
#undef ZK_MERGE
  }
  return (int)cudaGetLastError();
}
