// K1 pair_raster: exact-pair tiled visibility rasterizer.
//
// Replaces: zeldaengine_tpu/ops/rasterize_pallas.py::_pair_kernel (entry
// rasterize_pairs). One thread block per screen tile walks the tile's
// dense pair range, then its supertile range, then the global bucket;
// per (pixel, pair) it evaluates three edge functions at the pixel
// centre and the barycentric depth d = sum e_i * zc_i, and keeps the
// minimum depth and (unless depth_only) the lowest pair id at that depth,
// mapped to the original triangle id through pair_tri.
//
// Bound on this card: operations. Each staged pair costs every pixel of
// the tile ~25 fp32 operations while the bytes are tiny (48 B per pair
// per tile, one depth and one id per pixel), so the walk is limited by
// the fp32 rate, not by memory. The design keeps the per-pixel state in
// registers and broadcasts record values from shared memory so that the
// inner loop is pure arithmetic; it does not yet skip pairs whose
// bounding box misses a thread's pixels (the record's packed row span is
// ignored: results are identical, work is not minimal).
#include "pair_walk.cuh"

namespace {

template <int NPP, bool DEPTH_ONLY>
__global__ void __launch_bounds__(zk::kThreads) pair_raster_kernel(
    const float* __restrict__ records, int rec_w,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ sstarts, const int* __restrict__ sends,
    const int* __restrict__ gbounds, const int* __restrict__ pair_tri,
    const float* __restrict__ init_depth, float* __restrict__ depth,
    int* __restrict__ tid, int width, int tile_h, int tile_w, int n_tx,
    int n_sx, int super_h, int super_w) {
  const zk::TileCtx c = zk::tile_context(starts, ends, sstarts, sends,
                                         gbounds, n_tx, n_sx, super_h,
                                         super_w);
  float px[NPP], py[NPP], best[NPP];
  int gidx[NPP], bid[NPP];
  zk::pixel_setup<NPP>(c, tile_h, tile_w, width, init_depth, px, py, best,
                       gidx);
  zk::walk_ranges<NPP, !DEPTH_ONLY>(c, records, rec_w, px, py, best, bid);
#pragma unroll
  for (int k = 0; k < NPP; ++k) {
    if (gidx[k] < 0) continue;
    depth[gidx[k]] = best[k];
    if (!DEPTH_ONLY) tid[gidx[k]] = bid[k] >= 0 ? pair_tri[bid[k]] : -1;
  }
}

template <int NPP>
void launch(bool depth_only, dim3 grid, cudaStream_t s,
            const float* records, int rec_w, const int* starts,
            const int* ends, const int* sstarts, const int* sends,
            const int* gbounds, const int* pair_tri, const float* init_depth,
            float* depth, int* tid, int width, int tile_h, int tile_w,
            int n_tx, int n_sx, int super_h, int super_w) {
  if (depth_only) {
    pair_raster_kernel<NPP, true><<<grid, zk::kThreads, 0, s>>>(
        records, rec_w, starts, ends, sstarts, sends, gbounds, pair_tri,
        init_depth, depth, tid, width, tile_h, tile_w, n_tx, n_sx, super_h,
        super_w);
  } else {
    pair_raster_kernel<NPP, false><<<grid, zk::kThreads, 0, s>>>(
        records, rec_w, starts, ends, sstarts, sends, gbounds, pair_tri,
        init_depth, depth, tid, width, tile_h, tile_w, n_tx, n_sx, super_h,
        super_w);
  }
}

}  // namespace

// height/width are multiples of tile_h/tile_w. init_depth may be null
// (clear value 1.0); tid may be null when depth_only. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a tile above 4096 px.
extern "C" int zk_pair_raster(
    const void* records, int rec_w, const void* starts, const void* ends,
    const void* sstarts, const void* sends, const void* gbounds,
    const void* pair_tri, const void* init_depth, void* depth, void* tid,
    int height, int width, int tile_h, int tile_w, int n_sx, int super_h,
    int super_w, int depth_only, void* stream) {
  const int n_tx = width / tile_w;
  const int n_ty = height / tile_h;
  const dim3 grid(n_tx * n_ty);
  cudaStream_t s = (cudaStream_t)stream;
#define ZK_ARGS                                                            \
  depth_only != 0, grid, s, (const float*)records, rec_w,                  \
      (const int*)starts, (const int*)ends, (const int*)sstarts,           \
      (const int*)sends, (const int*)gbounds, (const int*)pair_tri,        \
      (const float*)init_depth, (float*)depth, (int*)tid, width, tile_h,   \
      tile_w, n_tx, n_sx, super_h, super_w
  switch (zk::pixels_per_thread(tile_h, tile_w)) {
    case 1: launch<1>(ZK_ARGS); break;
    case 2: launch<2>(ZK_ARGS); break;
    case 4: launch<4>(ZK_ARGS); break;
    case 8: launch<8>(ZK_ARGS); break;
    case 16: launch<16>(ZK_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef ZK_ARGS
  return (int)cudaGetLastError();
}
