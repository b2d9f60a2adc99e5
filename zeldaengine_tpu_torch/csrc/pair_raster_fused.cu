// K2 pair_raster_fused: visibility raster + attribute interpolation.
//
// Replaces: zeldaengine_tpu/ops/rasterize_pallas.py::_pair_fused_kernel
// (entry rasterize_pairs_fused). Phase 1 is the strip walk
// (strip_walk.cuh): warps own contiguous row runs of the tile, skip every
// staged pair whose packed strip span (record column y_row, strips of
// sub_rows rows) misses their rows, as the TPU kernel skips sub-blocks
// outside a slice's span, or one of whose edges excludes all their pixels,
// and stage records through a three-stage cp.async ring. Phase 2 there
// re-walks the record slices that hold winners, because that machine has
// no per-element indexed load; here it is one indexed load of the winner's
// record row per pixel. The epilogue is the same arithmetic in the same
// order: edge functions of the winner, the
// barycentrics and their analytic d/dx, d/dy, and the 24 channel-major
// output planes (0 covered*(1+min barycentric), 1 combo, 2-3 uv, 4 lod,
// 5-7 colour, 8-10 world pos, 11-13 world normal, 14-15 duv/dx,
// 16-17 duv/dy, 18-20 dpos/dx, 21-23 dpos/dy).
//
// Record row: 0-8 edge, 9-11 zc, [12 combo if has_combo], then three
// corners of corner_w floats (uv2 [if need_uv], colour3, pos3, normal3),
// and the packed strip span at column y_row (ysort binning; y_row < 0:
// none, every staged pair is tested).
//
// Bound on this card: phase 1 by operations (26 per pixel-pair test; the
// skips bring the tests made close to the tests inside the pairs' bboxes);
// phase 2 by bytes - 26 output words per pixel written once, plus one
// ~45-word record row per pixel that neighbouring pixels share through L2.
// A warp's pixels of one k are 32 consecutive pixels of a row, so its
// stores to each output plane are coalesced.
// Row bands (y0_tiles > 0): as pair_raster.cu, the buffers hold the band's
// rows and the pixel centres count viewport rows.
#include "strip_walk.cuh"

namespace {

constexpr int kAttrCh = 24;

// Three blocks of 256 threads a multiprocessor up to 8 pixels a thread
// (sm_90a: 80 registers at NPP 8 without spills, against 126 unbounded; the
// third resident block hides the walk's shared-memory and record-load
// latency).
template <int NPP>
constexpr int kMinBlocks = NPP <= 8 ? 3 : 1;

template <int NPP, bool X1>
__global__ void __launch_bounds__(zk::kThreads, kMinBlocks<NPP>)
    pair_raster_fused_kernel(
    const float* __restrict__ records, int rec_w,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ sstarts, const int* __restrict__ sends,
    const int* __restrict__ gbounds, const int* __restrict__ pair_tri,
    const float* __restrict__ init_depth, float* __restrict__ depth,
    int* __restrict__ tid, float* __restrict__ attrs, int height, int width,
    int tile_h, int tile_w, int n_tx, int n_sx, int super_h, int super_w,
    int sub_rows, int y_row, int y0_tiles, float tex_size, int need_uv,
    int has_combo, float combo_const, int z_row, int eo_stride,
    int* __restrict__ skipped) {
  const zk::TileCtx c = zk::tile_context(starts, ends, sstarts, sends,
                                         gbounds, n_tx, n_sx, super_h,
                                         super_w, blockIdx.x, y0_tiles,
                                         tile_h);
  float px[NPP], py[NPP], best[NPP];
  int bid[NPP];
  zk::strip::pixel_setup<NPP>(c, tile_h, tile_w, width, init_depth, px, py,
                              best);
  const zk::strip::Seq s = zk::strip::make_seq(c);
  zk::strip::walk<NPP, X1>(c, s, 0, zk::strip::n_chunks(s), records, rec_w,
                           y_row, sub_rows, tile_h, tile_w, px, py, best,
                           bid, {z_row, eo_stride, skipped});

  const size_t plane = (size_t)height * width;
  const int corner_w = need_uv ? 11 : 9;
  const int base_r = 12 + (has_combo ? 1 : 0);
  const int off_col = need_uv ? 2 : 0;
  const int off_pos = off_col + 3;
  const int off_nrm = off_pos + 3;

#pragma unroll
  for (int k = 0; k < NPP; ++k) {
    const int g = zk::strip::pixel_index<NPP>(c, tile_h, tile_w, width, k);
    if (g < 0) continue;
    const float pxk = X1 ? px[0] : px[k];
    const bool covered = bid[k] >= 0;
    depth[g] = best[k];
    tid[g] = covered ? pair_tri[bid[k]] : -1;
    float* out = attrs + g;
    if (!covered) {
      // The winner record of an uncovered pixel is all zeros: every plane
      // evaluates to 0 except the static combo constant.
      for (int ch = 0; ch < kAttrCh; ++ch) out[ch * plane] = 0.0f;
      if (!has_combo) out[1 * plane] = 0.0f + combo_const;
      continue;
    }
    const float* rec = records + (size_t)bid[k] * rec_w;
    const float a0 = rec[0], a1 = rec[1], a2 = rec[2];
    const float a3 = rec[3], a4 = rec[4], a5 = rec[5];
    const float a6 = rec[6], a7 = rec[7], a8 = rec[8];
    const float e0 = a0 * pxk + a1 * py[k] + a2;
    const float e1 = a3 * pxk + a4 * py[k] + a5;
    const float e2 = a6 * pxk + a7 * py[k] + a8;
    const float esum = e0 + e1 + e2;
    const float inv = 1.0f / (fabsf(esum) > 1e-20f ? esum : 1.0f);
    const float b0 = e0 * inv, b1 = e1 * inv, b2 = e2 * inv;
    const float* c0p = rec + base_r;
    const float* c1p = c0p + corner_w;
    const float* c2p = c1p + corner_w;
#define ZK_INTERP(off, w0, w1, w2) \
  ((w0) * c0p[off] + (w1) * c1p[off] + (w2) * c2p[off])
    const float bmin = fminf(fminf(b0, b1), b2);
    out[0 * plane] = 1.0f * (1.0f + bmin);
    out[1 * plane] = has_combo ? rec[12] : (0.0f + combo_const);
    if (need_uv) {
      const float sax = a0 + a3 + a6;
      const float say = a1 + a4 + a7;
      const float d0x = (a0 - b0 * sax) * inv;
      const float d1x = (a3 - b1 * sax) * inv;
      const float d2x = (a6 - b2 * sax) * inv;
      const float d0y = (a1 - b0 * say) * inv;
      const float d1y = (a4 - b1 * say) * inv;
      const float d2y = (a7 - b2 * say) * inv;
      const float duvdx0 = ZK_INTERP(0, d0x, d1x, d2x);
      const float duvdx1 = ZK_INTERP(1, d0x, d1x, d2x);
      const float duvdy0 = ZK_INTERP(0, d0y, d1y, d2y);
      const float duvdy1 = ZK_INTERP(1, d0y, d1y, d2y);
      const float foot = fmaxf(duvdx0 * duvdx0 + duvdx1 * duvdx1,
                               duvdy0 * duvdy0 + duvdy1 * duvdy1);
      const float lod = fmaxf(
          0.5f * log2f(fmaxf(foot * (tex_size * tex_size), 1e-12f)), 0.0f);
      out[2 * plane] = ZK_INTERP(0, b0, b1, b2);
      out[3 * plane] = ZK_INTERP(1, b0, b1, b2);
      out[4 * plane] = lod;
      out[14 * plane] = duvdx0;
      out[15 * plane] = duvdx1;
      out[16 * plane] = duvdy0;
      out[17 * plane] = duvdy1;
      for (int ch = 0; ch < 3; ++ch) {
        out[(18 + ch) * plane] = ZK_INTERP(off_pos + ch, d0x, d1x, d2x);
        out[(21 + ch) * plane] = ZK_INTERP(off_pos + ch, d0y, d1y, d2y);
      }
    } else {
      out[2 * plane] = 0.0f;
      out[3 * plane] = 0.0f;
      out[4 * plane] = 0.0f;
      for (int ch = 14; ch < kAttrCh; ++ch) out[ch * plane] = 0.0f;
    }
    for (int ch = 0; ch < 3; ++ch) {
      out[(5 + ch) * plane] = ZK_INTERP(off_col + ch, b0, b1, b2);
      out[(8 + ch) * plane] = ZK_INTERP(off_pos + ch, b0, b1, b2);
      out[(11 + ch) * plane] = ZK_INTERP(off_nrm + ch, b0, b1, b2);
    }
#undef ZK_INTERP
  }
}

}  // namespace

// As zk_pair_raster, plus attrs (24, height, width), the strip span
// (sub_rows, y_row; y_row < 0: no span column), the row band (y0_tiles, as
// zk_pair_raster's) and the static elision flags
// of the record layout. records must be 16-byte aligned with rec_w a
// multiple of 4 (cp.async stages 16-byte pieces of each row). z_row >= 0
// (with y_row < 0 and eo_stride >= 1) turns the occlusion early-out on
// (strip_walk.cuh); skipped, if not null, gets the pair visits it skipped
// added.
extern "C" int zk_pair_raster_fused(
    const void* records, int rec_w, const void* starts, const void* ends,
    const void* sstarts, const void* sends, const void* gbounds,
    const void* pair_tri, const void* init_depth, void* depth, void* tid,
    void* attrs, int height, int width, int tile_h, int tile_w, int n_sx,
    int super_h, int super_w, int sub_rows, int y_row, int y0_tiles,
    int texture_size, int need_uv, int has_combo, float combo_const,
    int z_row, int eo_stride, void* skipped, void* stream) {
  if (rec_w % 4 != 0 || ((size_t)records & 15) != 0 || y_row >= rec_w ||
      (y_row >= 0 && sub_rows <= 0) || y0_tiles < 0 || z_row >= rec_w ||
      (z_row >= 0 && eo_stride < 1))
    return (int)cudaErrorInvalidValue;
  const int n_tx = width / tile_w;
  const int n_ty = height / tile_h;
  const dim3 grid(n_tx * n_ty);
  cudaStream_t s = (cudaStream_t)stream;
  const bool x1 = tile_w == 32;  // a lane's pixels share one column
#define ZK_LAUNCH_V(NPP, X1)                                                \
  pair_raster_fused_kernel<NPP, X1><<<grid, zk::kThreads, 0, s>>>(          \
      (const float*)records, rec_w, (const int*)starts, (const int*)ends,   \
      (const int*)sstarts, (const int*)sends, (const int*)gbounds,          \
      (const int*)pair_tri, (const float*)init_depth, (float*)depth,        \
      (int*)tid, (float*)attrs, height, width, tile_h, tile_w, n_tx, n_sx,  \
      super_h, super_w, sub_rows, y_row, y0_tiles, (float)texture_size,     \
      need_uv, has_combo, combo_const, z_row, eo_stride, (int*)skipped)
#define ZK_LAUNCH(NPP)                                                      \
  if (x1) ZK_LAUNCH_V(NPP, true);                                            \
  else ZK_LAUNCH_V(NPP, false)
  switch (zk::pixels_per_thread(tile_h, tile_w)) {
    case 1: ZK_LAUNCH(1); break;
    case 2: ZK_LAUNCH(2); break;
    case 4: ZK_LAUNCH(4); break;
    case 8: ZK_LAUNCH(8); break;
    case 16: ZK_LAUNCH(16); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef ZK_LAUNCH
#undef ZK_LAUNCH_V
  return (int)cudaGetLastError();
}
