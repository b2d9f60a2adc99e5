// The strip walk: phase 1 of both pair rasterizers (pair_raster.cu,
// pair_raster_fused.cu). One thread block walks one screen tile's pair
// ranges (or, in pair_raster.cu, one contiguous part of them) and keeps, per
// pixel, the minimum depth and the lowest pair id among the minimum-depth
// candidates.
//
// Replaces the walk of zeldaengine_tpu/ops/rasterize_pallas.py
// (_make_walk, raster_body with y_row >= 0) including its sub-block window
// skip: each pair record carries its triangle's packed absolute strip span
// (ysub1 * 4096 + ysub0, strips of sub_rows rows), and a triangle's
// coverage outside its binning bbox is empty by construction, so a pair
// whose span misses a group of rows cannot cover any pixel there.
//
// Bound on this card: operations (26 fp32 operations per pixel-pair test).
// What the design does about it:
// - Warp w owns the contiguous linear tile pixels [w*32*NPP, (w+1)*32*NPP)
//   (lane = column inside a row segment), so each warp covers as few rows
//   as possible (8 rows x 32 columns for 64x32 tiles) and the skip is
//   warp-uniform: per staged chunk each lane takes two pairs, decodes
//   their spans and, for a span that meets the warp's rows, tests each
//   edge against the warp's pixel rectangle at one corner (with a margin
//   that makes the reject exact in fp32; this is the x extent the span
//   lacks); __ballot_sync builds the warp's 64-bit mask of the pairs left,
//   and the warp tests only those, low bit first. Ascending pair order
//   with a strict d < best keeps "lowest pair id among minimum-depth
//   candidates; init_depth wins ties". With y_row < 0 every pair is
//   tested.
// - Records are staged with cp.async into a ring of three stages (the 12
//   raster words and the 16-byte group holding the span column: one
//   16-byte piece per thread per chunk), so chunk i+1 is in flight while
//   chunk i is walked, and one __syncthreads per chunk suffices.
//
// - Occlusion early-out (z-sorted bins without a span column; replaces
//   the stop test of the JAX package's _run_raster_walk_accwide): each of
//   the tile's three ranges is sorted by its pairs' z bucket (record
//   column z_col, the quantized floor of the triangle's nearest depth).
//   After every eo_stride-th chunk of the block's walk, the block takes
//   the maximum over its pixels of min(acc, init) (a warp shuffle and
//   one shared-memory step) and, for each range with pairs in that chunk,
//   their largest z bucket; where the pixels' maximum lies strictly below
//   it, every later pair of the range is at least as far as that bucket
//   everywhere and cannot win a strict d < best, so the block skips the
//   rest of the range. Skipped pairs are still staged (the ring runs
//   ahead) but not tested; thread 0 counts them into *skipped.
//
// Arithmetic is written in the operation order of the plain PyTorch
// version (ops/rasterize_cuda.py) and the file is compiled with
// -fmad=false: the only fused multiply-adds are the explicit __fmaf_rn of
// the edge values and the depth, which the plain version emulates exactly,
// so coverage and depth agree with it bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace zk {

constexpr int kThreads = 256;

struct TileCtx {
  int tx, ty;        // tile coordinates
  int ranges[3][2];  // dense, supertile, global pair ranges [lo, hi)
};

// Tile t and its three pair ranges.
__device__ __forceinline__ TileCtx tile_context(
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ sstarts, const int* __restrict__ sends,
    const int* __restrict__ gbounds, int n_tx, int n_sx, int super_h,
    int super_w, int t) {
  TileCtx c;
  c.ty = t / n_tx;
  c.tx = t % n_tx;
  const int st = (c.ty / super_h) * n_sx + (c.tx / super_w);
  c.ranges[0][0] = starts[t];
  c.ranges[0][1] = ends[t];
  c.ranges[1][0] = sstarts[st];
  c.ranges[1][1] = sends[st];
  c.ranges[2][0] = gbounds[0];
  c.ranges[2][1] = gbounds[1];
  return c;
}

// Pixels per thread (NPP) for a tile, rounded up to a power of two.
inline int pixels_per_thread(int tile_h, int tile_w) {
  const int need = (tile_h * tile_w + kThreads - 1) / kThreads;
  int npp = 1;
  while (npp < need) npp *= 2;
  return npp;
}

namespace strip {

constexpr int kChunk = 64;   // pairs per stage (two per lane for the ballot)
constexpr int kStages = 3;   // ring depth: chunk i+1 in flight during i
constexpr int kPieces = 4;   // 16-byte pieces per pair: 3 raster + 1 span
static_assert(kChunk * kPieces == kThreads, "one piece per thread");

struct Stage {
  float4 rast[kChunk * 3];  // raster words 0-11 of each staged pair
  float4 span[kChunk];      // the aligned 16-byte group holding y_row
};

// The tile's three pair ranges as one ascending sequence: virtual index v
// runs over dense, then supertile, then global pairs (pair ids ascend in
// that order because dense < supertile < global in the sort-key order).
struct Seq {
  int lo[3];
  int len[3];
  int total;
};

__device__ __forceinline__ Seq make_seq(const TileCtx& c) {
  Seq s;
  s.total = 0;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    s.lo[r] = c.ranges[r][0];
    s.len[r] = max(0, c.ranges[r][1] - c.ranges[r][0]);
    s.total += s.len[r];
  }
  return s;
}

__device__ __forceinline__ int seq_pair(const Seq& s, int v) {
  if (v < s.len[0]) return s.lo[0] + v;
  v -= s.len[0];
  if (v < s.len[1]) return s.lo[1] + v;
  return s.lo[2] + (v - s.len[1]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage the chunk starting at virtual index v0 (one committed group per
// call, empty past v_end so that the group count stays uniform).
__device__ __forceinline__ void issue_chunk(Stage& st, const Seq& s,
                                            const float* __restrict__ records,
                                            int rec_w, int span_q, int v0,
                                            int v_end) {
  const int j = threadIdx.x / kPieces;
  const int q = threadIdx.x % kPieces;
  const int v = v0 + j;
  if (v < v_end && (q < 3 || span_q >= 0)) {
    const float* row = records + (size_t)seq_pair(s, v) * rec_w;
    if (q < 3) {
      cp_async16(&st.rast[j * 3 + q], row + 4 * q);
    } else {
      cp_async16(&st.span[j], row + 4 * span_q);
    }
  }
  cp_async_commit();
}

// Absolute rows [r0, r1] of this warp's pixels; any = the warp owns one.
struct WarpRows {
  float r0, r1;
  bool any;
};

template <int NPP>
__device__ __forceinline__ WarpRows warp_rows(const TileCtx& c, int tile_h,
                                              int tile_w) {
  const int first = (threadIdx.x / 32) * 32 * NPP;
  const int tile_pixels = tile_h * tile_w;
  const int last = min(first + 32 * NPP, tile_pixels) - 1;
  WarpRows r;
  r.any = first < tile_pixels;
  r.r0 = (float)(c.ty * tile_h + first / tile_w);
  r.r1 = (float)(c.ty * tile_h + max(last, first) / tile_w);
  return r;
}

// Pixel k of this thread: linear tile pixel
// p = warp * 32 * NPP + k * 32 + lane; its frame index, or -1 outside the
// tile.
template <int NPP>
__device__ __forceinline__ int pixel_index(const TileCtx& c, int tile_h,
                                           int tile_w, int width, int k) {
  const int p = (threadIdx.x / 32) * 32 * NPP + threadIdx.x % 32 + k * 32;
  if (p >= tile_h * tile_w) return -1;
  return (c.ty * tile_h + p / tile_w) * width + c.tx * tile_w + p % tile_w;
}

// Pixel centres and starting depths. With X1 (tile_w == 32) a lane's
// pixels share one column, and only px[0] is used.
template <int NPP>
__device__ __forceinline__ void pixel_setup(
    const TileCtx& c, int tile_h, int tile_w, int width,
    const float* __restrict__ init_depth, float (&px)[NPP], float (&py)[NPP],
    float (&best)[NPP]) {
#pragma unroll
  for (int k = 0; k < NPP; ++k) {
    const int g = pixel_index<NPP>(c, tile_h, tile_w, width, k);
    if (g >= 0) {
      px[k] = (float)(g % width) + 0.5f;
      py[k] = (float)(g / width) + 0.5f;
      best[k] = init_depth ? init_depth[g] : 1.0f;
    } else {
      px[k] = 0.0f;
      py[k] = 0.0f;
      best[k] = -1.0f;  // below every accepted depth: never taken
    }
  }
}

// Does the packed strip span v (ysub1 * 4096 + ysub0, decoded as the JAX
// kernel decodes it) meet rows [r0, r1]? The never-record's (4095, 0) is
// an empty span and never does.
__device__ __forceinline__ bool span_meets(float v, float sub_rows,
                                           const WarpRows& w) {
  const float y1 = floorf(v * (1.0f / 4096.0f));
  const float y0 = v - y1 * 4096.0f;
  return (y0 * sub_rows <= w.r1) && ((y1 + 1.0f) * sub_rows - 1.0f >= w.r0);
}

// The pixel centres a warp owns lie in [x0, x1] x [y0, y1] (all columns
// of the tile, the warp's rows).
struct Rect {
  float x0, x1, y0, y1;
};

// Does the edge function a*x + b*y + c evaluate below zero at every pixel
// centre of r, as the walk evaluates it? Its largest exact value over r is
// at the corner its signs pick; computed in fp32 there it is off by at most
// 3 ulp-units of s = |a|*x1 + |b|*y1 + |c| (x, y > 0), and so is every
// pixel's. Below -1e-5 * s (~170 units) at that corner, every pixel's fp32
// value is negative: the pair covers none of them, exactly.
__device__ __forceinline__ bool edge_misses(float a, float b, float c,
                                            const Rect& r) {
  const float x = a >= 0.0f ? r.x1 : r.x0;
  const float y = b >= 0.0f ? r.y1 : r.y0;
  const float e = x * a + y * b + c;
  const float s = fabsf(a) * r.x1 + fabsf(b) * r.y1 + fabsf(c);
  return e < -1e-5f * s;
}

// Is staged pair j relevant to this warp: its strip span meets the warp's
// rows, and none of its edges excludes the warp's whole rectangle?
__device__ __forceinline__ bool pair_meets(const Stage& st, int j, int span_e,
                                           float sub_rows, const WarpRows& w,
                                           const Rect& r) {
  const float* sp = reinterpret_cast<const float*>(st.span);
  if (!span_meets(sp[j * 4 + span_e], sub_rows, w)) return false;
  const float4 q0 = st.rast[j * 3];
  const float4 q1 = st.rast[j * 3 + 1];
  const float c2 = st.rast[j * 3 + 2].x;
  return !(edge_misses(q0.x, q0.y, q0.z, r) ||
           edge_misses(q0.w, q1.x, q1.y, r) ||
           edge_misses(q1.z, q1.w, c2, r));
}

__device__ __forceinline__ int n_chunks(const Seq& s) {
  return (s.total + kChunk - 1) / kChunk;
}

// Bits [lo, hi) of a 64-bit chunk mask (0 <= lo <= hi <= 64).
__device__ __forceinline__ uint64_t bit_range(int lo, int hi) {
  const uint64_t below_hi = hi >= 64 ? ~0ull : ((1ull << hi) - 1ull);
  const uint64_t below_lo = lo >= 64 ? ~0ull : ((1ull << lo) - 1ull);
  return below_hi & ~below_lo;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Occlusion early-out arguments of a walk: z_col < 0 turns it off.
struct EarlyOut {
  int z_col;                 // record column of the pairs' z bucket
  int stride;                // test after every stride-th chunk
  int* __restrict__ skipped; // pair visits skipped are added here; may be 0
};

// Walks chunks [ch0, ch1) of the tile's sequence s (virtual indices
// [ch0 * kChunk, min(ch1 * kChunk, s.total))); bid[k] is the winner's pair
// id, or -1.
template <int NPP, bool X1>
__device__ __forceinline__ void walk(
    const TileCtx& c, const Seq& s, int ch0, int ch1,
    const float* __restrict__ records, int rec_w, int y_row, int sub_rows,
    int tile_h, int tile_w, const float (&px)[NPP], const float (&py)[NPP],
    float (&best)[NPP], int (&bid)[NPP], const EarlyOut eo) {
  __shared__ Stage stages[kStages];
  __shared__ float warp_best[kThreads / 32];
  const int v_end = min(s.total, ch1 * kChunk);
  const WarpRows wr = warp_rows<NPP>(c, tile_h, tile_w);
  const int lane = threadIdx.x % 32;
  // The staged fourth piece holds the span column (y_row) or, under the
  // early-out, which needs no span column, the z bucket column.
  const bool span_skip = y_row >= 0;
  const bool early = !span_skip && eo.z_col >= 0 && eo.stride > 0;
  const int col4 = span_skip ? y_row : (early ? eo.z_col : -1);
  const int span_q = col4 >= 0 ? col4 / 4 : -1;
  const int span_e = col4 >= 0 ? col4 % 4 : 0;
  const int len01 = s.len[0] + s.len[1];
  bool stopped[3] = {false, false, false};
  int n_skipped = 0;
  const float subf = (float)sub_rows;
  const Rect rect = {(float)(c.tx * tile_w) + 0.5f,
                     (float)(c.tx * tile_w + tile_w - 1) + 0.5f,
                     wr.r0 + 0.5f, wr.r1 + 0.5f};
#pragma unroll
  for (int k = 0; k < NPP; ++k) bid[k] = -1;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i)
    issue_chunk(stages[i], s, records, rec_w, span_q, (ch0 + i) * kChunk,
                v_end);

  for (int ch = ch0; ch < ch1; ++ch) {
    // Chunk ch has landed (for this thread's piece; the barrier makes every
    // piece visible), and every warp is done with chunk ch - 1, whose stage
    // the next issue overwrites.
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue_chunk(stages[(ch - ch0 + kStages - 1) % kStages], s, records,
                rec_w, span_q, (ch + kStages - 1) * kChunk, v_end);
    const Stage& st = stages[(ch - ch0) % kStages];
    const int v0 = ch * kChunk;
    const int n = min(kChunk, v_end - v0);
    uint64_t m;
    if (!wr.any) {
      m = 0;
    } else if (!span_skip) {
      m = n == kChunk ? ~0ull : ((1ull << n) - 1ull);
    } else {
      const bool in0 =
          lane < n && pair_meets(st, lane, span_e, subf, wr, rect);
      const bool in1 =
          lane + 32 < n && pair_meets(st, lane + 32, span_e, subf, wr, rect);
      m = (uint64_t)__ballot_sync(0xffffffffu, in0) |
          ((uint64_t)__ballot_sync(0xffffffffu, in1) << 32);
    }
    // Range boundaries inside this chunk: bits [0, end0) dense,
    // [end0, end1) supertile, [end1, n) global.
    const int end0 = min(max(s.len[0] - v0, 0), n);
    const int end1 = min(max(len01 - v0, 0), n);
    if (early && (stopped[0] || stopped[1] || stopped[2])) {
      const uint64_t gone = (stopped[0] ? bit_range(0, end0) : 0ull) |
                            (stopped[1] ? bit_range(end0, end1) : 0ull) |
                            (stopped[2] ? bit_range(end1, n) : 0ull);
      m &= ~gone;
      n_skipped += __popcll(gone);
    }
    while (m) {
      const int j = __ffsll((long long)m) - 1;
      m &= m - 1;
      const float4 q0 = st.rast[j * 3];
      const float4 q1 = st.rast[j * 3 + 1];
      const float4 q2 = st.rast[j * 3 + 2];
      const float a0 = q0.x, a1 = q0.y, a2 = q0.z;
      const float b0 = q0.w, b1 = q1.x, b2 = q1.y;
      const float c0 = q1.z, c1 = q1.w, c2 = q2.x;
      const float z0 = q2.y, z1 = q2.z, z2 = q2.w;
      // Edge values fma(a, px, b * py) + c and depth
      // fma(e2, z2, fma(e0, z0, e1 * z1)): the JAX package's compiled
      // form (ops/rasterize.py::edge_value, plane_depth). With X1 every k
      // shares px[0].
#pragma unroll
      for (int k = 0; k < NPP; ++k) {
        const float x = X1 ? px[0] : px[k];
        const float e0 = __fmaf_rn(a0, x, py[k] * a1) + a2;
        const float e1 = __fmaf_rn(b0, x, py[k] * b1) + b2;
        const float e2 = __fmaf_rn(c0, x, py[k] * c1) + c2;
        const float d = __fmaf_rn(e2, z2, __fmaf_rn(e0, z0, e1 * z1));
        const float esum = e0 + e1 + e2;
        const float emin = fminf(fminf(e0, e1), e2);
        const bool inside =
            (emin >= 0.0f) && (esum > 0.0f) && (d >= 0.0f) && (d <= 1.0f);
        if (inside && d < best[k]) {
          best[k] = d;
          bid[k] = v0 + j;  // virtual index; mapped to the pair id below
        }
      }
    }
    if (early && (ch - ch0) % eo.stride == eo.stride - 1) {
      // The block's max over its pixels of min(acc, init) (pixel slots
      // outside the tile hold -1), against each live range's largest z
      // bucket in this chunk. Every warp computes the same flags.
      float mx = best[0];
#pragma unroll
      for (int k = 1; k < NPP; ++k) mx = fmaxf(mx, best[k]);
      mx = warp_max(mx);
      if (lane == 0) warp_best[threadIdx.x / 32] = mx;
      __syncthreads();
      float eff = warp_best[0];
#pragma unroll
      for (int w = 1; w < kThreads / 32; ++w) eff = fmaxf(eff, warp_best[w]);
      const float* zs = reinterpret_cast<const float*>(st.span);
      float zr[3] = {-INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        if (j < n) {
          const int r = j < end0 ? 0 : (j < end1 ? 1 : 2);
          zr[r] = fmaxf(zr[r], zs[j * 4 + span_e]);
        }
      }
#pragma unroll
      for (int r = 0; r < 3; ++r)
        stopped[r] = stopped[r] || eff < warp_max(zr[r]);
    }
  }
  cp_async_wait<0>();  // the trailing groups are empty; drain them anyway
  if (early && eo.skipped != nullptr && threadIdx.x == 0 && n_skipped > 0)
    atomicAdd(eo.skipped, n_skipped);
#pragma unroll
  for (int k = 0; k < NPP; ++k)
    if (bid[k] >= 0) bid[k] = seq_pair(s, bid[k]);
}

}  // namespace strip
}  // namespace zk
