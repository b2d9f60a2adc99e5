// Shared phase 1 of the pair rasterizer kernels (pair_raster.cu,
// pair_raster_fused.cu): one thread block walks one screen tile's pair
// ranges and keeps, per pixel, the minimum depth and the lowest pair id
// among the minimum-depth candidates.
//
// Replaces the walk of zeldaengine_tpu/ops/rasterize_pallas.py
// (_make_walk + _run_raster_walk_accwide). That walk stages 128-pair
// record slices into fast memory and reduces over the pair axis with a
// packed (depth, lane) key. Here each of the 256 threads owns NPP fixed
// pixels of the tile with (depth, pair id) in registers, a chunk of
// records is staged through shared memory, and every thread tests every
// staged pair against its own pixels. Walking pairs in ascending id and
// taking a candidate only on strict d < current reproduces "lowest pair
// id among minimum-depth candidates; init_depth wins ties" exactly,
// because dense < supertile < global in the sort-key order.
//
// Arithmetic is written in the operation order of the plain PyTorch
// version (ops/rasterize_cuda.py) and the file is compiled with
// -fmad=false, so coverage and depth agree with it bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace zk {

constexpr int kThreads = 256;
constexpr int kChunk = 64;   // pairs staged per iteration
constexpr int kRastW = 12;   // 9 edge + 3 depth coefficients per record

struct TileCtx {
  int tx, ty;        // tile coordinates
  int ranges[3][2];  // dense, supertile, global pair ranges [lo, hi)
};

__device__ __forceinline__ TileCtx tile_context(
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ sstarts, const int* __restrict__ sends,
    const int* __restrict__ gbounds, int n_tx, int n_sx, int super_h,
    int super_w) {
  TileCtx c;
  const int t = blockIdx.x;
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

// Pixel k of this thread: linear tile pixel p = k * 256 + threadIdx.x.
template <int NPP>
__device__ __forceinline__ void pixel_setup(
    const TileCtx& c, int tile_h, int tile_w, int width,
    const float* __restrict__ init_depth, float (&px)[NPP], float (&py)[NPP],
    float (&best)[NPP], int (&gidx)[NPP]) {
  const int tile_pixels = tile_h * tile_w;
#pragma unroll
  for (int k = 0; k < NPP; ++k) {
    const int p = k * kThreads + threadIdx.x;
    if (p < tile_pixels) {
      const int gx = c.tx * tile_w + p % tile_w;
      const int gy = c.ty * tile_h + p / tile_w;
      px[k] = (float)gx + 0.5f;
      py[k] = (float)gy + 0.5f;
      gidx[k] = gy * width + gx;
      best[k] = init_depth ? init_depth[gidx[k]] : 1.0f;
    } else {
      px[k] = 0.0f;
      py[k] = 0.0f;
      gidx[k] = -1;
      best[k] = -1.0f;  // below every accepted depth: never taken
    }
  }
}

template <int NPP, bool WANT_ID>
__device__ __forceinline__ void walk_ranges(
    const TileCtx& c, const float* __restrict__ records, int rec_w,
    const float (&px)[NPP], const float (&py)[NPP], float (&best)[NPP],
    int (&bid)[NPP]) {
  __shared__ float srec[kChunk * kRastW];
#pragma unroll
  for (int k = 0; k < NPP; ++k) bid[k] = -1;

  for (int r = 0; r < 3; ++r) {
    const int lo = c.ranges[r][0];
    const int hi = c.ranges[r][1];
    for (int base = lo; base < hi; base += kChunk) {
      const int n = min(kChunk, hi - base);
      __syncthreads();
      for (int i = threadIdx.x; i < n * kRastW; i += kThreads) {
        const int j = i / kRastW;
        srec[i] = records[(size_t)(base + j) * rec_w + (i - j * kRastW)];
      }
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        const float* q = srec + j * kRastW;
        const float a0 = q[0], a1 = q[1], a2 = q[2];
        const float b0 = q[3], b1 = q[4], b2 = q[5];
        const float c0 = q[6], c1 = q[7], c2 = q[8];
        const float z0 = q[9], z1 = q[10], z2 = q[11];
#pragma unroll
        for (int k = 0; k < NPP; ++k) {
          const float e0 = px[k] * a0 + py[k] * a1 + a2;
          const float e1 = px[k] * b0 + py[k] * b1 + b2;
          const float e2 = px[k] * c0 + py[k] * c1 + c2;
          const float d = e0 * z0 + e1 * z1 + e2 * z2;
          const float esum = e0 + e1 + e2;
          const float emin = fminf(fminf(e0, e1), e2);
          const bool inside =
              (emin >= 0.0f) && (esum > 0.0f) && (d >= 0.0f) && (d <= 1.0f);
          if (inside && d < best[k]) {
            best[k] = d;
            if (WANT_ID) bid[k] = base + j;
          }
        }
      }
    }
  }
}

// NPP (pixels per thread) for a tile, rounded up to a power of two.
inline int pixels_per_thread(int tile_h, int tile_w) {
  const int need = (tile_h * tile_w + kThreads - 1) / kThreads;
  int npp = 1;
  while (npp < need) npp *= 2;
  return npp;
}

}  // namespace zk
