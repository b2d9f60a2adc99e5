// K3 pcf_taps: the (2r+1)^2-tap percentage-closer shadow filter.
//
// Replaces: zeldaengine_tpu/ops/pcf_vmem.py::_pcf_kernel (entry
// compute_pcf_vmem). ComputePCF (Common.glsl:323-342): per pixel, taps at
// texel floor(f + scale*o) for o in [-r, r]^2 with repeat addressing,
// sum of (tap < z - bias ? 0.1 : 1.0) in oy-major / ox-minor order, over
// the tap count; pixels whose shadow coordinate is out of range read 1.0.
//
// Bound on this card: bytes (a pixel reads its 16-byte shadow coordinate
// and writes 4 bytes; the 4 MB map stays in L2). What the design does about
// the work around the bytes:
// - Gathers. A warp's tap load from L1 costs one pass per distinct
//   128-byte line its lanes touch, and a warp's taps span several map
//   rows. A block of 32 x 16 pixels covers a small patch of the map, so the
//   block first finds the box of texel indices its taps reach (warp
//   reductions), copies the box's wrapped texels into shared memory, and
//   taps there, where lanes on the same texel share one read. This is the
//   TPU kernel's window in fast memory, per block; a block whose box
//   exceeds kWin texels (about 2 % of the frame's) taps the map directly
//   (read-only path), so there is no fit test to recompute.
//   tests/torch_pcf_taps_variants.py times the kernel without the window.
// - Integer work. Each axis's 2r+1 texel indices are computed once per
//   pixel, each from its own (int)floorf(f + scale*o) as in the plain
//   version, so the taps are its taps. Wrapping takes no division per tap:
//   the first index of an axis is wrapped with one remainder and every
//   further one as wrap(i_0) + (i_k - i_0), less the map size once (exact
//   for any int; an index more than one map width past takes the
//   remainder).
// - An out-of-range pixel writes 1.0f without touching the map: its
//   (2r+1)^2 taps of 1.0f sum exactly and divide to exactly 1.0f.
// - Warps are 8 x 4 pixels (a warp's taps span fewer map rows than a
//   32 x 1 run), and a thread takes two pixels 8 rows apart, which shares
//   the box, the copy and the barriers between twice the pixels;
//   coordinates load as one float4 per pixel (128 bytes per 8-pixel row),
//   which is the traffic the bound counts.
// The window kernel unrolls the frame's radius (kWindowRadius, the default
// pcf_radius); any other radius takes pcf_taps_direct_kernel, the radius a
// run-time value (the variants script also times one kernel unrolled to a
// compile-time maximum radius instead). The f32 sum is taken in the
// reference order (25 x 0.1f in f32 is not 2.5f, so the order is part of
// the result).
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kNP = 2;            // pixels a thread, 8 rows apart
constexpr int kBlockX = 32;       // pixels: 4 warps of 8 across
constexpr int kBlockY = 8 * kNP;  // 2 warps of 4 down, kNP times
constexpr int kThreads = 256;
constexpr int kWin = 4096;        // texels of a block's map window (16 KB)
constexpr int kWindowRadius = 2;  // the radius the window kernel unrolls

__device__ __forceinline__ int wrap(int i, int n) {
  int m = i % n;
  return m < 0 ? m + n : m;
}

// Index i wrapped into [0, n), given i0 and w0 = wrap(i0, n).
__device__ __forceinline__ int wrap_from(int w0, int i0, int i, int n) {
  long long t = (long long)w0 + ((long long)i - (long long)i0);
  if (t >= n) t -= n;
  if (t >= n || t < 0) {
    t %= n;
    if (t < 0) t += n;
  }
  return (int)t;
}

// t in [0, n + kWin) wrapped into [0, n): the window's texel columns and
// rows, a box side at most kWin past a wrapped corner.
__device__ __forceinline__ int wrap_near(int t, int n) {
  if (t >= n) t -= n;
  return t >= n ? t % n : t;
}

struct Pixel {
  size_t i;         // index into the (height, width) planes
  bool inside;      // inside the frame
  bool in_range;    // ComputePCF's z / w test
  float fx, fy, z_cmp;
};

// Pixel j of this thread (a warp holds 8 x 4 pixels, its pixel j the
// rows 8 * j below pixel 0) and its shadow coordinate, divided by w in
// the reference's order.
__device__ __forceinline__ Pixel load_pixel(const float4* __restrict__ coord,
                                            int height, int width, int dim_y,
                                            int dim_x, float bias, int j) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int x = blockIdx.x * kBlockX + (warp % 4) * 8 + lane % 8;
  const int y = blockIdx.y * kBlockY + j * 8 + (warp / 4) * 4 + lane / 8;
  Pixel p;
  p.inside = x < width && y < height;
  p.i = (size_t)y * width + x;
  p.in_range = false;
  p.fx = p.fy = p.z_cmp = 0.0f;
  if (p.inside) {
    const float4 c = coord[p.i];
    const float wd = fabsf(c.w) > 1e-20f ? c.w : 1.0f;
    const float sx = c.x / wd, sy = c.y / wd, z = c.z / wd;
    const float w_post = c.w / wd;
    p.in_range = (z > -1.0f) && (z < 1.0f) && (w_post > 0.0f);
    p.z_cmp = z - bias;
    p.fx = sx * (float)dim_x;
    p.fy = sy * (float)dim_y;
  }
  return p;
}

template <int R>
__global__ void __launch_bounds__(kThreads) pcf_taps_window_kernel(
    const float* __restrict__ sm, int dim_y, int dim_x,
    const float4* __restrict__ coord, float* __restrict__ out, int height,
    int width, float scale, float bias) {
  constexpr int N = 2 * R + 1;
  __shared__ float win[kWin];
  __shared__ int box[4][kThreads / 32];
  Pixel p[kNP];
  int ix[kNP][N], iy[kNP][N];
  // The box of texel indices (before wrapping) the block's taps reach:
  // floor(f + scale*o) is monotone in o, so the ends are the extremes.
  int v[4] = {INT_MAX, INT_MIN, INT_MAX, INT_MIN};
#pragma unroll
  for (int j = 0; j < kNP; ++j) {
    p[j] = load_pixel(coord, height, width, dim_y, dim_x, bias, j);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      ix[j][k] = (int)floorf(p[j].fx + scale * (float)(k - R));
      iy[j][k] = (int)floorf(p[j].fy + scale * (float)(k - R));
    }
    if (p[j].in_range) {
      v[0] = min(v[0], min(ix[j][0], ix[j][N - 1]));
      v[1] = max(v[1], max(ix[j][0], ix[j][N - 1]));
      v[2] = min(v[2], min(iy[j][0], iy[j][N - 1]));
      v[3] = max(v[3], max(iy[j][0], iy[j][N - 1]));
    }
  }
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[q] = q % 2 ? __reduce_max_sync(0xffffffffu, v[q])
                 : __reduce_min_sync(0xffffffffu, v[q]);
    if (lane == 0) box[q][threadIdx.x / 32] = v[q];
  }
  __syncthreads();
  // Every warp reduces the 8 warps' values itself: no second barrier.
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int none = q % 2 ? INT_MIN : INT_MAX;
    const int b = lane < kThreads / 32 ? box[q][lane] : none;
    v[q] = q % 2 ? __reduce_max_sync(0xffffffffu, b)
                 : __reduce_min_sync(0xffffffffu, b);
  }
  const int bx0 = v[0], by0 = v[2];
  const long long bw = (long long)v[1] - bx0 + 1;
  const long long bh = (long long)v[3] - by0 + 1;
  // Block-uniform: some pixel taps, and its box fits the window (each side
  // checked first: a side of a saturated box is 2^32, its area overflows).
  const bool use_win =
      bx0 != INT_MAX && bw <= kWin && bh <= kWin && bw * bh <= kWin;
  const int bwi = (int)bw;
  if (use_win) {
    // Warp w copies rows w, w + 8, ... of the box, lane = column.
    const int wx0 = wrap(bx0, dim_x), wy0 = wrap(by0, dim_y);
    for (int dy = threadIdx.x / 32; dy < (int)bh; dy += kThreads / 32) {
      const float* row = sm + (size_t)wrap_near(wy0 + dy, dim_y) * dim_x;
      for (int dx = lane; dx < bwi; dx += 32)
        win[dy * bwi + dx] = __ldg(row + wrap_near(wx0 + dx, dim_x));
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kNP; ++j) {
    if (!p[j].inside) continue;
    if (!p[j].in_range) {
      out[p[j].i] = 1.0f;
      continue;
    }
    float total = 0.0f;
    if (use_win) {
      // Inside the box: offsets below kWin, no overflow.
      int cx[N];
#pragma unroll
      for (int k = 0; k < N; ++k) cx[k] = ix[j][k] - bx0;
#pragma unroll
      for (int ky = 0; ky < N; ++ky) {
        const float* row = win + (iy[j][ky] - by0) * bwi;
#pragma unroll
        for (int kx = 0; kx < N; ++kx)
          total = total + (row[cx[kx]] < p[j].z_cmp ? 0.1f : 1.0f);
      }
    } else {
      // The same indices, wrapped, straight from the map.
      const int wx0 = wrap(ix[j][0], dim_x), wy0 = wrap(iy[j][0], dim_y);
      int wx[N];
#pragma unroll
      for (int k = 0; k < N; ++k)
        wx[k] = wrap_from(wx0, ix[j][0], ix[j][k], dim_x);
#pragma unroll
      for (int ky = 0; ky < N; ++ky) {
        const float* row =
            sm + (size_t)wrap_from(wy0, iy[j][0], iy[j][ky], dim_y) * dim_x;
#pragma unroll
        for (int kx = 0; kx < N; ++kx)
          total = total + (__ldg(row + wx[kx]) < p[j].z_cmp ? 0.1f : 1.0f);
      }
    }
    out[p[j].i] = total / (float)(N * N);
  }
}

// Any other radius, as a run-time value: the taps straight from the map,
// each index from its own floor, wrapped from the axis's first without a
// division (column indices taken again for each row).
__global__ void __launch_bounds__(kThreads) pcf_taps_direct_kernel(
    const float* __restrict__ sm, int dim_y, int dim_x,
    const float4* __restrict__ coord, float* __restrict__ out, int height,
    int width, int radius, float scale, float bias) {
  const int n = 2 * radius + 1;
  for (int j = 0; j < kNP; ++j) {
    const Pixel p = load_pixel(coord, height, width, dim_y, dim_x, bias, j);
    if (!p.inside) continue;
    if (!p.in_range) {
      out[p.i] = 1.0f;
      continue;
    }
    const int ix0 = (int)floorf(p.fx + scale * (float)(-radius));
    const int iy0 = (int)floorf(p.fy + scale * (float)(-radius));
    const int wx0 = wrap(ix0, dim_x), wy0 = wrap(iy0, dim_y);
    float total = 0.0f;
    for (int ky = 0; ky < n; ++ky) {
      const int iy = (int)floorf(p.fy + scale * (float)(ky - radius));
      const float* row = sm + (size_t)wrap_from(wy0, iy0, iy, dim_y) * dim_x;
      for (int kx = 0; kx < n; ++kx) {
        const int ix = (int)floorf(p.fx + scale * (float)(kx - radius));
        total = total + (__ldg(row + wrap_from(wx0, ix0, ix, dim_x)) < p.z_cmp
                             ? 0.1f
                             : 1.0f);
      }
    }
    out[p.i] = total / (float)(n * n);
  }
}

}  // namespace

// shadowmap (dim_y, dim_x) f32; shadow_coord (height, width, 4) f32
// homogeneous (divided by w in the kernel), 16-byte aligned; out (height,
// width) f32.
extern "C" int zk_pcf_taps(const void* shadowmap, int dim_y, int dim_x,
                           const void* shadow_coord, void* out, int height,
                           int width, int radius, float scale, float bias,
                           void* stream) {
  if (radius < 0 || ((size_t)shadow_coord & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((width + kBlockX - 1) / kBlockX,
                  (height + kBlockY - 1) / kBlockY);
  cudaStream_t s = (cudaStream_t)stream;
  const float* smf = (const float*)shadowmap;
  const float4* sc = (const float4*)shadow_coord;
  float* o = (float*)out;
  if (radius == kWindowRadius)
    pcf_taps_window_kernel<kWindowRadius><<<grid, kThreads, 0, s>>>(
        smf, dim_y, dim_x, sc, o, height, width, scale, bias);
  else
    pcf_taps_direct_kernel<<<grid, kThreads, 0, s>>>(
        smf, dim_y, dim_x, sc, o, height, width, radius, scale, bias);
  return (int)cudaGetLastError();
}
