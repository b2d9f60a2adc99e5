// K6 pcf_window: the windowed PCF (pcf_backend "pallas"), from the shadow
// coordinate to the shadow factor in one launch.
//
// Replaces: zeldaengine_tpu/ops/pcf_pallas.py::_pcf_kernel and the wrapper
// arithmetic around it (entry compute_pcf_pallas). Each (tile_h, tile_w)
// screen tile filters inside one (win, win) window of the wrap-padded
// shadow map. The window's origin comes from the tile's mean texel
// coordinate weighted by in-range x valid (the plain mean where no pixel
// weighs), rounded half to even, shifted by the pad, clamped and aligned
// down to 8 rows and 128 columns. Per pixel and tap (oy-major, ox-minor):
// row floor(fy + scale*oy) - wy and column floor(fx + scale*ox) - wx, each
// clamped to [0, win - 1]; the tap reads 0.1 where the pixel is in range
// and the depth is below z - bias, else 1.0; the f32 sum in tap order
// over the tap count. The TPU kernel fetches tap rows with one-hot MXU
// products over a bf16 hi/lo split of the window because it has no
// per-lane gather; a thread here loads the exact fp32 texel, which is the
// function the kernel's contract states.
//
// Bound on this card: bytes. A pixel reads its 16-byte coordinate and its
// 1-byte valid flag and writes 4 bytes; the 4 MB map is read once (it
// stays in L2): 47.7 MB, 0.0142 ms at 3.35 TB/s for the 1080p frame. The
// 25 taps a pixel makes (52 M at 1080p) are the work around the bytes.
//
// Why one block per tile does both the reduction and the taps: the origin
// is a reduction over the tile, and the taps of every pixel of the tile
// need it. A block that owns the tile reduces the origin in shared memory
// and taps with the same threads, its per-pixel values still in
// registers: each coordinate is read once, and nothing per pixel is
// written between the two phases (the TPU wrapper wrote five full-frame
// planes and a padded copy of the map for its kernel to read).
// - Phase 1. A thread loads its pixels' float4 coordinates (a warp reads
//   32 neighbouring pixels of one row), four pixels' loads issued before
//   any is used: a branch on a loaded value, or a division's slow-path
//   call, would make each load wait for the one before. It divides by w
//   (skipped where w is 1, as x / 1 is x), wraps the texel coordinates
//   with torch.remainder's formula (fmod, then + dim where the signs
//   differ; a coordinate already in [0, dim) is its own remainder) and
//   adds the tile's sums (sum fx*weight, fy*weight, and for a tile where
//   no pixel weighs, fx and fy) in ONE fixed order: sequential over the
//   thread's pixels, then a halving tree over the lanes (shfl_down 16, 8,
//   4, 2, 1), then the same tree over the warps' partials, zero-padded to
//   32. ops/pcf_window.py::tile_sums_plain repeats that order. The sum of
//   the 0/1 weights is an exact integer in any order, so it is added as
//   one. Rows and columns past the frame read as zero coordinates that
//   never weigh, as the frame's zero padding did.
// - The same reduction takes the extreme fx and fy of the in-range pixels
//   (non-negative floats order as their bits). floor(f + scale*o) is
//   monotone in f and in o, so their floors at the end offsets bound every
//   tap index: the box of the tile's taps. Clamping is monotone too, so
//   the clamped box is the clamped ends, and a box inside the window
//   needs no clamp. A NaN coordinate leaves the tile without a box: it
//   taps the map directly, clamped.
// - Phase 2. The origin is uniform over the block: no per-pixel division
//   by a tile size. Each axis's 2r+1 clamped indices are computed once per
//   pixel, each from its own floor(f + scale*o). Out-of-range pixels write
//   1.0f at once ((2r+1)^2 ones sum and divide to exactly 1.0f). The
//   25-tap quotient is total * fl(1/25) corrected by one fma, which is
//   the division for every sum 25 taps can reach.
// - The padded map is never built: padded index p holds texel
//   (p - pad) mod dim (numpy's mode="wrap"). With base = (origin - pad)
//   mod dim, taken once per block, and a window offset below win <= dim,
//   a tap's texel is base + offset less dim once, exact for every map the
//   wrapper takes, also one narrower than the 128-column pad.
// - The tile's tap box, if it holds at most stage_texels texels, is copied
//   into shared memory and the taps read it there (lanes on the same
//   texel share one read); a larger box taps the map through __ldg in the
//   same kernel. The wrapper's STAGE_TEXELS = 0 turns the stage off:
//   chip_smoke.py times both (`ms`, `ms_direct_taps`). On an NVIDIA H100
//   80GB HBM3 at 700 W, with 95.7 % of the 1080p frame's tiles staged
//   (median box 816 texels), the stage took the kernel from 0.0435 to
//   0.0388 ms, eight times its run-to-run spread (PERF.md §6).
// - Occupancy hides phase 1's memory latency: 64 registers a thread (the
//   launch bound of two 512-thread blocks) keep four 256-thread blocks
//   on a multiprocessor. tests/torch_pcf_window_timing.py --variants
//   times this source against more registers, the IEEE division and
//   loads issued one pixel at a time.
// The radius of the config (kR) is unrolled with its indices hoisted;
// any other radius runs the same kernel with run-time loops.
// Compiled with -fmad=false: the plain version's separate multiply and
// add are what the compares at tap ~= z - bias see.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxPx = 8;       // pixels a thread at most
constexpr int kStage = 8192;    // texels of the staged tap box (32 KB)
constexpr int kR = 2;           // the radius whose taps are unrolled
constexpr int kBatch = 4;       // pixels whose loads phase 1 issues at once

// torch.remainder(a, b) for b > 0: fmod, plus b where the signs differ.
// For a power-of-two b, a - trunc(a / b) * b is fmod exactly (a / b and
// the product only move exponents, the difference is representable), but
// for the sign of a zero, which fmod takes from a.
__device__ __forceinline__ float remainder_f(float a, float b, bool pow2) {
  if (a >= 0.0f && a < b) return a;  // -0.0 too: fmod keeps a's sign
  float m;
  if (pow2) {
    m = a - truncf(a * (1.0f / b)) * b;
    if (m == 0.0f) m = copysignf(0.0f, a);
  } else {
    m = fmodf(a, b);
  }
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

// Halving tree over the warp: lane 0 ends with the total.
__device__ __forceinline__ float tree_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = v + __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// (int)floorf(f + off) in one conversion (round down, as floor).
__device__ __forceinline__ int floor_i(float f, float off) {
  return __float2int_rd(f + off);
}

// Where a tile's taps read: the staged box (S), or the map itself. C:
// clamp the indices into the window; a tile whose box lies inside its
// window needs no clamp (block-uniform).
struct Taps {
  const float* stage;
  const float* sm;
  int dim, bx0, by0, bw, base_x, base_y, wx, wy, win;

  // Offset of window row ry and of window column cx (both clamped to
  // [0, win)); a tap reads at(row + col).
  template <bool S, bool C>
  __device__ __forceinline__ int row_of(float f, float off) const {
    if (!C) return (floor_i(f, off) - (wy + by0)) * bw;
    const int ry = min(max(floor_i(f, off) - wy, 0), win - 1);
    if (S) return (ry - by0) * bw;
    const int r = base_y + ry;
    return (r >= dim ? r - dim : r) * dim;
  }
  template <bool S, bool C>
  __device__ __forceinline__ int col_of(float f, float off) const {
    if (!C) return floor_i(f, off) - (wx + bx0);
    const int cx = min(max(floor_i(f, off) - wx, 0), win - 1);
    if (S) return cx - bx0;
    const int c = base_x + cx;
    return c >= dim ? c - dim : c;
  }
  template <bool S>
  __device__ __forceinline__ float at(int i) const {
    return S ? stage[i] : __ldg(sm + i);
  }
};

// The taps of one in-range pixel: R >= 0 unrolls radius R with each axis's
// indices hoisted; R < 0 takes the run-time radius.
template <bool S, bool C, int R>
__device__ __forceinline__ float taps(const Taps& t, float fx, float fy,
                                      float zc, float scale, int radius) {
  if constexpr (R >= 0) {
    constexpr int N = 2 * R + 1;
    int col[N], row[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float off = scale * (float)(k - R);
      col[k] = t.col_of<S, C>(fx, off);
      row[k] = t.row_of<S, C>(fy, off);
    }
    float total = 0.0f;
#pragma unroll
    for (int ky = 0; ky < N; ++ky)
#pragma unroll
      for (int kx = 0; kx < N; ++kx)
        total = total + (t.at<S>(row[ky] + col[kx]) < zc ? 0.1f : 1.0f);
    if (N * N == 25) {
      // total / 25 as q = total * fl(1/25) corrected by one fma step:
      // correctly rounded for each of the 124 sums 25 taps of 0.1f and
      // 1.0f can reach (tests/test_torch_pcf_window.py enumerates them).
      const float r = 1.0f / 25.0f;
      const float q = total * r;
      return fmaf(fmaf(-q, 25.0f, total), r, q);
    }
    return total / (float)(N * N);
  } else {
    float total = 0.0f;
    for (int oy = -radius; oy <= radius; ++oy) {
      const int row = t.row_of<S, C>(fy, scale * (float)oy);
      for (int ox = -radius; ox <= radius; ++ox) {
        const int col = t.col_of<S, C>(fx, scale * (float)ox);
        total = total + (t.at<S>(row + col) < zc ? 0.1f : 1.0f);
      }
    }
    const int n = 2 * radius + 1;
    return total / (float)(n * n);
  }
}

// A thread's pixels, in the order phase 1 visited them.
struct PixelWalk {
  int qy, qx, step_y, step_x, tile_w;
  __device__ __forceinline__ void next() {
    qx += step_x;
    qy += step_y;
    if (qx >= tile_w) {
      qx -= tile_w;
      ++qy;
    }
  }
};

template <bool S, bool C, int R>
__device__ __forceinline__ void tap_pixels(
    const Taps& t, PixelWalk p, int y0, int x0, int width, int per_thread,
    unsigned inside, unsigned in_range, const float (&fx)[kMaxPx],
    const float (&fy)[kMaxPx], const float (&zc)[kMaxPx], float scale,
    int radius, float* __restrict__ out) {
#pragma unroll
  for (int j = 0; j < kMaxPx; ++j) {
    if (j < per_thread && (inside >> j & 1u)) {
      const float f = (in_range >> j & 1u)
                          ? taps<S, C, R>(t, fx[j], fy[j], zc[j], scale,
                                          radius)
                          : 1.0f;
      out[(y0 + p.qy) * width + x0 + p.qx] = f;
    }
    p.next();
  }
}

__global__ void __launch_bounds__(kMaxThreads, 2) pcf_window_kernel(
    const float* __restrict__ sm, const float4* __restrict__ coord,
    const unsigned char* __restrict__ valid, float* __restrict__ out,
    int2* __restrict__ origins_out, int height, int width, int tile_h,
    int tile_w, int n_tx, int per_thread, int dim, int win, int pad_y,
    int pad_x, int py_dim, int px_dim, int radius, float scale, float bias,
    int stage_texels) {
  __shared__ float stage[kStage];
  __shared__ float part_f[4][32];
  __shared__ int part_i[6][32];
  const int n_threads = blockDim.x, n_warps = n_threads / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = blockIdx.x / n_tx, tx = blockIdx.x - ty * n_tx;
  const int y0 = ty * tile_h, x0 = tx * tile_w;
  // Pixel j of this thread is the tile's pixel j * n_threads + threadIdx.x
  // in row-major order: a run of whole rows per j.
  PixelWalk walk;
  walk.qy = threadIdx.x / tile_w;
  walk.qx = threadIdx.x - walk.qy * tile_w;
  walk.step_y = n_threads / tile_w;
  walk.step_x = n_threads - walk.step_y * tile_w;
  walk.tile_w = tile_w;
  const float fdim = (float)dim;
  const bool pow2 = (dim & (dim - 1)) == 0;
  const float off_lo = scale * (float)(-radius), off_hi = scale * (float)radius;

  float fx[kMaxPx], fy[kMaxPx], zc[kMaxPx];
  unsigned inside = 0, in_range = 0;
  // s: sum fx * weight, fy * weight, fx, fy. n: sum weight (weights are
  // 0 or 1, so the sum is an exact integer, the float tree's value).
  // b: the box's corners as the bits of the extreme fx, fy of in-range
  // pixels (non-negative floats order as their bits), and whether one of
  // them is NaN (no box then).
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int b[6] = {0, INT_MAX, INT_MIN, INT_MAX, INT_MIN, 0};
  PixelWalk p = walk;
#pragma unroll
  for (int j0 = 0; j0 < kMaxPx; j0 += kBatch) {
    // The batch's loads first: nothing waits on a load before the next
    // is issued (no branch on a loaded value; a division's slow path is a
    // call no load moves above). Past the frame: zero coordinates, not
    // valid (the frame's padding).
    float4 c[kBatch];
    unsigned vb[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      c[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      vb[k] = 0;
      if (j0 + k < per_thread) {
        const int y = y0 + p.qy, x = x0 + p.qx;
        if (y < height && x < width) {
          inside |= 1u << (j0 + k);
          const int g = y * width + x;
          c[k] = coord[g];
          vb[k] = valid == nullptr ? 1u : valid[g];
        }
        p.next();
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int j = j0 + k;
      if (j >= per_thread) break;
      const float4 q = c[k];
      const float v = vb[k] != 0 ? 1.0f : 0.0f;
      const bool big_w = fabsf(q.w) > 1e-20f;
      const float sw = big_w ? q.w : 1.0f;
      // x / 1 is x: the divisions of an orthographic light's w = 1 go.
      const bool one = sw == 1.0f;
      const float u = one ? q.x : q.x / sw;
      const float vv = one ? q.y : q.y / sw;
      const float z = one ? q.z : q.z / sw;
      // w / sw > 0: w / w is 1 for a finite w and NaN otherwise.
      const bool w_pos = big_w ? (q.w - q.w == 0.0f) : (q.w > 0.0f);
      const bool live = (z > -1.0f) && (z < 1.0f) && w_pos;
      const float ux = remainder_f(u * fdim, fdim, pow2);
      const float uy = remainder_f(vv * fdim, fdim, pow2);
      const float weight = (live ? 1.0f : 0.0f) * v;
      s[0] = s[0] + ux * weight;
      s[1] = s[1] + uy * weight;
      s[2] = s[2] + ux;
      s[3] = s[3] + uy;
      b[0] += weight != 0.0f;
      fx[j] = ux + (float)pad_x;
      fy[j] = uy + (float)pad_y;
      zc[j] = z - bias;
      if (live) {
        in_range |= 1u << j;
        b[1] = min(b[1], __float_as_int(fx[j]));
        b[2] = max(b[2], __float_as_int(fx[j]));
        b[3] = min(b[3], __float_as_int(fy[j]));
        b[4] = max(b[4], __float_as_int(fy[j]));
        b[5] |= (fx[j] != fx[j]) | (fy[j] != fy[j]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float t = tree_sum(s[q]);
    if (lane == 0) part_f[q][warp] = t;
  }
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const int t = q == 0   ? __reduce_add_sync(0xffffffffu, b[q])
                  : q == 5 ? __reduce_or_sync(0xffffffffu, b[q])
                  : q % 2  ? __reduce_min_sync(0xffffffffu, b[q])
                           : __reduce_max_sync(0xffffffffu, b[q]);
    if (lane == 0) part_i[q][warp] = t;
  }
  __syncthreads();
  // Every warp reduces the warps' partials itself, in the same order: no
  // second barrier, and every warp holds the same origin.
#pragma unroll
  for (int q = 0; q < 2; ++q)
    s[q] = __shfl_sync(0xffffffffu,
                       tree_sum(lane < n_warps ? part_f[q][lane] : 0.0f), 0);
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const int none = q == 0 || q == 5 ? 0 : q % 2 ? INT_MAX : INT_MIN;
    const int t = lane < n_warps ? part_i[q][lane] : none;
    b[q] = q == 0   ? __reduce_add_sync(0xffffffffu, t)
           : q == 5 ? __reduce_or_sync(0xffffffffu, t)
           : q % 2  ? __reduce_min_sync(0xffffffffu, t)
                    : __reduce_max_sync(0xffffffffu, t);
  }
  const float den = (float)b[0];
  float mx, my;
  if (den > 0.5f) {
    mx = s[0] / fmaxf(den, 1.0f);
    my = s[1] / fmaxf(den, 1.0f);
  } else {
    // No pixel weighs (block-uniform): the plain mean, its sums reduced
    // in the same order only for these tiles.
#pragma unroll
    for (int q = 2; q < 4; ++q) {
      const float t = tree_sum(s[q]);
      if (lane == 0) part_f[q][warp] = t;
    }
    __syncthreads();
#pragma unroll
    for (int q = 2; q < 4; ++q)
      s[q] = __shfl_sync(
          0xffffffffu, tree_sum(lane < n_warps ? part_f[q][lane] : 0.0f), 0);
    const float n_px = (float)(tile_h * tile_w);
    mx = s[2] / n_px;
    my = s[3] / n_px;
  }
  const float half_win = 0.5f * (float)win;
  Taps t;
  t.wy = min(max((int)rintf(my - half_win) + pad_y, 0), py_dim - win) & ~7;
  t.wx = min(max((int)rintf(mx - half_win) + pad_x, 0), px_dim - win) & ~127;
  if (origins_out != nullptr && threadIdx.x == 0)
    origins_out[blockIdx.x] = make_int2(t.wy, t.wx);
  t.sm = sm;
  t.dim = dim;
  t.win = win;
  t.stage = nullptr;
  t.base_x = (t.wx - pad_x) % dim;
  if (t.base_x < 0) t.base_x += dim;
  t.base_y = (t.wy - pad_y) % dim;
  if (t.base_y < 0) t.base_y += dim;
  bool unclamped = false;
  // Some pixel of the tile is in range, and its box is known.
  if (b[1] != INT_MAX && !b[5]) {
    // floor(f + scale*o) is monotone in f and in o: the extreme indices
    // are those of the extreme coordinates.
    const float lo_x = __int_as_float(b[1]), hi_x = __int_as_float(b[2]);
    const float lo_y = __int_as_float(b[3]), hi_y = __int_as_float(b[4]);
    const int x0i = min(floor_i(lo_x, off_lo), floor_i(lo_x, off_hi));
    const int x1i = max(floor_i(hi_x, off_lo), floor_i(hi_x, off_hi));
    const int y0i = min(floor_i(lo_y, off_lo), floor_i(lo_y, off_hi));
    const int y1i = max(floor_i(hi_y, off_lo), floor_i(hi_y, off_hi));
    unclamped = x0i >= t.wx && x1i - t.wx < win && y0i >= t.wy &&
                y1i - t.wy < win;
    t.bx0 = min(max(x0i - t.wx, 0), win - 1);
    t.by0 = min(max(y0i - t.wy, 0), win - 1);
    t.bw = min(max(x1i - t.wx, 0), win - 1) - t.bx0 + 1;
    const int bh = min(max(y1i - t.wy, 0), win - 1) - t.by0 + 1;
    const int n_box = t.bw * bh;  // at most win^2 <= dim^2 < 2^31
    if (n_box <= stage_texels) {
      // Texel i of the box (row-major) by thread i mod n_threads, four
      // loads in flight before their stores.
      constexpr int kCopy = 4;
      for (int i0 = threadIdx.x; i0 < n_box; i0 += kCopy * n_threads) {
        float val[kCopy];
#pragma unroll
        for (int k = 0; k < kCopy; ++k) {
          const int i = i0 + k * n_threads;
          if (i < n_box) {
            const int dy = i / t.bw, dx = i - dy * t.bw;
            int r = t.base_y + t.by0 + dy, cc = t.base_x + t.bx0 + dx;
            if (r >= dim) r -= dim;
            if (cc >= dim) cc -= dim;
            val[k] = __ldg(sm + r * dim + cc);
          }
        }
#pragma unroll
        for (int k = 0; k < kCopy; ++k)
          if (i0 + k * n_threads < n_box) stage[i0 + k * n_threads] = val[k];
      }
      __syncthreads();
      t.stage = stage;
    }
  }
#define ZK_TAP(S, C, R)                                                    \
  tap_pixels<S, C, R>(t, walk, y0, x0, width, per_thread, inside, in_range, \
                      fx, fy, zc, scale, radius, out)
  if (radius != kR) {
    if (t.stage) ZK_TAP(true, true, -1);
    else ZK_TAP(false, true, -1);
  } else if (!t.stage) {
    ZK_TAP(false, true, kR);
  } else if (unclamped) {
    ZK_TAP(true, false, kR);
  } else {
    ZK_TAP(true, true, kR);
  }
#undef ZK_TAP
}

}  // namespace

// shadowmap (dim, dim) f32; shadow_coord (height, width, 4) f32
// homogeneous, 16-byte aligned; valid (height, width) bytes 0/1 or null;
// out (height, width) f32; origins_out (n_ty, n_tx, 2) i32 (wy, wx) or
// null. The tiles cover ceil(height / tile_h) x ceil(width / tile_w);
// threads (a multiple of 32, at most 512) x per_thread (at most 8) is
// tile_h * tile_w. win <= dim; (pad_y, pad_x, py_dim, px_dim) is the
// padded map's geometry. stage_texels <= 8192 (0: never stage).
extern "C" int zk_pcf_window(const void* shadowmap, int dim,
                             const void* shadow_coord, const void* valid,
                             void* out, void* origins_out, int height,
                             int width, int tile_h, int tile_w, int threads,
                             int per_thread, int win, int pad_y, int pad_x,
                             int py_dim, int px_dim, int radius, float scale,
                             float bias, int stage_texels, void* stream) {
  if (threads % 32 != 0 || threads <= 0 || threads > kMaxThreads ||
      per_thread < 1 || per_thread > kMaxPx ||
      threads * per_thread != tile_h * tile_w || win < 1 || win > dim ||
      win > py_dim || win > px_dim || radius < 0 || stage_texels < 0 ||
      stage_texels > kStage || ((size_t)shadow_coord & 15) != 0 ||
      (long long)height * width > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int n_tx = (width + tile_w - 1) / tile_w;
  const int n_ty = (height + tile_h - 1) / tile_h;
  pcf_window_kernel<<<n_ty * n_tx, threads, 0, (cudaStream_t)stream>>>(
      (const float*)shadowmap, (const float4*)shadow_coord,
      (const unsigned char*)valid, (float*)out, (int2*)origins_out, height,
      width, tile_h, tile_w, n_tx, per_thread, dim, win, pad_y, pad_x,
      py_dim, px_dim, radius, scale, bias, stage_texels);
  return (int)cudaGetLastError();
}
