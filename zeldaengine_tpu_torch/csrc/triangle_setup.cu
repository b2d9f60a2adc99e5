// triangle_setup: the rasterizer's per-triangle constants in one launch.
//
// Replaces no pallas_call. The JAX package's compiled frame runs its
// ops/rasterize.py::triangle_setup (:51) as one XLA fusion, which fuses the
// adjugate's minors, the determinant, the depth-bias slope chain, the bias
// and the biased depth coefficients into fused multiply-adds. Its plain
// version (ops/rasterize.py::triangle_setup_plain) is ~90 small PyTorch
// operations; here one thread computes one triangle, all of it in
// registers, in the plain version's order so that every field is bit for
// bit: __fmaf_rn exactly where XLA fuses (the rest stays unfused under
// -fmad=false), IEEE division and reciprocal, and PyTorch's own rules
// where its reductions and clamps decide a NaN or a zero's sign (amin /
// amax: NaN wins, combined in the order of PyTorch's reduction over a row
// of 3, (v0, v2) then v1; clamp: NaN passes, then fminf(fmaxf(v, lo),
// hi); a zero zmin is +0.0).
//
// Bound by bytes: 48 B of clip rows (three 16-byte loads) and up to 2 B of
// masks in, 69 B out per triangle. The 36-byte edge and 12-byte depth rows
// are staged in shared memory and written out as the block's contiguous
// rows; the 16-byte bbox rows and the 4-byte / 1-byte fields are
// coalesced as they stand.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// The combine of torch.amin / torch.amax on the card: a NaN wins.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}
// torch.amin / amax over a row of 3: PyTorch's reduction splits the row
// over two lanes (elements 0 and 2, element 1) and combines the lanes.
__device__ __forceinline__ float amin3(const float v[3]) {
  return min_nan(min_nan(v[0], v[2]), v[1]);
}
__device__ __forceinline__ float amax3(const float v[3]) {
  return max_nan(max_nan(v[0], v[2]), v[1]);
}
// torch.clamp(v, lo, hi) with scalar bounds on the card.
__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

struct Setup {
  const float4* clip;             // (T, 3) rows of (x, y, z, w)
  const uint8_t* two_sided;       // (T,) or null: then two_sided_all
  const uint8_t* valid_mask;      // (T,) or null
  int two_sided_all;
  int n;
  float width, height;
  int has_bias;
  float slope_f, const_term;      // fp32 slope factor, const_f * 2^-23
  float* edge;                    // (T, 3, 3)
  float* zc;                      // (T, 3)
  uint8_t* valid;                 // (T,)
  float4* bbox;                   // (T,)
  float* zmin;                    // (T,)
};

__global__ void __launch_bounds__(kThreads) triangle_setup_kernel(Setup s) {
  __shared__ float s_edge[kThreads * 9];
  __shared__ float s_zc[kThreads * 3];
  const int base = blockIdx.x * kThreads;
  const int t = base + threadIdx.x;
  if (t < s.n) {
    const float4 v[3] = {s.clip[3 * t], s.clip[3 * t + 1], s.clip[3 * t + 2]};
    float xp[3], yp[3], z[3], w[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      // x_pix * w = (0.5x + 0.5w) * width
      xp[k] = (0.5f * v[k].x + 0.5f * v[k].w) * s.width;
      yp[k] = (0.5f * v[k].y + 0.5f * v[k].w) * s.height;
      z[k] = v[k].z;
      w[k] = v[k].w;
    }
    // Adjugate rows from vertices i+1 (a) and i+2 (b): each minor
    // fma(p, q, -(r * s)).
    float adj[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int a = (i + 1) % 3, b = (i + 2) % 3;
      adj[i][0] = __fmaf_rn(yp[a], w[b], -(yp[b] * w[a]));
      adj[i][1] = __fmaf_rn(xp[b], w[a], -(xp[a] * w[b]));
      adj[i][2] = __fmaf_rn(xp[a], yp[b], -(xp[b] * yp[a]));
    }
    const float det = __fmaf_rn(
        xp[2], adj[2][0], __fmaf_rn(xp[0], adj[0][0], xp[1] * adj[1][0]));

    const float sign = det >= 0.0f ? 1.0f : -1.0f;
    const bool two = s.two_sided ? s.two_sided[t] != 0 : s.two_sided_all;
    bool keep = two ? fabsf(det) > 0.0f : det < 0.0f;
    if (s.valid_mask) keep = keep && s.valid_mask[t] != 0;
    keep = keep && (w[0] > 0.0f || w[1] > 0.0f || w[2] > 0.0f);

    // Row scale: amax |adj| (a NaN makes it 1, as where(scale > 0) does).
    float m = 0.0f;
    bool nan = false;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float a = fabsf(adj[i][j]);
        nan = nan || isnan(a);
        m = a > m ? a : m;
      }
    const float scale = (!nan && m > 0.0f) ? m : 1.0f;
    const float f = __fdiv_rn(sign, scale);
    float edge[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) edge[i][j] = adj[i][j] * f;
    const float det_scaled = __fdiv_rn(det * sign, scale);
    const bool big = fabsf(det_scaled) > 1e-20f;
    const float safe_det = big ? det_scaled : 1.0f;
    const float inv_det = __fdiv_rn(1.0f, safe_det);
    float zc[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) zc[k] = z[k] * inv_det;
    keep = keep && big;

    if (s.has_bias) {
      // dz/dpx, dz/dpy = sum_i zc_i * edge[i][0 | 1] as the chain
      // fma(zc2, e2, fma(zc1, e1, zc0 * e0)).
      float g[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        g[j] = zc[0] * edge[0][j];
        g[j] = __fmaf_rn(zc[1], edge[1][j], g[j]);
        g[j] = __fmaf_rn(zc[2], edge[2][j], g[j]);
      }
      const float g0 = fabsf(g[0]), g1 = fabsf(g[1]);
      // torch.maximum: a NaN wins.
      const float slope = isnan(g0) ? g0 : (isnan(g1) ? g1
                                             : (g0 > g1 ? g0 : g1));
      const float bias = __fmaf_rn(slope, s.slope_f, s.const_term);
      const float q = __fdiv_rn(bias, safe_det);
#pragma unroll
      for (int k = 0; k < 3; ++k) zc[k] = __fmaf_rn(z[k], inv_det, q * w[k]);
    }

    // Conservative bbox and minimum depth; any w near or behind zero makes
    // the projection unbounded: the whole target, depth 0.
    const bool w_ok = w[0] > 1e-6f && w[1] > 1e-6f && w[2] > 1e-6f;
    float px[3], py[3], zw[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float ws = fabsf(w[k]) > 1e-6f ? w[k] : 1.0f;
      px[k] = __fdiv_rn(xp[k], ws);
      py[k] = __fdiv_rn(yp[k], ws);
      zw[k] = __fdiv_rn(z[k], ws);
    }
    float4 box = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (keep) {
      box.x = clamp_t(w_ok ? amin3(px) : 0.0f, 0.0f, s.width);
      box.y = clamp_t(w_ok ? amin3(py) : 0.0f, 0.0f, s.height);
      box.z = clamp_t(w_ok ? amax3(px) : s.width, 0.0f, s.width);
      box.w = clamp_t(w_ok ? amax3(py) : s.height, 0.0f, s.height);
    }
    s.bbox[t] = box;
    const float zm = clamp_t(w_ok ? amin3(zw) : 0.0f, 0.0f, 1.0f);
    s.zmin[t] = zm == 0.0f ? 0.0f : zm;  // +0.0, whatever a zero's sign
    s.valid[t] = keep ? 1 : 0;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) s_edge[threadIdx.x * 9 + i * 3 + j] = edge[i][j];
      s_zc[threadIdx.x * 3 + i] = zc[i];
    }
  }
  __syncthreads();
  const int count = min(kThreads, s.n - base);
  for (int i = threadIdx.x; i < count * 9; i += kThreads)
    s.edge[(size_t)base * 9 + i] = s_edge[i];
  for (int i = threadIdx.x; i < count * 3; i += kThreads)
    s.zc[(size_t)base * 3 + i] = s_zc[i];
}

}  // namespace

// clip: (n, 3, 4) f32, 16-byte aligned; two_sided, valid_mask: (n,) bool
// or null (two_sided then two_sided_all); has_bias: the depth bias with
// slope_f and const_term (fp32 const_f * 1.1920929e-7). Outputs as
// TriangleSetup: edge (n, 3, 3), zc (n, 3), valid (n,) bool, bbox (n, 4),
// zmin (n,), all contiguous.
extern "C" int zk_triangle_setup(const void* clip, const void* two_sided,
                                 int two_sided_all, const void* valid_mask,
                                 int n, float width, float height,
                                 int has_bias, float slope_f,
                                 float const_term, void* edge, void* zc,
                                 void* valid, void* bbox, void* zmin,
                                 void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  Setup s;
  s.clip = (const float4*)clip;
  s.two_sided = (const uint8_t*)two_sided;
  s.valid_mask = (const uint8_t*)valid_mask;
  s.two_sided_all = two_sided_all;
  s.n = n;
  s.width = width;
  s.height = height;
  s.has_bias = has_bias;
  s.slope_f = slope_f;
  s.const_term = const_term;
  s.edge = (float*)edge;
  s.zc = (float*)zc;
  s.valid = (uint8_t*)valid;
  s.bbox = (float4*)bbox;
  s.zmin = (float*)zmin;
  const int blocks = (n + kThreads - 1) / kThreads;
  triangle_setup_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(s);
  return (int)cudaGetLastError();
}
