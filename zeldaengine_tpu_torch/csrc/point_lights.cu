// K5 point_lights: tile-culled point lighting onto the directional sum.
//
// Replaces: zeldaengine_tpu/ops/lighting_pallas.py::_point_kernel (entry
// point_lighting_pallas). For every pixel of a (block_h, 128) block, walk
// that block's culled light list (tile_idx[by][bx][0 .. tile_cnt)) in
// ascending order and add rad * lc * (dc * kd + fr), the default_lit_bxdf
// x apply_point_light chain (Common.glsl:259-282, :399-416), onto the
// partial sum the caller passes in. Slots at or past the count are never
// read. The arithmetic is the TPU kernel's, operation for operation:
// pow(x, 5) as ((x*x)*(x*x))*x, true divisions and IEEE sqrtf (no fast
// math), roughness-only terms hoisted, 1/1.51 computed in double and
// rounded once to fp32. Built with -fmad=false, it equals the plain
// version (ops/lighting_cuda.py::point_lighting_plain) bit for bit.
//
// Bound on this card: bytes. A pixel reads 5 x 12 + 2 x 4 bytes and writes
// 12; each (pixel, light) pair costs ~115 fp32 operations, and the cull
// leaves a few lights per block. One CTA of 128 threads is one row of
// one block, so every warp walks the same list (no divergence) and the
// light parameters are warp-uniform loads that hit L1.
#include <cuda_runtime.h>

namespace {

constexpr int kBlockW = 128;
constexpr float kF0 = 0.04f;
constexpr float kF90 = 1.0f;  // saturate(50 * F0)
constexpr float kPi = 3.14159265359f;
constexpr float kEScale = static_cast<float>(1.0 / 1.51);

__device__ __forceinline__ float sat(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x2 * x2 * x;
}

__global__ void __launch_bounds__(kBlockW) point_lights_kernel(
    const float* __restrict__ acc, const float* __restrict__ dc,
    const float* __restrict__ nrm, const float* __restrict__ pos,
    const float* __restrict__ view, const float* __restrict__ rough_in,
    const float* __restrict__ ndotv_in, const float* __restrict__ lt,
    const int* __restrict__ tile_idx, const int* __restrict__ tile_cnt,
    int k_max, int width, int block_h, float* __restrict__ out) {
  const int bx = blockIdx.x;
  const int y = blockIdx.y;
  const int x = bx * kBlockW + threadIdx.x;
  const size_t i = (size_t)y * width + x;
  const size_t i3 = 3 * i;
  const int tile = (y / block_h) * gridDim.x + bx;
  const int cnt = tile_cnt[tile];
  const int* list = tile_idx + (size_t)tile * k_max;

  const float n0 = nrm[i3], n1 = nrm[i3 + 1], n2 = nrm[i3 + 2];
  const float p0 = pos[i3], p1 = pos[i3 + 1], p2 = pos[i3 + 2];
  const float v0 = view[i3], v1 = view[i3 + 1], v2 = view[i3 + 2];
  const float dc0 = dc[i3], dc1 = dc[i3 + 1], dc2 = dc[i3 + 2];
  float a0 = acc[i3], a1 = acc[i3 + 1], a2acc = acc[i3 + 2];
  const float rough = rough_in[i];
  const float ndotv = ndotv_in[i];

  const float a2 = rough * rough;
  const float one_m_a2 = 1.0f - a2;
  const float e_bias = 0.5f * rough;
  const float e_factor = (1.0f - rough) + kEScale * rough;
  const float f_span = kF90 - kF0;
  const float pow5_nv = pow5(1.0f - ndotv);

  for (int k = 0; k < cnt; ++k) {
    const float* l = lt + 16 * (size_t)list[k];
    const float t0 = l[0] - p0;
    const float t1 = l[1] - p1;
    const float t2 = l[2] - p2;
    const float d2 = t0 * t0 + t1 * t1 + t2 * t2;
    const float dist = sqrtf(fmaxf(d2, 1e-20f));
    const float l0 = t0 / dist;
    const float l1 = t1 / dist;
    const float l2 = t2 / dist;
    float h0 = v0 + l0;
    float h1 = v1 + l1;
    float h2 = v2 + l2;
    const float hn = sqrtf(fmaxf(h0 * h0 + h1 * h1 + h2 * h2, 1e-20f));
    h0 = h0 / hn;
    h1 = h1 / hn;
    h2 = h2 / hn;
    const float ldoth = sat(l0 * h0 + l1 * h1 + l2 * h2);
    const float ndoth = sat(n0 * h0 + n1 * h1 + n2 * h2);
    const float ndotl = sat(n0 * l0 + n1 * l1 + n2 * l2);

    const float f = kF0 + f_span * pow5(1.0f - ldoth);
    const float ggxv = ndotl * sqrtf(ndotv * ndotv * one_m_a2 + a2);
    const float ggxl = ndotv * sqrtf(ndotl * ndotl * one_m_a2 + a2);
    const float ggx = ggxv + ggxl;
    const float vis = ggx > 0.0f ? 0.5f / ggx : 0.0f;
    const float fd_ggx = (ndoth * a2 - ndoth) * ndoth + 1.0f;
    const float d_ndf = a2 / (kPi * fd_ggx * fd_ggx);
    const float fr = f * d_ndf * vis;
    const float fd90 = e_bias + 2.0f * ldoth * ldoth * rough;
    const float light_scatter = 1.0f + (fd90 - 1.0f) * pow5(1.0f - ndotl);
    const float view_scatter = 1.0f + (fd90 - 1.0f) * pow5_nv;
    const float fd = light_scatter * view_scatter * e_factor;
    const float kd = (1.0f - f) * fd;

    const float att = 1.0f - sat(dist / fmaxf(l[11], 1e-6f));
    const float rad = ndotl * l[7] * att;
    a0 = a0 + rad * l[4] * (dc0 * kd + fr);
    a1 = a1 + rad * l[5] * (dc1 * kd + fr);
    a2acc = a2acc + rad * l[6] * (dc2 * kd + fr);
  }
  out[i3] = a0;
  out[i3 + 1] = a1;
  out[i3 + 2] = a2acc;
}

}  // namespace

// acc, diffuse_color, n, p, v (height, width, 3) f32; roughness, ndotv
// (height, width) f32; lights (L, 16) f32; tile_idx (n_by, n_bx, k_max)
// i32 with entries < L; tile_cnt (n_by, n_bx) i32 with n_by = ceil(height /
// block_h), n_bx = width / 128; out (height, width, 3) f32.
extern "C" int zk_point_lights(const void* acc, const void* diffuse_color,
                               const void* n, const void* p, const void* v,
                               const void* roughness, const void* ndotv,
                               const void* lights, const void* tile_idx,
                               const void* tile_cnt, int k_max, int height, int width, int block_h,
                               void* out, void* stream) {
  if (width % kBlockW != 0 || height <= 0 || block_h <= 0) return 1;
  const dim3 grid(width / kBlockW, height);
  point_lights_kernel<<<grid, kBlockW, 0, (cudaStream_t)stream>>>(
      (const float*)acc, (const float*)diffuse_color, (const float*)n,
      (const float*)p, (const float*)v, (const float*)roughness,
      (const float*)ndotv, (const float*)lights, (const int*)tile_idx,
      (const int*)tile_cnt, k_max, width, block_h, (float*)out);
  return (int)cudaGetLastError();
}
