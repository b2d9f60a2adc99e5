// K3 pcf_taps: the (2r+1)^2-tap percentage-closer shadow filter.
//
// Replaces: zeldaengine_tpu/ops/pcf_vmem.py::_pcf_kernel (entry
// compute_pcf_vmem). ComputePCF (Common.glsl:323-342): per pixel, taps at
// texel floor(f + scale*o) for o in [-r, r]^2 with repeat addressing,
// sum of (tap < z - bias ? 0.1 : 1.0) in oy-major / ox-minor order, over
// the tap count; pixels whose shadow coordinate is out of range read 1.0.
// The TPU kernel resolves taps inside a window of the shadow map held in
// fast memory and recomputes blocks that do not fit; a GPU thread can
// load any texel directly, so there is no fit test and no fallback here.
//
// Bound on this card: bytes. A pixel reads its 16-byte shadow coordinate
// and writes 4 bytes; its 25 taps fall on a few cache lines of a 4 MB map
// that stays in L2. One thread per pixel, coordinates loaded as one
// float4, the f32 sum taken in the reference order (25 x 0.1f in f32 is
// not 2.5f, so the order is part of the result).
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int wrap(int i, int n) {
  int m = i % n;
  return m < 0 ? m + n : m;
}

__global__ void __launch_bounds__(256) pcf_taps_kernel(
    const float* __restrict__ sm, int dim_y, int dim_x,
    const float4* __restrict__ coord, float* __restrict__ out, int n_pixels,
    int radius, float scale, float bias) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pixels) return;
  const float4 c = coord[i];
  const float wd = fabsf(c.w) > 1e-20f ? c.w : 1.0f;
  const float sx = c.x / wd, sy = c.y / wd, z = c.z / wd, w_post = c.w / wd;
  const bool in_range = (z > -1.0f) && (z < 1.0f) && (w_post > 0.0f);
  const float z_cmp = z - bias;
  const float fx = sx * (float)dim_x;
  const float fy = sy * (float)dim_y;
  float total = 0.0f;
  int count = 0;
  for (int oy = -radius; oy <= radius; ++oy) {
    const int iy = wrap((int)floorf(fy + scale * (float)oy), dim_y);
    const float* row = sm + (size_t)iy * dim_x;
    for (int ox = -radius; ox <= radius; ++ox) {
      const int ix = wrap((int)floorf(fx + scale * (float)ox), dim_x);
      const bool occluded = in_range && (row[ix] < z_cmp);
      total = total + (occluded ? 0.1f : 1.0f);
      ++count;
    }
  }
  out[i] = total / (float)count;
}

}  // namespace

// shadowmap (dim_y, dim_x) f32; shadow_coord (n_pixels, 4) f32 homogeneous
// (divided by w in the kernel); out (n_pixels) f32.
extern "C" int zk_pcf_taps(const void* shadowmap, int dim_y, int dim_x,
                           const void* shadow_coord, void* out, int n_pixels,
                           int radius, float scale, float bias,
                           void* stream) {
  const int threads = 256;
  const int blocks = (n_pixels + threads - 1) / threads;
  pcf_taps_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)shadowmap, dim_y, dim_x, (const float4*)shadow_coord,
      (float*)out, n_pixels, radius, scale, bias);
  return (int)cudaGetLastError();
}
