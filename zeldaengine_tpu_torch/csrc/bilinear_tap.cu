// K4 bilinear_tap: mip-0 bilinear tap of a (C, S, S) plane stack.
//
// Replaces: zeldaengine_tpu/ops/window_tap.py::_tap_kernel (entry
// sample_base_window), which serves the analytic skydome's equirect tap.
// Per pixel: repeat-wrap the uv, x0/y0 = clamp(floor(uv*S - 0.5)),
// x1 = min(x0+1, S-1) (edge clamp, as the packed atlas bakes it), lerp
// top = t00*(1-fu) + t10*fu, bot likewise, out = top*(1-fv) + bot*fv;
// inactive pixels write 0. The TPU kernel slices a window of the planes
// per pixel block and recomputes blocks that straddle the wrap seam; a
// GPU thread loads its four texels directly, so neither exists here.
//
// Bound on this card: bytes. A pixel reads 8 bytes of uv and one mask
// byte and writes 4*C bytes; the four texel loads per channel hit L2 (a
// 4-channel 512^2 stack is 4 MB). One thread per pixel, output written
// pixel-major (H, W, C) as the caller consumes it.
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256) bilinear_tap_kernel(
    const float* __restrict__ planes, int channels, int size,
    const float2* __restrict__ uv, const unsigned char* __restrict__ active,
    float* __restrict__ out, int n_pixels) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pixels) return;
  float* o = out + (size_t)i * channels;
  if (active && !active[i]) {
    for (int c = 0; c < channels; ++c) o[c] = 0.0f;
    return;
  }
  const float2 t = uv[i];
  const float size_f = (float)size;
  const float uw = t.x - floorf(t.x);
  const float vw = t.y - floorf(t.y);
  const float u = uw * size_f - 0.5f;
  const float v = vw * size_f - 0.5f;
  const int x0 = min(max((int)floorf(u), 0), size - 1);
  const int y0 = min(max((int)floorf(v), 0), size - 1);
  const float fu = fminf(fmaxf(u - (float)x0, 0.0f), 1.0f);
  const float fv = fminf(fmaxf(v - (float)y0, 0.0f), 1.0f);
  const int x1 = min(x0 + 1, size - 1);
  const int y1 = min(y0 + 1, size - 1);
  const size_t plane = (size_t)size * size;
  for (int c = 0; c < channels; ++c) {
    const float* p = planes + c * plane;
    const float t00 = p[y0 * size + x0];
    const float t10 = p[y0 * size + x1];
    const float t01 = p[y1 * size + x0];
    const float t11 = p[y1 * size + x1];
    const float top = t00 * (1.0f - fu) + t10 * fu;
    const float bot = t01 * (1.0f - fu) + t11 * fu;
    o[c] = top * (1.0f - fv) + bot * fv;
  }
}

}  // namespace

// planes (channels, size, size) f32; uv (n_pixels, 2) f32; active
// (n_pixels) bool bytes or null; out (n_pixels, channels) f32.
extern "C" int zk_bilinear_tap(const void* planes, int channels, int size,
                               const void* uv, const void* active, void* out,
                               int n_pixels, void* stream) {
  const int threads = 256;
  const int blocks = (n_pixels + threads - 1) / threads;
  bilinear_tap_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)planes, channels, size, (const float2*)uv,
      (const unsigned char*)active, (float*)out, n_pixels);
  return (int)cudaGetLastError();
}
