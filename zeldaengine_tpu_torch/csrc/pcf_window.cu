// K6 pcf_window: the windowed PCF taps (pcf_backend "pallas").
//
// Replaces: zeldaengine_tpu/ops/pcf_pallas.py::_pcf_kernel (entry
// compute_pcf_pallas). Each (tile_h, tile_w) screen tile filters inside one
// (win, win) window of the wrap-padded shadow map whose origin (wy, wx)
// the wrapper computed (ops/pcf_window.py). Per pixel and tap (oy-major,
// ox-minor): row floor(fy + scale*oy) - wy and column floor(fx +
// scale*ox) - wx, each clamped to [0, win - 1]; the tap reads 0.1 where
// the pixel is in range and the depth is below z - bias, else 1.0; the
// f32 sum in tap order over the tap count. The TPU kernel fetches tap
// rows with one-hot MXU products over a bf16 hi/lo split of the window
// (depth good to ~2^-16 relative) because it has no per-lane gather; a GPU
// thread loads the exact fp32 texel, which is the function the kernel's
// contract states.
//
// Bound on this card: bytes. A pixel reads 16 bytes (fx, fy, z - bias,
// in-range) and writes 4; its 25 taps hit a few cache lines of a map of a
// few MB that stays in L2. One thread per pixel.
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256) pcf_window_kernel(
    const float* __restrict__ sm, int px_dim, const int2* __restrict__ origins,
    const float* __restrict__ fx_in, const float* __restrict__ fy_in,
    const float* __restrict__ zcmp_in, const float* __restrict__ ok_in,
    float* __restrict__ out, int height, int width, int tile_h, int tile_w,
    int win, int radius, float scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= height * width) return;
  const int y = i / width;
  const int x = i - y * width;
  const int n_tx = width / tile_w;
  const int2 o = origins[(y / tile_h) * n_tx + x / tile_w];  // (wy, wx)
  const float fx = fx_in[i], fy = fy_in[i], zc = zcmp_in[i];
  const bool ok = ok_in[i] > 0.5f;
  float total = 0.0f;
  int count = 0;
  for (int oy = -radius; oy <= radius; ++oy) {
    int ry = (int)floorf(fy + scale * (float)oy) - o.x;
    ry = min(max(ry, 0), win - 1);
    const float* row = sm + (size_t)(o.x + ry) * px_dim + o.y;
    for (int ox = -radius; ox <= radius; ++ox) {
      int cx = (int)floorf(fx + scale * (float)ox) - o.y;
      cx = min(max(cx, 0), win - 1);
      const bool occluded = ok && (row[cx] < zc);
      total = total + (occluded ? 0.1f : 1.0f);
      ++count;
    }
  }
  out[i] = total / (float)count;
}

}  // namespace

// sm_padded (py_dim, px_dim) f32; origins (height/tile_h, width/tile_w, 2)
// i32 (wy, wx); fx, fy, zcmp, inrange, out (height, width) f32.
extern "C" int zk_pcf_window(const void* sm_padded, int py_dim, int px_dim,
                             const void* origins, const void* fx,
                             const void* fy, const void* zcmp,
                             const void* inrange, void* out, int height,
                             int width, int tile_h, int tile_w, int win,
                             int radius, float scale, void* stream) {
  if (height % tile_h != 0 || width % tile_w != 0 || win > py_dim ||
      win > px_dim)
    return 1;
  const int n = height * width;
  const int threads = 256;
  pcf_window_kernel<<<(n + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(
      (const float*)sm_padded, px_dim, (const int2*)origins,
      (const float*)fx, (const float*)fy, (const float*)zcmp,
      (const float*)inrange, (float*)out, height, width, tile_h, tile_w, win,
      radius, scale);
  return (int)cudaGetLastError();
}
