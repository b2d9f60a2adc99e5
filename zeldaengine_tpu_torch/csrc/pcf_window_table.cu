// K7 pcf_window_table and K8 pcf_window2d_table: the PCF window tables.
//
// Replaces: zeldaengine_tpu/ops/pcf_pallas.py::_window_table_kernel (entry
// build_pcf_window_table) and ::_window2d_table_kernel (entry
// build_pcf_window2d_table). Both tables are one function,
//   out[y * D_x + x][dy * 8 + dx] = sm[(y + lo_y + dy) mod D_y]
//                                      [(x + lo_x + dx) mod D_x],
// with w_y rows of 8 x taps (K7 is w_y = 1, lo_y = 0: the x-window only).
// The TPU kernel builds each table row group with circular lane rolls and
// an in-kernel transpose because Mosaic has no per-lane gather; a GPU
// thread can load any texel, so each thread here writes one 16-byte group
// (4 consecutive x taps of one dy) straight from the map.
//
// Bound on this card: bytes. The table is w_y * 8 times the map (33.5 MB
// for K7, 235 MB for K8 at D = 1024) and is written once; the map (4 MB)
// is read from L2. Consecutive threads write consecutive 16-byte groups,
// so every store is a full coalesced line.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int wrap(int i, int n) {
  int m = i % n;
  return m < 0 ? m + n : m;
}

__global__ void __launch_bounds__(256) window_table_kernel(
    const float* __restrict__ sm, int dim_y, int dim_x, int lo_x, int lo_y,
    int w_y, float4* __restrict__ out, long long n_groups) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_groups) return;
  const int groups_per_row = 2 * w_y;  // w_y * 8 channels / 4
  const long long texel = g / groups_per_row;
  const int r = (int)(g - texel * groups_per_row);
  const int dy = r >> 1;
  const int dx0 = (r & 1) * 4;
  const int y = (int)(texel / dim_x);
  const int x = (int)(texel - (long long)y * dim_x);
  const float* row = sm + (size_t)wrap(y + lo_y + dy, dim_y) * dim_x;
  float4 v;
  v.x = row[wrap(x + lo_x + dx0, dim_x)];
  v.y = row[wrap(x + lo_x + dx0 + 1, dim_x)];
  v.z = row[wrap(x + lo_x + dx0 + 2, dim_x)];
  v.w = row[wrap(x + lo_x + dx0 + 3, dim_x)];
  out[g] = v;
}

int launch(const void* shadowmap, int dim_y, int dim_x, int lo_x, int lo_y,
           int w_y, void* out, void* stream) {
  if (dim_y <= 0 || dim_x <= 0 || w_y <= 0) return 1;
  const long long n_groups = (long long)dim_y * dim_x * 2 * w_y;
  const int threads = 256;
  const long long blocks = (n_groups + threads - 1) / threads;
  window_table_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)shadowmap, dim_y, dim_x, lo_x, lo_y, w_y, (float4*)out,
      n_groups);
  return (int)cudaGetLastError();
}

}  // namespace

// shadowmap (dim_y, dim_x) f32; out (dim_y * dim_x, 8) f32. lo_y and w_y
// are 0 and 1 (the arguments keep one signature for both tables).
extern "C" int zk_pcf_window_table(const void* shadowmap, int dim_y,
                                   int dim_x, int lo_x, int lo_y, int w_y,
                                   void* out, void* stream) {
  if (lo_y != 0 || w_y != 1) return 1;
  return launch(shadowmap, dim_y, dim_x, lo_x, 0, 1, out, stream);
}

// shadowmap (dim_y, dim_x) f32; out (dim_y * dim_x, w_y * 8) f32.
extern "C" int zk_pcf_window2d_table(const void* shadowmap, int dim_y,
                                     int dim_x, int lo_x, int lo_y, int w_y,
                                     void* out, void* stream) {
  return launch(shadowmap, dim_y, dim_x, lo_x, lo_y, w_y, out, stream);
}
