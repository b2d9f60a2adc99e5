// K7 pcf_window_table and K8 pcf_window2d_table: the PCF window tables.
//
// Replaces: zeldaengine_tpu/ops/pcf_pallas.py::_window_table_kernel (entry
// build_pcf_window_table) and ::_window2d_table_kernel (entry
// build_pcf_window2d_table). Both tables are one function,
//   out[y * D_x + x][dy * 8 + dx] = sm[(y + lo_y + dy) mod D_y]
//                                      [(x + lo_x + dx) mod D_x],
// with w_y rows of 8 x taps (K7 is w_y = 1, lo_y = 0: the x-window only).
// The TPU kernels build each table row group with circular lane rolls and
// an in-kernel transpose because Mosaic has no per-lane gather.
//
// Bound on this card: bytes. The table is w_y * 8 times the map (33.5 MB
// for K7, 235 MB for K8 at D = 1024) and is written once; the map (4 MB)
// is read once.
//
// K7 (window_row_kernel): one thread block per map row segment of up to
// kSeg texels stages the segment's kSeg + 7 wrapped texels in shared
// memory once (one 32-bit remainder per block; the rest wraps with a
// short subtraction loop, which also covers D_x < 8), then writes the
// segment's table rows as two float4 each: consecutive threads write
// consecutive 16-byte groups, every thread several, with no division and
// no remainder per texel. K8 (window_table_kernel) computes each 16-byte
// group straight from the map: one thread per group, two 64-bit divisions
// and four remainders per group.
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

constexpr int kRowThreads = 256;
constexpr int kSeg = 1024;  // table rows (texels of one map row) per block

__global__ void __launch_bounds__(kRowThreads) window_row_kernel(
    const float* __restrict__ sm, int dim_x, int lo, int n_seg,
    float4* __restrict__ out) {
  __shared__ float s[kSeg + 7];
  const int y = blockIdx.x / n_seg;
  const int x0 = (blockIdx.x - y * n_seg) * kSeg;
  const int n = min(kSeg, dim_x - x0);
  const float* row = sm + (size_t)y * dim_x;
  int base = (x0 + lo) % dim_x;
  if (base < 0) base += dim_x;
  // s[i] = row[(x0 + lo + i) mod dim_x]; i < n + 7 <= dim_x + 7 when
  // dim_x >= 8 (at most two subtractions), fewer than 15 otherwise.
  for (int i = threadIdx.x; i < n + 7; i += kRowThreads) {
    int j = base + i;
    while (j >= dim_x) j -= dim_x;
    s[i] = row[j];
  }
  __syncthreads();
  float4* o = out + ((size_t)y * dim_x + x0) * 2;
#pragma unroll 4
  for (int g = threadIdx.x; g < 2 * n; g += kRowThreads) {
    const int x = (g >> 1) + (g & 1) * 4;
    o[g] = make_float4(s[x], s[x + 1], s[x + 2], s[x + 3]);
  }
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
  if (lo_y != 0 || w_y != 1 || dim_y <= 0 || dim_x <= 0) return 1;
  const int n_seg = (dim_x + kSeg - 1) / kSeg;
  const long long blocks = (long long)n_seg * dim_y;
  if (blocks > 0x7fffffffLL) return 1;
  window_row_kernel<<<(unsigned)blocks, kRowThreads, 0,
                      (cudaStream_t)stream>>>(
      (const float*)shadowmap, dim_x, lo_x, n_seg, (float4*)out);
  return (int)cudaGetLastError();
}

// shadowmap (dim_y, dim_x) f32; out (dim_y * dim_x, w_y * 8) f32.
extern "C" int zk_pcf_window2d_table(const void* shadowmap, int dim_y,
                                     int dim_x, int lo_x, int lo_y, int w_y,
                                     void* out, void* stream) {
  return launch(shadowmap, dim_y, dim_x, lo_x, lo_y, w_y, out, stream);
}
