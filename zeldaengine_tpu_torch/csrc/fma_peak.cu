// T2 fma_peak: the fused multiply-add rate probe.
//
// Replaces: tools/walk_stats.py::vpu_micro's kernel (pl.pallas_call in
// vpu_micro). C independent chains over every element of a:
//   x_c = fma(a, start_c, add)                       (c < C)
//   then n_ops - 1 times x_c = fma(x_c, mult, add)
//   out = x_0 + x_1 + ... + x_{C-1}                  (in that order)
// with start_c = f32(1 + 1e-6 c), mult = f32(1.000001), add = f32(0.3),
// rounded by the caller as the tool's weak-typed Python floats are. Every
// step is __fmaf_rn: the library is built with -fmad=false, so a written
// a * b + c would stay a multiply and an add (XLA fuses them on the CPU,
// and the tool's kernel equals the fused form bit for bit).
//
// What it measures: the card's sustained fp32 FMA rate (C * n_ops FMAs an
// element), the divisor of the strip walk's floor in
// zeldaengine_tpu_torch/tools/walk_stats.py. On the TPU one chain was a
// latency floor and C = 3-8 the throughput; here warps hide an FMA's
// latency as well as chains do, so C chiefly sets the work an element.
//
// Bound on this card: 8 bytes an element (4 read, 4 written) against
// 2 * C * n_ops flops: at n_ops 64 and the tool's 67,108,864 elements,
// bytes for C = 1 (0.160 ms against 0.128), operations for C = 3 and 8.
//
// Design: one thread per 4 consecutive elements (one 16-byte load and
// store), 4 * C independent chains a thread; the chain count is a template
// parameter, so the chains live in registers.
#include <cuda_runtime.h>

namespace {

struct FmaPeakConsts {
  float start[8];
  float mult;
  float add;
};

template <int C>
__global__ void __launch_bounds__(256) fma_peak_kernel(
    const float4* __restrict__ a, float4* __restrict__ out, long long n4,
    int n_ops, FmaPeakConsts k) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4 v = a[i];
  float x[C][4];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    x[c][0] = __fmaf_rn(v.x, k.start[c], k.add);
    x[c][1] = __fmaf_rn(v.y, k.start[c], k.add);
    x[c][2] = __fmaf_rn(v.z, k.start[c], k.add);
    x[c][3] = __fmaf_rn(v.w, k.start[c], k.add);
  }
#pragma unroll 4
  for (int s = 1; s < n_ops; ++s) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[c][e] = __fmaf_rn(x[c][e], k.mult, k.add);
    }
  }
  float4 o = make_float4(x[0][0], x[0][1], x[0][2], x[0][3]);
#pragma unroll
  for (int c = 1; c < C; ++c) {
    o.x = o.x + x[c][0];
    o.y = o.y + x[c][1];
    o.z = o.z + x[c][2];
    o.w = o.w + x[c][3];
  }
  out[i] = o;
}

template <int C>
int launch(const void* a, void* out, long long n4, int n_ops,
           FmaPeakConsts k, cudaStream_t s) {
  const int threads = 256;
  const long long blocks = (n4 + threads - 1) / threads;
  fma_peak_kernel<C><<<(unsigned)blocks, threads, 0, s>>>(
      (const float4*)a, (float4*)out, n4, n_ops, k);
  return (int)cudaGetLastError();
}

}  // namespace

// a and out: n f32 (n a multiple of 4, 16-byte aligned); chains 1, 3 or 8;
// n_ops >= 1; start (chains floats), mult, add: the rounded constants.
extern "C" int zk_fma_peak(const void* a, void* out, long long n, int chains,
                           int n_ops, const float* start, float mult,
                           float add, void* stream) {
  FmaPeakConsts k = {};
  for (int c = 0; c < chains && c < 8; ++c) k.start[c] = start[c];
  k.mult = mult;
  k.add = add;
  const long long n4 = n / 4;
  if (n4 == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (chains) {
    case 1: return launch<1>(a, out, n4, n_ops, k, s);
    case 3: return launch<3>(a, out, n4, n_ops, k, s);
    case 8: return launch<8>(a, out, n4, n_ops, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
