// fma: fp32 a * b + c with one rounding, elementwise over a broadcast shape.
//
// Replaces no pallas_call. The JAX package's compiled frame (on the CPU,
// where its goldens were rendered) gets fused multiply-adds from XLA's
// fusion of the vertex transforms (math/transforms.py::apply_mat4_*) and
// of triangle_setup (ops/rasterize.py: the adjugate's minors, the
// determinant, the depth-bias slope chain of :127, the bias and the biased
// depth coefficients). The port writes each of them as
// math/transforms.py::fma_f32; on the card this kernel computes one in a
// single launch with __fmaf_rn, which -fmad=false leaves alone. Its plain
// version (fma_f32_plain) needs about twenty fp64 operations.
//
// Each operand is a strided view of the output shape (stride 0 along a
// broadcast axis, as torch.broadcast_tensors gives it) or, given a null
// pointer, a scalar. The output is contiguous. Bound by bytes: a few
// hundred thousand elements a call, launch latency dominates.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDims = 6;

struct Layout {
  long long shape[kMaxDims];
  long long stride[3][kMaxDims];  // a, b, c
  int ndim;
};

__global__ void __launch_bounds__(256) fma_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ c, float va, float vb, float vc,
    float* __restrict__ out, long long n, Layout lay) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    long long rem = i, ia = 0, ib = 0, ic = 0;
    for (int d = lay.ndim - 1; d >= 0; --d) {
      const long long k = rem % lay.shape[d];
      rem /= lay.shape[d];
      ia += k * lay.stride[0][d];
      ib += k * lay.stride[1][d];
      ic += k * lay.stride[2][d];
    }
    const float x = a ? a[ia] : va;
    const float y = b ? b[ib] : vb;
    const float z = c ? c[ic] : vc;
    out[i] = __fmaf_rn(x, y, z);
  }
}

}  // namespace

// a, b, c: f32 pointers or null (then va, vb, vc); out: n f32, contiguous.
// meta (host): ndim shape entries, then ndim strides (in elements) of a,
// of b and of c.
extern "C" int zk_fma(const void* a, const void* b, const void* c, float va,
                      float vb, float vc, void* out, long long n, int ndim,
                      const long long* meta, void* stream) {
  if (ndim < 0 || ndim > kMaxDims) return (int)cudaErrorInvalidValue;
  Layout lay{};
  lay.ndim = ndim;
  for (int d = 0; d < ndim; ++d) {
    lay.shape[d] = meta[d];
    for (int k = 0; k < 3; ++k) lay.stride[k][d] = meta[(k + 1) * ndim + d];
  }
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  fma_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)c, va, vb, vc,
      (float*)out, n, lay);
  return (int)cudaGetLastError();
}
