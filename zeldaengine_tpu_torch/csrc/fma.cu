// fma: fp32 a * b + c with one rounding, elementwise over a broadcast shape.
//
// Replaces no pallas_call. The JAX package's compiled frame (on the CPU,
// where its goldens were rendered) gets fused multiply-adds from XLA's
// fusion of the vertex transforms (math/transforms.py::apply_mat4_*), of
// the view matrices and of the meshlet culls' sums; the port writes each
// as math/transforms.py::fma_f32, and on the card this kernel computes one
// in a single launch with __fmaf_rn, which -fmad=false leaves alone. (The
// setup's own multiply-adds are kernel triangle_setup's.)
//
// Bound by bytes. The host collapses the broadcast layout first (size-1
// dimensions dropped, neighbours whose strides chain for every operand
// merged) to at most 3 dimensions, so all index math is 32-bit, and the
// divisions by the inner sizes are multiply-shifts with constants made on
// the host. Each operand is a value (a Python number), flat (laid out as
// the contiguous output: 16-byte loads when aligned) or strided; the three
// modes are template arguments, so a launch carries no branch or index
// math that its layout does not need. A thread computes 4 neighbouring
// outputs and stores them as one 16-byte store; a grid of the
// multiprocessors' resident blocks walks the output.
#include <array>
#include <utility>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kValue = 0, kFlat = 1, kStrided = 2;

// n / d for n < 2^31 as (umulhi(n, mul) >> shr); d == 1 has mul 0.
struct FastDiv {
  unsigned mul, shr;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return mul ? __umulhi(n, mul) >> shr : n;
  }
};

struct Layout {
  const float* p[3];   // a, b, c (null: value)
  float v[3];
  int aligned[3];      // flat and 16-byte aligned
  int stride[3][3];    // [operand][dim], in elements
  int size1, size2;    // dims 1 and 2 (dim 0 follows)
  FastDiv div1, div2;
  int n;
};

// Operand k's 4 values at outputs i .. i + 3 (0 past the end).
template <int M>
__device__ __forceinline__ void load4(const Layout& l, int k, int i,
                                      bool whole, const int (&off)[4],
                                      float (&x)[4]) {
  if (M == kValue) {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = l.v[k];
  } else if (M == kFlat && whole && l.aligned[k]) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(l.p[k] + i));
    x[0] = f.x;
    x[1] = f.y;
    x[2] = f.z;
    x[3] = f.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = i + e < l.n ? __ldg(l.p[k] + (M == kFlat ? i + e : off[e]))
                         : 0.0f;
  }
}

template <int MA, int MB, int MC>
__global__ void __launch_bounds__(kThreads) fma_kernel(Layout l,
                                                       float* __restrict__ out) {
  const int step = gridDim.x * kThreads * 4;
  for (int i = (blockIdx.x * kThreads + threadIdx.x) * 4; i < l.n; i += step) {
    const bool whole = i + 4 <= l.n;
    int off[3][4] = {};
    if (MA == kStrided || MB == kStrided || MC == kStrided) {
      const unsigned q = l.div2.div((unsigned)i);
      int c2 = i - (int)q * l.size2;
      int c0 = (int)l.div1.div(q);
      int c1 = (int)q - c0 * l.size1;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (MA == kStrided)
          off[0][e] = c0 * l.stride[0][0] + c1 * l.stride[0][1] +
                      c2 * l.stride[0][2];
        if (MB == kStrided)
          off[1][e] = c0 * l.stride[1][0] + c1 * l.stride[1][1] +
                      c2 * l.stride[1][2];
        if (MC == kStrided)
          off[2][e] = c0 * l.stride[2][0] + c1 * l.stride[2][1] +
                      c2 * l.stride[2][2];
        if (++c2 == l.size2) {
          c2 = 0;
          if (++c1 == l.size1) {
            c1 = 0;
            ++c0;
          }
        }
      }
    }
    float x[4], y[4], z[4], r[4];
    load4<MA>(l, 0, i, whole, off[0], x);
    load4<MB>(l, 1, i, whole, off[1], y);
    load4<MC>(l, 2, i, whole, off[2], z);
#pragma unroll
    for (int e = 0; e < 4; ++e) r[e] = __fmaf_rn(x[e], y[e], z[e]);
    if (whole) {
      *reinterpret_cast<float4*>(out + i) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
      for (int e = 0; i + e < l.n; ++e) out[i + e] = r[e];
    }
  }
}

using KernelFn = void (*)(Layout, float*);

// The 27 instances, indexed by mode(a) * 9 + mode(b) * 3 + mode(c).
template <int I>
KernelFn kernel_at() {
  return &fma_kernel<I / 9, I / 3 % 3, I % 3>;
}

template <int... I>
std::array<KernelFn, 27> make_table(std::integer_sequence<int, I...>) {
  return {{kernel_at<I>()...}};
}

// Blocks of instance `which` resident on the card at once
// (multiprocessors x blocks each), read once per device.
int grid_cap(KernelFn fn, int which) {
  static int cap[64][27] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cap[dev][which] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
    cap[dev][which] = (sms > 0 ? sms : 132) * (per_sm > 0 ? per_sm : 1);
  }
  return cap[dev][which];
}

}  // namespace

// a, b, c: f32 pointers or null (then va, vb, vc); out: n f32, contiguous
// (16-byte aligned). meta (host), 18 ints: size1, size2, mul1, shr1, mul2,
// shr2 (the multiply-shift of size1 and of size2), the mode of a, b and c
// (0 value, 1 flat, 2 strided), then the 3 strides (dims 0, 1, 2) of a, of
// b and of c. mul is passed as its int bits.
extern "C" int zk_fma(const void* a, const void* b, const void* c, float va,
                      float vb, float vc, void* out, int n, const int* meta,
                      void* stream) {
  static const std::array<KernelFn, 27> kernels =
      make_table(std::make_integer_sequence<int, 27>{});
  if (n <= 0 || ((size_t)out & 15) != 0) return (int)cudaErrorInvalidValue;
  Layout l;
  const void* ptr[3] = {a, b, c};
  const float val[3] = {va, vb, vc};
  l.size1 = meta[0];
  l.size2 = meta[1];
  l.div1 = FastDiv{(unsigned)meta[2], (unsigned)meta[3]};
  l.div2 = FastDiv{(unsigned)meta[4], (unsigned)meta[5]};
  int which = 0;
  for (int k = 0; k < 3; ++k) {
    const int mode = meta[6 + k];
    if (mode < kValue || mode > kStrided ||
        (mode == kValue) != (ptr[k] == nullptr))
      return (int)cudaErrorInvalidValue;
    which = which * 3 + mode;
    l.p[k] = (const float*)ptr[k];
    l.v[k] = val[k];
    l.aligned[k] = mode == kFlat && ((size_t)ptr[k] & 15) == 0;
    for (int d = 0; d < 3; ++d) l.stride[k][d] = meta[9 + 3 * k + d];
  }
  l.n = n;
  const KernelFn fn = kernels[which];
  long long blocks = ((long long)n + 4LL * kThreads - 1) / (4LL * kThreads);
  const int cap = grid_cap(fn, which);
  if (blocks > cap) blocks = cap;
  fn<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(l, (float*)out);
  return (int)cudaGetLastError();
}
