// T1 gather_probe: the dynamic-gather probe.
//
// Replaces: tools/pallas_gather_probe.py::make_kernel (launched by its
// bench through pl.pallas_call). Over (8, 128) tiles of t (f32) and idx
// (i32),
//   axis 1 ("lane"):    out[s, l] = sum_{k<K} t[s, p_k(idx[s, l])]
//   axis 0 ("sublane"): out[s, l] = sum_{k<K} t[p_k(idx[s, l]), l]
// inside each tile, with p_k(i) = (i * (2k + 1) + k) mod D (D = 128 lanes
// or 8 rows) in 32-bit wrapping arithmetic, summed in k order from 0.0.
// The odd-multiplier scramble keeps the K index sets distinct and not
// shifts of one another, so no compiler can fold the sum into one gather
// of a summed table (the TPU probe's first version was folded so).
//
// What it measures: the rate of dynamic reads from fast on-chip memory,
// which bounds a PCF kernel that keeps its map there. The TPU kernel
// gathers across the lanes or sublanes of a vector register; here every
// gather is one shared-memory load, K an element, none reused across k.
//
// Bound on this card: bytes (t and idx read once, out written once: 12
// bytes an element) below K ~ 30; above it the K shared-memory loads an
// element. A warp's conflict-free load is one 128-byte wavefront, and a
// multiprocessor serves one wavefront a clock: K * n / 32 wavefronts over
// (SMs x SM clock).
//
// Design. One block of 8 warps a tile, each thread owning 4 elements. A
// gather issues as 3.5 instructions (see gather below), so that four warp
// schedulers issue more than one warp gather a clock, the wavefront rate.
// The layouts (the wrapper picks one by axis and K):
//   kSublane (axis 0): the tile staged as it is (4 KB, one 16-byte load
//     and store a thread, then a barrier). Warp w owns row w's columns
//     lane + 32 j: word p * 128 + col lies in bank col mod 32, so a
//     warp's 32 loads fall in 32 banks whatever p.
//   kLaneShared (axis 1, small K): warp w stages row w as it is (512 B)
//     and owns its columns 4 lane .. 4 lane + 3 (16-byte loads of idx, a
//     16-byte store of out). 32 random words of one row share banks:
//     about 3 wavefronts a warp load.
//   kLanePrivate (axis 1, from PRIVATE_MIN_K in tools/gather_probe.py):
//     bank b holds a copy of row b mod 8 (word p at word p * 32 + b, 16 KB
//     a tile), and lane L owns 4 elements of row L mod 8 (columns
//     4 (L / 8 + 4 w) .. + 3), so each thread reads only its own bank and
//     a warp load is one wavefront whatever the indices. The four copies
//     of a row cost 16 wavefronts a row to store (each thread stores its
//     4 words into the 4 banks of its row, lanes L .. L + 31 into banks
//     L + 8 i mod 32: 32 banks an instruction), where a row a warp with a
//     copy in each of the 32 banks would cost 128.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;
constexpr int kCols = 128;
constexpr int kPerLane = kCols / 32;  // elements a thread owns
constexpr int kCopies = 32 / kRows;   // kLanePrivate: copies of a row

// The layouts (the C interface's `layout`, tools/gather_probe.py LAYOUTS).
enum Layout : int { kSublane = 0, kLaneShared = 1, kLanePrivate = 2 };

// The K gathers of the N elements whose indices are id, summed in k order
// into acc; word p of element j lies at byte off + (p << S) + J * j of
// smem. p_k mod 2^F (D = 2^F ways) depends on idx mod 2^F only, and
// p_{k+1} = p_k + 2 idx + 1, so elements 2h and 2h + 1 share one running
// word r: element 2h's p_k at bits S .. S + F - 1 (address (r & M) | off,
// one LOP3), element 2h + 1's at the top F bits (address
// off + (r >> (32 - F - S)), one LEA.HI), both advanced by one add. A
// gather is then 3.5 instructions: half an IADD, a LOP3 or LEA.HI, the
// LDS and the FADD. Element 2h's carries land between the two fields and
// are cleared every 4 k, before they reach the bits that shift into the
// second address. No loaded value is kept past its add.
template <int N, int S, int F, unsigned J>
__device__ __forceinline__ void gather(const unsigned char* smem,
                                       unsigned off, const unsigned id[N],
                                       int k_ops, float acc[N]) {
  constexpr unsigned D1 = (1u << F) - 1;
  constexpr int SB = 32 - F;  // the second element's field
  constexpr unsigned M = D1 << S;
  constexpr unsigned KEEP = M | D1 << SB;
  static_assert(S + F + 3 <= SB - S, "4 carries stay below the shifted bits");
  // off as an opaque register: else nvcc rebuilds it from threadIdx.x in
  // every address (a second LOP3 a gather).
  asm("" : "+r"(off));
  unsigned r[N / 2], step[N / 2];
#pragma unroll
  for (int h = 0; h < N / 2; ++h) {
    const unsigned a = id[2 * h], b = id[2 * h + 1];
    r[h] = (a & D1) << S | b << SB;  // p_0 = idx
    step[h] = ((2u * a + 1u) & D1) << S | (2u * b + 1u) << SB;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.0f;
  auto k_step = [&]() {
#pragma unroll
    for (int h = 0; h < N / 2; ++h) {
      acc[2 * h] += *reinterpret_cast<const float*>(
          smem + (((r[h] & M) | off) + J * (2 * h)));
      acc[2 * h + 1] += *reinterpret_cast<const float*>(
          smem + ((off + (r[h] >> (SB - S))) + J * (2 * h + 1)));
      r[h] += step[h];
    }
  };
  int k = 0;
  for (; k + 4 <= k_ops; k += 4) {
    k_step();
    k_step();
    k_step();
    k_step();
#pragma unroll
    for (int h = 0; h < N / 2; ++h) r[h] &= KEEP;
  }
  for (; k < k_ops; ++k) k_step();
}

template <int L>
__global__ void __launch_bounds__(32 * kRows) gather_probe_kernel(
    const float* __restrict__ t, const int* __restrict__ idx,
    float* __restrict__ out, int k_ops) {
  __shared__ __align__(16) float buf[L == kLanePrivate ? 32 * kCols
                                                       : kRows * kCols];
  const unsigned char* smem = reinterpret_cast<const unsigned char*>(buf);
  const int w = threadIdx.x / 32;
  // The lane from %laneid: one from threadIdx.x would let ptxas fold the
  // mask of threadIdx.x % 32 into every sublane address (a second LOP3).
  int lane;
  asm("mov.u32 %0, %%laneid;" : "=r"(lane));
  const size_t tile = (size_t)blockIdx.x * kRows * kCols;
  float acc[kPerLane];
  if constexpr (L == kSublane) {
    const size_t row = tile + w * kCols;
    reinterpret_cast<float4*>(buf)[threadIdx.x] =
        reinterpret_cast<const float4*>(t + tile)[threadIdx.x];
    unsigned id[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      id[j] = (unsigned)idx[row + lane + 32 * j];
    __syncthreads();
    gather<kPerLane, 9, 3, 128u>(smem, (unsigned)lane << 2, id, k_ops, acc);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) out[row + lane + 32 * j] = acc[j];
    return;
  }
  // The lane layouts: this thread's row and float4 of it.
  const int s = L == kLaneShared ? w : lane % kRows;
  const int col4 = L == kLaneShared ? lane : lane / kRows + kCopies * w;
  const size_t at = tile + s * kCols + 4 * col4;
  const int4 iv = *reinterpret_cast<const int4*>(idx + at);
  const float4 tv = *reinterpret_cast<const float4*>(t + at);
  const unsigned id[kPerLane] = {(unsigned)iv.x, (unsigned)iv.y,
                                 (unsigned)iv.z, (unsigned)iv.w};
  if constexpr (L == kLaneShared) {
    reinterpret_cast<float4*>(buf + w * kCols)[lane] = tv;
    __syncwarp();  // a warp reads only the row it staged
    gather<kPerLane, 2, 7, 0u>(smem, (unsigned)w << 9, id, k_ops, acc);
  } else {
    const float v[kPerLane] = {tv.x, tv.y, tv.z, tv.w};
#pragma unroll
    for (int c = 0; c < kPerLane; ++c)
#pragma unroll
      for (int i = 0; i < kCopies; ++i)
        buf[(4 * col4 + c) * 32 + ((lane + kRows * i) & 31)] = v[c];
    __syncthreads();
    gather<kPerLane, 7, 7, 0u>(smem, (unsigned)lane << 2, id, k_ops, acc);
  }
  *reinterpret_cast<float4*>(out + at) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
}

}  // namespace

// t (n_tiles * 8, 128) f32, idx the same shape i32, out the same shape f32,
// each 16-byte aligned; layout 0 (sublane), 1 (lane, rows as they are) or
// 2 (lane, a copy of each row in the banks of its lanes); k_ops >= 0
// gathers an element.
extern "C" int zk_gather_probe(const void* t, const void* idx, void* out,
                               int n_tiles, int layout, int k_ops,
                               void* stream) {
  if (n_tiles <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* tf = (const float*)t;
  const int* ii = (const int*)idx;
  float* of = (float*)out;
  if (layout == kSublane) {
    gather_probe_kernel<kSublane><<<n_tiles, 32 * kRows, 0, s>>>(
        tf, ii, of, k_ops);
  } else if (layout == kLaneShared) {
    gather_probe_kernel<kLaneShared><<<n_tiles, 32 * kRows, 0, s>>>(
        tf, ii, of, k_ops);
  } else if (layout == kLanePrivate) {
    // Half of the 256 KB of L1 and shared memory as shared memory, once a
    // device: seven 16 KB blocks a multiprocessor, and L1 room for their
    // loads (the whole 228 KB ran slower at small K on the card).
    static bool ready[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && !ready[dev & 63]) {
      err = cudaFuncSetAttribute(
          gather_probe_kernel<kLanePrivate>,
          cudaFuncAttributePreferredSharedMemoryCarveout, 50);
      ready[dev & 63] = err == cudaSuccess;
    }
    if (err != cudaSuccess) return (int)err;
    gather_probe_kernel<kLanePrivate><<<n_tiles, 32 * kRows, 0, s>>>(
        tf, ii, of, k_ops);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
