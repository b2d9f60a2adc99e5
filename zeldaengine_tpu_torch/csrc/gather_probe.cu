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
// gathers across the lanes or sublanes of a vector register; here the
// gathers are shared-memory loads.
//
// Bound on this card: bytes (t and idx read once, out written once: 12
// bytes an element) below K ~ 64; the K shared-memory loads an element
// above it (32 banks of 4 bytes a clock on each multiprocessor).
//
// Design: one block of 256 threads (8 warps) a tile. Warp w stages row w
// of the tile's t in shared memory (4 KB a tile) with four coalesced
// 128-byte loads and keeps the idx words of its lanes' four columns
// (lane + 32 j) in registers; after one barrier every gather is one
// shared-memory load. A sublane gather of lane l reads word p * 128 + l,
// in bank l mod 32: a warp's 32 loads fall in 32 banks, conflict-free. A
// lane gather reads random words of the warp's 512-byte row, which share
// banks: the probe shows what those conflicts cost.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;
constexpr int kCols = 128;
constexpr int kPerLane = kCols / 32;

template <int D>
__global__ void __launch_bounds__(256) gather_probe_kernel(
    const float* __restrict__ t, const int* __restrict__ idx,
    float* __restrict__ out, int k_ops) {
  __shared__ float tile[kRows * kCols];
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t row = (size_t)blockIdx.x * (kRows * kCols) + w * kCols;
  unsigned id[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    tile[w * kCols + lane + 32 * j] = t[row + lane + 32 * j];
    id[j] = (unsigned)idx[row + lane + 32 * j];
  }
  __syncthreads();
  float acc[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) acc[j] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < k_ops; ++k) {
    const unsigned mul = 2u * (unsigned)k + 1u;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const unsigned p = (id[j] * mul + (unsigned)k) & (unsigned)(D - 1);
      acc[j] += D == kCols ? tile[w * kCols + p]
                           : tile[p * kCols + lane + 32 * j];
    }
  }
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) out[row + lane + 32 * j] = acc[j];
}

}  // namespace

// t (n_tiles * 8, 128) f32, idx the same shape i32, out the same shape f32;
// axis 1 (lane) or 0 (sublane); k_ops >= 0 gathers an element.
extern "C" int zk_gather_probe(const void* t, const void* idx, void* out,
                               int n_tiles, int axis, int k_ops,
                               void* stream) {
  if (n_tiles <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (axis == 1) {
    gather_probe_kernel<kCols><<<n_tiles, 256, 0, s>>>(
        (const float*)t, (const int*)idx, (float*)out, k_ops);
  } else {
    gather_probe_kernel<kRows><<<n_tiles, 256, 0, s>>>(
        (const float*)t, (const int*)idx, (float*)out, k_ops);
  }
  return (int)cudaGetLastError();
}
