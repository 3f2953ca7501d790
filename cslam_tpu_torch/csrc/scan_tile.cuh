// Device code shared by the bank-scan kernels K1 (bank_scan.cu) and K2
// (tile_scan.cu): a block of kThreads threads takes kQB queries and walks
// the bank in tiles of kThreads rows; thread t computes the kQB dot products
// of row t.
//
// Shared memory: qsT [D][kQB] (the block's queries, transposed, so they are
// read as float4 broadcasts), then the tile [kThreads][D+1] (row stride
// D+1: thread t reading row t is bank-conflict free), reused after the dot
// products as the similarities [kQB][kThreads].
//
// The dot products are summed over d = 0..D-1 from zero, each product and
// each sum rounded on its own (__fmul_rn / __fadd_rn; the sources are built
// with --fmad=false): the plain versions' elementwise multiply and add round
// the same way, so kernel and plain version agree bit for bit and ties are
// decided on identical values.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace scan {

constexpr int kThreads = 256;   // threads per block == rows per tile
constexpr int kQB = 32;         // queries per block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// floats of the tile buffer: the [kThreads][D+1] bank tile, reused for the
// [kQB][kThreads] similarities
__host__ __device__ __forceinline__ int tile_floats(int D) {
  return kThreads * (D + 1 > kQB ? D + 1 : kQB);
}

// (value descending, row index ascending): the lax.top_k order
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The block's queries q0 .. q0+kQB-1 (zero past B) into qsT, transposed.
__device__ __forceinline__ void load_queries(float* qsT,
                                             const float* __restrict__ queries,
                                             int q0, int B, int D, int t) {
  for (int e = t; e < D * kQB; e += kThreads) {
    const int q = e / D, d = e % D;
    qsT[d * kQB + q] = (q0 + q < B) ? queries[(size_t)(q0 + q) * D + d] : 0.f;
  }
}

// Rows [base, base + rows) of the bank into the tile, coalesced (the rows
// are contiguous); zero past `rows`.
template <typename T>
__device__ __forceinline__ void load_tile(float* tile,
                                          const T* __restrict__ bank,
                                          int base, int rows, int D, int t) {
  const int Dp = D + 1;
  const size_t off = (size_t)base * D;
  for (int e = t; e < kThreads * D; e += kThreads) {
    const int r = e / D, d = e % D;
    tile[r * Dp + d] = (r < rows) ? to_float(bank[off + e]) : 0.f;
  }
}

// acc[q] = the dot product of tile row t with query q, rounded as above.
__device__ __forceinline__ void tile_dots(float (&acc)[kQB], const float* tile,
                                          const float* qsT, int D, int t) {
#pragma unroll
  for (int q = 0; q < kQB; ++q) acc[q] = 0.f;
  const float* my_row = tile + t * (D + 1);
  const float4* q4 = reinterpret_cast<const float4*>(qsT);
  for (int d = 0; d < D; ++d) {
    const float x = my_row[d];
#pragma unroll
    for (int g = 0; g < kQB / 4; ++g) {
      const float4 qv = q4[d * (kQB / 4) + g];
      acc[4 * g + 0] = __fadd_rn(acc[4 * g + 0], __fmul_rn(qv.x, x));
      acc[4 * g + 1] = __fadd_rn(acc[4 * g + 1], __fmul_rn(qv.y, x));
      acc[4 * g + 2] = __fadd_rn(acc[4 * g + 2], __fmul_rn(qv.z, x));
      acc[4 * g + 3] = __fadd_rn(acc[4 * g + 3], __fmul_rn(qv.w, x));
    }
  }
}

}  // namespace scan
