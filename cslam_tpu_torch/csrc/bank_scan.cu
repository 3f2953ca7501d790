// Exact cosine top-k bank scan for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel cslam_tpu/ops/nns_pallas.py::_scan_kernel2
// (launched by _fused2_pre_one behind cosine_topk_fused2_pre). It computes
// what that kernel's contract promises, not its TPU block structure:
//
//   for each query b: the k largest dot products q_b . bank_r over the first
//   n bank rows, ordered by (value descending, row index ascending), k <= 128.
//
// The caller (cslam_tpu_torch/ops/nns.py) rounds the queries to bf16 for a
// bf16 bank, scales the output by 1/max(||q||, 1e-12) and pads n < k.
//
// Design (simple and exact by construction; speed is later work):
//   * Kernel 1, grid (bank split s, query block of QB=32 queries), 256
//     threads. The block walks its split in tiles of 256 rows; thread t
//     computes the 32 dot products of row t with the block's queries on the
//     FP32 cores, rounded as the plain version rounds them (scan_tile.cuh,
//     shared with K2), so kernel and plain version agree bit for bit and the
//     tie order is decided on identical values.
//   * Each query keeps an exact sorted top-k list in shared memory. After a
//     tile, one warp per query filters the tile's 256 values against the
//     list's k-th value and inserts the survivors one by one (warp-parallel
//     shift). After the first tiles almost nothing survives the filter.
//   * Kernel 2 merges the per-split lists of each query (one warp per query,
//     one split per lane) under the same order and pads missing slots.
//   The TPU kernel's dropped-value bound F and whole-batch fallback are not
//   needed: nothing is ever dropped.
//
// What bounds it on an H100 SXM: at the main-path shape (n = 100000 rows,
// D = 64, B = 512) the work is 2*512*100000*64 = 6.55 GFLOP against 25.6 MB
// of valid f32 bank rows; at 67 TFLOP/s (FP32, non-tensor) and 3.35 TB/s the
// floor is 0.098 ms of arithmetic vs 0.008 ms of memory, so the FP32 rate
// bounds it. Unfused multiply and add halve the attainable FP32 rate (the
// price of bit-exact agreement with the plain version).
#include <math_constants.h>
#include <climits>

#include "scan_tile.cuh"

namespace {

using namespace scan;

// Insert candidate (cv, ci) into the sorted list (lv, li) of length *len
// (capacity k). Called by all 32 lanes of one warp.
__device__ void warp_insert(float* lv, int* li, int* len, int k,
                            float cv, int ci, int lane) {
  const int L = *len;
  int pos = 0;
  for (int j0 = 0; j0 < L; j0 += 32) {
    const int j = j0 + lane;
    const bool b = j < L && better(lv[j], li[j], cv, ci);
    pos += __popc(__ballot_sync(kFull, b));
  }
  if (pos >= k) return;  // uniform across the warp
  const int newL = min(L + 1, k);
  // shift [pos, newL - 1) up by one slot, highest chunk first
  for (int j0 = newL - 2; j0 >= pos; j0 -= 32) {
    const int j = j0 - lane;
    const bool act = j >= pos;
    float tv = 0.f;
    int ti = 0;
    if (act) { tv = lv[j]; ti = li[j]; }
    __syncwarp();
    if (act) { lv[j + 1] = tv; li[j + 1] = ti; }
    __syncwarp();
  }
  if (lane == 0) { lv[pos] = cv; li[pos] = ci; *len = newL; }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ bank, int n, int D,
            const float* __restrict__ queries, int B, int k, int split_rows,
            float* __restrict__ part_v, int* __restrict__ part_i) {
  extern __shared__ __align__(16) float smem[];
  float* qsT = smem;                           // [D][kQB] queries, transposed
  float* tile = qsT + D * kQB;                 // [kThreads][D+1]; reused as sims [kQB][kThreads]
  float* lv = tile + tile_floats(D);           // [kQB][k]
  int* li = reinterpret_cast<int*>(lv + kQB * k);  // [kQB][k]
  int* llen = li + kQB * k;                    // [kQB]

  const int s = blockIdx.x;
  const int q0 = blockIdx.y * kQB;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int row_begin = s * split_rows;
  const int row_end = min(n, row_begin + split_rows);

  load_queries(qsT, queries, q0, B, D, t);
  if (t < kQB) llen[t] = 0;
  __syncthreads();

  for (int base = row_begin; base < row_end; base += kThreads) {
    const int rows = min(kThreads, row_end - base);
    load_tile(tile, bank, base, rows, D, t);
    __syncthreads();

    float acc[kQB];
    tile_dots(acc, tile, qsT, D, t);
    __syncthreads();  // every thread is done reading the tile
    float* sims = tile;
#pragma unroll
    for (int q = 0; q < kQB; ++q) sims[q * kThreads + t] = acc[q];
    __syncthreads();

    for (int q = warp; q < kQB; q += kWarps) {
      if (q0 + q >= B) continue;
      float* qlv = lv + q * k;
      int* qli = li + q * k;
      for (int c = 0; c < kThreads / 32; ++c) {
        const int r = c * 32 + lane;
        const float v = sims[q * kThreads + r];
        const int L = llen[q];
        const bool pass = r < rows && (L < k || v > qlv[k - 1]);
        unsigned mask = __ballot_sync(kFull, pass);
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const float cv = __shfl_sync(kFull, v, src);
          warp_insert(qlv, qli, &llen[q], k, cv, base + c * 32 + src, lane);
        }
      }
    }
    __syncthreads();  // lists settled, tile buffer free for the next load
  }

  for (int q = warp; q < kQB; q += kWarps) {
    if (q0 + q >= B) continue;
    const int L = llen[q];
    const size_t o = ((size_t)s * B + q0 + q) * k;
    for (int j = lane; j < k; j += 32) {
      part_v[o + j] = j < L ? lv[q * k + j] : -CUDART_INF_F;
      part_i[o + j] = j < L ? li[q * k + j] : INT_MAX;
    }
  }
}

// One warp per query: merge the S per-split lists (one per lane, S <= 32).
__global__ void merge_kernel(const float* __restrict__ part_v,
                             const int* __restrict__ part_i, int S, int B,
                             int k, int n, float* __restrict__ out_v,
                             int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warps exit together
  int head = 0;
  float cv = -CUDART_INF_F;
  int ci = INT_MAX;
  if (lane < S) {
    cv = part_v[((size_t)lane * B + b) * k];
    ci = part_i[((size_t)lane * B + b) * k];
  }
  int m = k;  // number of real entries emitted
  for (int j = 0; j < k; ++j) {
    float bv = cv;
    int bi = ci;
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (bi == INT_MAX) { m = j; break; }  // every list is exhausted
    if (lane == 0) {
      out_v[(size_t)b * k + j] = bv;
      out_i[(size_t)b * k + j] = bi;
    }
    if (lane < S && ci == bi) {
      ++head;
      const size_t o = ((size_t)lane * B + b) * k + head;
      cv = head < k ? part_v[o] : -CUDART_INF_F;
      ci = head < k ? part_i[o] : INT_MAX;
    }
  }
  // fewer than k valid rows: -inf with the lowest invalid indices n, n+1, ...
  for (int j = m + lane; j < k; j += 32) {
    out_v[(size_t)b * k + j] = -CUDART_INF_F;
    out_i[(size_t)b * k + j] = n + (j - m);
  }
}

template <typename T>
int launch(const T* bank, int n, int D, const float* queries, int B, int k,
           int split_rows, int S, float* part_v, int* part_i, float* out_v,
           int* out_i, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)D * kQB
                                       + (size_t)tile_floats(D)
                                       + (size_t)kQB * k)
                      + sizeof(int) * ((size_t)kQB * k + kQB);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(S, (B + kQB - 1) / kQB);
  scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      bank, n, D, queries, B, k, split_rows, part_v, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps_per_block = 8;
  merge_kernel<<<(B + warps_per_block - 1) / warps_per_block,
                 32 * warps_per_block, 0, stream>>>(
      part_v, part_i, S, B, k, n, out_v, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bank: [>= n, D] row-major, float32 (bank_bf16 == 0) or bfloat16.
// queries: [B, D] float32. part_v / part_i: [S, B, k] scratch.
// out_v / out_i: [B, k]. Returns cudaGetLastError() after the launches.
int cslam_bank_scan(const void* bank, int bank_bf16, int n, int D,
                    const float* queries, int B, int k, int split_rows, int S,
                    float* part_v, int* part_i, float* out_v, int* out_i,
                    void* stream) {
  if (S < 1 || S > 32 || k < 1 || k > 128 || D < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bank_bf16)
    return launch(static_cast<const __nv_bfloat16*>(bank), n, D, queries, B,
                  k, split_rows, S, part_v, part_i, out_v, out_i, st);
  return launch(static_cast<const float*>(bank), n, D, queries, B, k,
                split_rows, S, part_v, part_i, out_v, out_i, st);
}

}  // extern "C"
