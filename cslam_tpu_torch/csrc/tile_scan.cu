// Exact cosine top-k (k <= 10) over a bank with inverse row norms, for
// Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel cslam_tpu/ops/nns_pallas.py::_scan_kernel
// (launched by cosine_topk_fused). It computes that kernel's contract, not
// its 4096-row tile structure:
//
//   sim[b][r] = (sum over d = 0..D-1 of q[b][d] * bank[r][d]) * inv_norms[r]
//   for the first n rows; the k largest per query, ordered by (value
//   descending, row index ascending), k <= 10. With fewer than k valid rows
//   the trailing slots hold (-inf, row 0): the TPU kernel's argmax over an
//   all -inf tile returns its first column.
//
// The caller (cslam_tpu_torch/ops/nns.py) scales the result by
// 1/max(||q||, 1e-12). A bf16 bank is read as bf16 and widened; queries stay
// float32.
//
// Design (simple and exact; speed is later work):
//   * scan_kernel, grid (bank split s, query block of kQB = 32 queries), 256
//     threads. The block walks its split in tiles of 256 rows; thread t
//     computes the 32 dot products of row t as K1 does (scan_tile.cuh), then
//     multiplies each by inv_norms[row] (__fmul_rn). The plain version rounds
//     the same way, so the two agree bit for bit and ties are decided on
//     identical values.
//   * A query's running top-k lives in registers, one entry per lane of the
//     warp that owns the query (lane j holds entry j; empty entries are
//     (-inf, INT_MAX)). After each tile the warp tests 32 similarities at a
//     time against the k-th entry; the few that beat it are inserted by a
//     ballot (position) and a shuffle (shift).
//   * merge_kernel, one warp per query, runs the same insertion over the S
//     per-split lists and writes k results, empty entries as (-inf, 0).
//
// What bounds it on an H100 SXM: at B = 512, n = 100000, D = 64 the work is
// 6.6 GFLOP against 26 MB of f32 rows and norms, so the FP32 rate (67
// TFLOP/s, 0.098 ms) bounds it, and unfused multiply-add halves that rate.
// At B = 1 the 26 MB read bounds it (0.008 ms at 3.35 TB/s); the 32-query
// block then does 32 times the needed arithmetic, which still stays under
// the read time.
#include <math_constants.h>
#include <climits>

#include "scan_tile.cuh"

namespace {

using namespace scan;

constexpr int kQPerWarp = kQB / kWarps;
constexpr int kMaxK = 10;

// The list (lane j holds entry j of a sorted top-k) takes the candidates of
// the lanes in `mask`, each lane offering (v, i). Called by the whole warp.
__device__ __forceinline__ void insert_lanes(float& lv, int& li, int k,
                                             unsigned mask, float v, int i,
                                             int lane) {
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const float cv = __shfl_sync(kFull, v, src);
    const int ci = __shfl_sync(kFull, i, src);
    const int pos =
        __popc(__ballot_sync(kFull, lane < k && better(lv, li, cv, ci)));
    const float up_v = __shfl_up_sync(kFull, lv, 1);
    const int up_i = __shfl_up_sync(kFull, li, 1);
    if (pos < k) {  // uniform across the warp
      if (lane > pos) { lv = up_v; li = up_i; }
      if (lane == pos) { lv = cv; li = ci; }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ bank, const float* __restrict__ inv_norms,
            int n, int D, const float* __restrict__ queries, int B, int k,
            int split_rows, float* __restrict__ part_v,
            int* __restrict__ part_i) {
  extern __shared__ __align__(16) float smem[];
  float* qsT = smem;               // [D][kQB] queries, transposed
  float* tile = qsT + D * kQB;     // [kThreads][D+1]; reused as sims [kQB][kThreads]

  const int s = blockIdx.x;
  const int q0 = blockIdx.y * kQB;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int row_begin = s * split_rows;
  const int row_end = min(n, row_begin + split_rows);

  load_queries(qsT, queries, q0, B, D, t);
  float lv[kQPerWarp];
  int li[kQPerWarp];
#pragma unroll
  for (int j = 0; j < kQPerWarp; ++j) { lv[j] = -CUDART_INF_F; li[j] = INT_MAX; }
  __syncthreads();

  for (int base = row_begin; base < row_end; base += kThreads) {
    const int rows = min(kThreads, row_end - base);
    load_tile(tile, bank, base, rows, D, t);
    const float inv = t < rows ? inv_norms[base + t] : 0.f;
    __syncthreads();

    float acc[kQB];
    tile_dots(acc, tile, qsT, D, t);
    __syncthreads();  // every thread is done reading the tile
    float* sims = tile;
#pragma unroll
    for (int q = 0; q < kQB; ++q) sims[q * kThreads + t] = __fmul_rn(acc[q], inv);
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kQPerWarp; ++j) {
      const int q = warp + j * kWarps;
      if (q0 + q >= B) continue;  // uniform across the warp
      for (int c0 = 0; c0 < rows; c0 += 32) {  // rows is uniform too
        const int c = c0 + lane;
        const float kv = __shfl_sync(kFull, lv[j], k - 1);
        const int ki = __shfl_sync(kFull, li[j], k - 1);
        const float v = c < rows ? sims[q * kThreads + c] : -CUDART_INF_F;
        const int r = base + c;
        const unsigned mask =
            __ballot_sync(kFull, c < rows && better(v, r, kv, ki));
        insert_lanes(lv[j], li[j], k, mask, v, r, lane);
      }
    }
    __syncthreads();  // the tile buffer is free for the next load
  }

#pragma unroll
  for (int j = 0; j < kQPerWarp; ++j) {
    const int q = warp + j * kWarps;
    if (q0 + q < B && lane < k) {
      const size_t o = ((size_t)s * B + q0 + q) * k + lane;
      part_v[o] = lv[j];
      part_i[o] = li[j];
    }
  }
}

// One warp per query: the top k of the S per-split lists; entries no split
// filled become (-inf, 0).
__global__ void merge_kernel(const float* __restrict__ part_v,
                             const int* __restrict__ part_i, int S, int B,
                             int k, float* __restrict__ out_v,
                             int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warps exit together
  float lv = -CUDART_INF_F;
  int li = INT_MAX;
  for (int c0 = 0; c0 < S * k; c0 += 32) {
    const int c = c0 + lane;
    const int kth_i = __shfl_sync(kFull, li, k - 1);
    const float kth_v = __shfl_sync(kFull, lv, k - 1);
    float v = -CUDART_INF_F;
    int i = INT_MAX;
    if (c < S * k) {
      const int split = c / k, j = c % k;
      const size_t o = ((size_t)split * B + b) * k + j;
      v = part_v[o];
      i = part_i[o];
    }
    const unsigned mask =
        __ballot_sync(kFull, i != INT_MAX && better(v, i, kth_v, kth_i));
    insert_lanes(lv, li, k, mask, v, i, lane);
  }
  if (lane < k) {
    const bool empty = li == INT_MAX;
    out_v[(size_t)b * k + lane] = empty ? -CUDART_INF_F : lv;
    out_i[(size_t)b * k + lane] = empty ? 0 : li;
  }
}

template <typename T>
int launch(const T* bank, const float* inv_norms, int n, int D,
           const float* queries, int B, int k, int split_rows, int S,
           float* part_v, int* part_i, float* out_v, int* out_i,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)D * kQB + (size_t)tile_floats(D));
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(S, (B + kQB - 1) / kQB);
  scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      bank, inv_norms, n, D, queries, B, k, split_rows, part_v, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps_per_block = 8;
  merge_kernel<<<(B + warps_per_block - 1) / warps_per_block,
                 32 * warps_per_block, 0, stream>>>(
      part_v, part_i, S, B, k, out_v, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bank: [>= n, D] row-major, float32 (bank_bf16 == 0) or bfloat16.
// inv_norms: [>= n] float32. queries: [B, D] float32.
// part_v / part_i: [S, B, k] scratch. out_v / out_i: [B, k].
// Returns cudaGetLastError() after the launches.
int cslam_tile_scan(const void* bank, int bank_bf16, const float* inv_norms,
                    int n, int D, const float* queries, int B, int k,
                    int split_rows, int S, float* part_v, int* part_i,
                    float* out_v, int* out_i, void* stream) {
  if (S < 1 || k < 1 || k > kMaxK || D < 1 || B < 1 || split_rows < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bank_bf16)
    return launch(static_cast<const __nv_bfloat16*>(bank), inv_norms, n, D,
                  queries, B, k, split_rows, S, part_v, part_i, out_v, out_i,
                  st);
  return launch(static_cast<const float*>(bank), inv_norms, n, D, queries, B,
                k, split_rows, S, part_v, part_i, out_v, out_i, st);
}

}  // extern "C"
