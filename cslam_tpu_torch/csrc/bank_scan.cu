// K1: exact cosine top-k bank scan for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel cslam_tpu/ops/nns_pallas.py::_scan_kernel2
// (launched by _fused2_pre_one behind cosine_topk_fused2_pre). It computes
// that kernel's contract, not its TPU block structure:
//
//   for each query b: the k largest dot products q_b . bank_r over the first
//   n bank rows (unit rows, taken as given), ordered by (value descending,
//   row index ascending), k <= 128; with a bf16 bank the queries are
//   rounded to bf16 (here, in the kernel) and the products summed in f32;
//   the values scaled by 1/max(||q||, 1e-12) of the f32 queries; with
//   n < k the trailing slots hold (-inf, n, n+1, ...).
//
// Design (scan_tile.cuh, shared with K2, holds the two paths, the error
// bound eps and the argument that the result is exact):
//   * B >= 16: the tensor-core screen (TF32 mma.sync for an f32 bank, bf16
//     for a bf16 bank, whose queries are already bf16: exact inputs, eps =
//     2^-10 ||q|| ||b_r||; TF32: eps = 2^-7 ||q|| ||b_r||), then the exact
//     FP32 rescore of the survivors in the plain order, so kernel and plain
//     version agree bit for bit, ties included. eps bounds |s~ - v|: the
//     inputs' rounding (TF32, unit 2^-11 on both factors: about 2^-10
//     ||q|| ||b_r|| by Cauchy-Schwarz; none for bf16 here) plus the plain
//     version's own rounding (at most 2^-16 ||q|| ||b_r||) take at most
//     eps / 4, and the rest covers the tensor core's f32 accumulation
//     (under 2^-16 ||q|| ||b_r|| for D <= 128, in any order).
//   * B < 16 (the swarm's padded batches): exact plain-order dots, one row
//     per thread, 1, 2, 4 or 8 queries per block.
//   * Top-k lists in registers, k / 32 rounded up entries per lane (1, 2 or
//     4 slots); the merge kernel writes scaled f32 values and int64 indices.
//
// What bounds it on an H100 SXM: at the main-path shape (n = 100000 rows,
// D = 64, B = 512, f32 bank) the screen is 6.55 GFLOP, 0.0132 ms at the
// 495 TFLOP/s TF32 rate (bf16: 0.0066 ms at 989), against 25.6 MB of bank
// rows, 0.0076 ms at 3.35 TB/s: the tensor-core rate bounds it. mma.sync
// reaches only part of that rate (wgmma would be needed for all of it), and
// each block also rescores, in the FP32 cores, about k ln(rows / k)
// insertions per query plus the few rows within eps of its threshold. At
// B < 16 the bank read bounds it.
#include "scan_tile.cuh"

namespace {

template <typename T, int KS>
using K1 = scan::Scan<T, /*kInv=*/false, /*kRoundQ=*/sizeof(T) == 2,
                      /*kTailZero=*/false, KS>;

template <typename T>
int splits(int n, int D, int B, int k) {
  if (k <= 32) return K1<T, 1>::splits(n, D, B, k);
  if (k <= 64) return K1<T, 2>::splits(n, D, B, k);
  return K1<T, 4>::splits(n, D, B, k);
}

template <typename T>
int run(const void* bank, int n, int D, const float* queries, int B, int k,
        int S, float* part_v, int* part_i, float* out_v, int64_t* out_i,
        scan::Stats* stats, cudaStream_t st) {
  const T* b = static_cast<const T*>(bank);
  if (k <= 32)
    return K1<T, 1>::run(b, nullptr, n, D, queries, B, k, S, part_v, part_i,
                         out_v, out_i, stats, st);
  if (k <= 64)
    return K1<T, 2>::run(b, nullptr, n, D, queries, B, k, S, part_v, part_i,
                         out_v, out_i, stats, st);
  return K1<T, 4>::run(b, nullptr, n, D, queries, B, k, S, part_v, part_i,
                       out_v, out_i, stats, st);
}

}  // namespace

extern "C" {

// The number of bank splits S for one call (part buffers are [B][S][k]).
int cslam_bank_scan_splits(int bank_bf16, int n, int D, int B, int k) {
  if (k < 1 || k > 128 || D < 1 || D > 128 || B < 1 || n < 0) return -1;
  return bank_bf16 ? splits<__nv_bfloat16>(n, D, B, k)
                   : splits<float>(n, D, B, k);
}

// bank: [>= n, D] row-major, float32 (bank_bf16 == 0) or bfloat16, 16-byte
// aligned. queries: [B, D] float32, 16-byte aligned. part_v / part_i:
// [B, S, k] scratch. out_v: [B, k] float32; out_i: [B, k] int64. stats:
// nullptr or scan::Stats (zeroed by the caller). Returns cudaGetLastError()
// after the two launches.
int cslam_bank_scan(const void* bank, int bank_bf16, int n, int D,
                    const float* queries, int B, int k, int S, float* part_v,
                    int* part_i, float* out_v, int64_t* out_i, void* stats,
                    void* stream) {
  if (S < 1 || k < 1 || k > 128 || D < 1 || D > 128 || B < 1 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  scan::Stats* s = static_cast<scan::Stats*>(stats);
  return bank_bf16 ? run<__nv_bfloat16>(bank, n, D, queries, B, k, S, part_v,
                                        part_i, out_v, out_i, s, st)
                   : run<float>(bank, n, D, queries, B, k, S, part_v, part_i,
                                out_v, out_i, s, st);
}

}  // extern "C"
