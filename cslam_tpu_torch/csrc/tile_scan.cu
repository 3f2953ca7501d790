// K2: exact cosine top-k (k <= 10) over a bank with inverse row norms, for
// Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel cslam_tpu/ops/nns_pallas.py::_scan_kernel
// (launched by cosine_topk_fused). It computes that kernel's contract, not
// its 4096-row tile structure:
//
//   sim[b][r] = (sum over d = 0..D-1 of q[b][d] * bank[r][d]) * inv_norms[r]
//   for the first n rows; the k largest per query, ordered by (value
//   descending, row index ascending), k <= 10, scaled by 1/max(||q||,
//   1e-12). A bf16 bank is widened; the queries stay float32. With fewer
//   than k valid rows the trailing slots hold (-inf, row 0): the TPU
//   kernel's argmax over an all -inf tile returns its first column.
//
// Design (scan_tile.cuh, shared with K1, holds the two paths, the error
// bound eps and the argument that the result is exact):
//   * B >= 16: the tensor-core screen, then the exact FP32 rescore of the
//     survivors in the plain order, times inv_norms[r] (one __fmul_rn), so
//     kernel and plain version agree bit for bit. The screen's bound is
//     eps = c ||q|| ||b_r|| |inv_norms[r]|: TF32 for an f32 bank (c = 2^-7);
//     bf16 mma for a bf16 bank, the f32 queries rounded to bf16 in the
//     operand only (c = 2^-6; the rescore uses the f32 queries). The
//     inputs' rounding (TF32 rounds both factors, unit 2^-11: about 2^-10
//     ||q|| ||b_r||; bf16 here rounds the queries only, unit 2^-9: 2^-9
//     ||q|| ||b_r||; by Cauchy-Schwarz) plus the plain version's own
//     rounding (at most 2^-16 ||q|| ||b_r||) take at most eps / 4; the rest
//     covers the tensor core's f32 accumulation order (under 2^-16 ||q||
//     ||b_r|| for D <= 128); the factor |inv_norms[r]| scales all three.
//   * B < 16 (the front end's B = 1 per keyframe): exact plain-order dots,
//     one row per thread and 1, 2, 4 or 8 queries per block, so a 1-query
//     block does 1x the arithmetic; each block streams its share of the bank
//     through the 2-stage cp.async ring at memory rate.
//   * The merge kernel (one block per query) takes the best of the splits'
//     k-th entries as a floor, merges what is at or above it across 8 warps,
//     scales by 1/max(||q||, 1e-12) and writes f32 values and int64 indices:
//     two kernels per call, nothing else.
//
// What bounds it on an H100 SXM: at B = 1, n = 100000, D = 64 the 26 MB read
// of rows and norms (0.0078 ms at 3.35 TB/s). At B = 512 the screen's 6.6
// GFLOP at the TF32 tensor-core rate (495 TFLOP/s, 0.0132 ms).
#include "scan_tile.cuh"

namespace {

constexpr int kMaxK = 10;

template <typename T>
using K2 = scan::Scan<T, /*kInv=*/true, /*kRoundQ=*/false,
                      /*kTailZero=*/true, /*KS=*/1>;

}  // namespace

extern "C" {

// The number of bank splits S for one call (part buffers are [B][S][k]).
int cslam_tile_scan_splits(int bank_bf16, int n, int D, int B, int k) {
  if (k < 1 || k > kMaxK || D < 1 || D > 128 || B < 1 || n < 0) return -1;
  return bank_bf16 ? K2<__nv_bfloat16>::splits(n, D, B, k)
                   : K2<float>::splits(n, D, B, k);
}

// bank: [>= n, D] row-major, float32 (bank_bf16 == 0) or bfloat16.
// inv_norms: [>= n] float32. queries: [B, D] float32. All three 16-byte
// aligned. part_v / part_i: [B, S, k] scratch. out_v: [B, k] float32;
// out_i: [B, k] int64. stats: nullptr or scan::Stats (zeroed by the
// caller). Returns cudaGetLastError() after the two launches.
int cslam_tile_scan(const void* bank, int bank_bf16, const float* inv_norms,
                    int n, int D, const float* queries, int B, int k, int S,
                    float* part_v, int* part_i, float* out_v, int64_t* out_i,
                    void* stats, void* stream) {
  if (S < 1 || k < 1 || k > kMaxK || D < 1 || D > 128 || B < 1 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  scan::Stats* s = static_cast<scan::Stats*>(stats);
  if (bank_bf16)
    return K2<__nv_bfloat16>::run(
        static_cast<const __nv_bfloat16*>(bank), inv_norms, n, D, queries, B,
        k, S, part_v, part_i, out_v, out_i, s, st);
  return K2<float>::run(static_cast<const float*>(bank), inv_norms, n, D,
                        queries, B, k, S, part_v, part_i, out_v, out_i, s,
                        st);
}

}  // extern "C"
