// Device and host code shared by the bank-scan kernels K1 (bank_scan.cu) and
// K2 (tile_scan.cu). Both compute, for each query q and each of the first n
// bank rows r,
//
//   v(q, r) = sum over d = 0..D-1 of q[d] * bank[r][d]     (K2: * inv[r])
//
// summed from zero with every product and every sum rounded on its own (the
// plain versions' order; the sources are built with --fmad=false), and keep
// the k best under (value descending, row ascending). Each file's note says
// what differs (query rounding, inv_norms, k, the n < k tail).
//
// Two paths, chosen by the batch size B alone:
//
// * Screen path (B >= kScreenMinB = 16), screen_kernel: a block of 8 warps
//   takes 32 queries and walks its share of the bank in tiles of 128 rows.
//   Warp w computes the approximate similarities s~ of rows 16w..16w+15
//   against the 32 queries with mma.sync on the tensor cores (m16n8k8 TF32,
//   inputs rounded cvt.rna, for an f32 bank; m16n8k16 bf16 for a bf16 bank),
//   and the norms ||b_r|| of its rows from the same fragments. Each s~ is
//   held in registers against tau_q - eps(q, r), where tau_q is the k-th best
//   EXACT value the block holds for q. On the block's first tile (k <= 32)
//   tau_q is seeded instead from the lower bounds s~ - eps <= v of that
//   tile's rows: the k-th largest of 32 lane maxima, each over 4 rows, so
//   at least k rows lie at or above it (otherwise -inf). Survivors
//   go to a per-query candidate list in shared memory, sized for the whole
//   tile, so nothing is ever dropped; the warp that owns q rescored each
//   with the exact plain-order dot product from the tile already in shared
//   memory and inserts it under (value, row). Output values are the
//   rescored ones.
// * Small-batch path (B < 16), small_kernel: no tensor cores. A block of 4
//   warps takes NQ = 1, 2, 4 or 8 queries; thread t computes the exact
//   plain-order dots of tile row t with the NQ queries (a 1-query block does
//   1x the arithmetic) and filters them in registers against its warp's
//   k-th best; every warp keeps its own lists, merged at the block's end.
//
// The error bound. eps(q, r) = c * ||q|| * ||b_r|| (K2: * |inv[r]|) bounds
// |s~ - v_plain|. With u the unit roundoff of the rounded inputs:
//   (a) input rounding: |round(x) - x| <= u|x| for each factor, so the
//       products of rounded inputs differ from the exact ones by at most
//       (2u + u^2)|q_d||b_d|, and summed over d by (2u + u^2)||q||||b|| by
//       Cauchy-Schwarz. TF32 (10-bit mantissa, cvt.rna) rounds both
//       factors: u = 2^-11, so (a) <= (2^-10 + 2^-22) ||q||||b||. bf16 with
//       K1's queries (already bf16) and a bf16 bank: exact inputs, (a) = 0.
//       K2's f32 queries against a bf16 bank: only the queries are rounded,
//       u = 2^-9, so (a) <= 2^-9 ||q||||b||.
//   (b) the tensor core's f32 accumulation, whose order and rounding are
//       not IEEE-sequential: products of rounded inputs are exact in f32,
//       and any summation of D <= 128 terms with a unit of at most 2^-23
//       (truncation included) errs by at most 127 * 2^-23 * sum|q_d b_d|
//       < 2^-16 ||q||||b||.
//   (c) the plain version's own sequential rounding: about (D + 1) *
//       2^-24 * sum|q_d b_d| <= 2^-16 ||q||||b|| for D <= 128.
// The kernel takes c = 2^-7 (TF32), 2^-10 (bf16, exact queries) and 2^-6
// (bf16, rounded queries): at least four times (a) + (c), so (a) + (c) <=
// eps/4 (the CPU tests assert this on the emulated screen, ops/nns.py
// screen_ref), and the remaining 3 eps/4 covers (b) and the rounding of the
// filter's own compare with a factor of more than 100 to spare. ||b_r|| is
// computed from the tile in shared memory (rows are not taken to be unit;
// summed with fused multiply-adds, relative error below 2^-16, which the
// same spare covers), ||q|| once per block. Zero padding (D to the MMA
// depth, rows past n) changes neither s~ nor eps.
//
// Why the result is exact. tau_q never exceeds the final k-th exact value:
// the seed lies at or below k exact values of the first tile (s~ - eps <=
// v), and afterwards tau_q is the k-th of k exact values already held. A
// row that ends in the block's top-k has v >= the final k-th value >= tau_q
// at every moment, and s~ >= v - eps, so it passes the filter whenever its
// tile is screened. A row that fails has v < tau_q, so at least k rows beat
// it: it cannot be in the top-k. The rescored values are the plain ones, so
// the kept lists are exactly the plain version's, ties included: no
// fallback.
//
// Tiles arrive by 16-byte cp.async into a ring of 2 stages (tile t+1 loads
// while tile t is computed); a bf16 bank stays bf16 in shared memory. Rows
// are padded with zeros to a multiple of 8 words (the MMA depth) plus 4
// words (row stride = 4 mod 8 words: the MMA fragment loads and the 16-byte
// row reads are bank-conflict free). A bank whose rows are not a multiple of
// 16 bytes is copied element by element instead, synchronously.
//
// Grid: (splits S, query blocks). S fills one whole wave (occupancy x SMs)
// and each block walks tiles s, s + S, ...; its lists go to part[b][s][k].
// merge_kernel (one block of 8 warps per query) then takes the best of the
// S lists' k-th entries as a floor, lets each warp merge a strided share of
// the entries at or above it, merges the 8 warp lists, scales by
// 1/max(||q||, 1e-12) (||q|| summed in the plain order from the f32
// queries) and writes f32 values and int64 indices into the outputs: two
// kernels per call.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace scan {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileRows = 128;      // bank rows per tile, both paths
constexpr int kScreenThreads = 256; // 8 warps x 16 rows
constexpr int kScreenQ = 32;        // queries per screen block (4 n-tiles of 8)
constexpr int kScreenMinB = 16;     // B >= 16 takes the screen path
constexpr int kSmallThreads = 128;  // one tile row per thread
constexpr int kSmallWarps = kSmallThreads / 32;
constexpr int kMergeThreads = 256;
constexpr int kMergeWarps = kMergeThreads / 32;

// ---------------------------------------------------------------- layout --

// 4-byte words of one padded tile row: the row's data rounded up to the MMA
// depth (8 words), plus 4 (stride = 4 mod 8 words).
__host__ __device__ __forceinline__ int data_words(int D, int elem_bytes) {
  const int w = (D * elem_bytes + 3) / 4;
  return (w + 7) / 8 * 8;
}
__host__ __device__ __forceinline__ int row_words(int D, int elem_bytes) {
  return data_words(D, elem_bytes) + 4;
}

// ------------------------------------------------------------ primitives --

// (value descending, row index ascending): the lax.top_k order
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Rows [base, base + rows) of the bank into one ring stage (stride W
// words); rows past `rows` are zero. 16-byte rows: cp.async (the caller
// commits); other widths: element by element, synchronously.
template <typename T, int NT>
__device__ __forceinline__ void load_tile(uint32_t* tile,
                                          const T* __restrict__ bank,
                                          int base, int rows, int D, int W,
                                          int t) {
  const int row_bytes = D * static_cast<int>(sizeof(T));
  const char* src = reinterpret_cast<const char*>(bank) +
                    static_cast<size_t>(base) * row_bytes;
  if ((row_bytes & 15) == 0) {
    const int cpr = row_bytes >> 4;  // 16-byte chunks per row
    const int dr = NT / cpr, dc = NT - dr * cpr;
    int r = t / cpr, c = t - r * cpr;
    while (r < kTileRows) {
      const bool ok = r < rows;
      cp_async16(tile + r * W + 4 * c,
                 ok ? src + static_cast<size_t>(r) * row_bytes + 16 * c
                    : reinterpret_cast<const char*>(bank),
                 ok);
      r += dr;
      c += dc;
      if (c >= cpr) { c -= cpr; ++r; }
    }
  } else {  // rows past `rows` are never read: left as they are
    for (int r = t >> 5; r < rows; r += NT / 32) {
      T* dst = reinterpret_cast<T*>(tile + r * W);
      const T* row = bank + static_cast<size_t>(base + r) * D;
      for (int d = t & 31; d < D; d += 32) dst[d] = row[d];
    }
  }
}

// Zero the words of every ring row past the data the loads write (the
// padding to the MMA depth); the loads never touch them.
template <int NT>
__device__ __forceinline__ void zero_padding(uint32_t* ring, int D,
                                             int elem_bytes, int W, int t) {
  const int w0 = D * elem_bytes / 4;
  const int pad = W - 4 - w0;
  for (int e = t; e < 2 * kTileRows * pad; e += NT) {
    const int r = e / pad;
    ring[r * W + w0 + (e - r * pad)] = 0u;
  }
}

// inv_norms of the tile's rows (zero past `rows`) by cp.async; base is a
// multiple of kTileRows, so 16-byte aligned when inv_norms is.
template <int NT>
__device__ __forceinline__ void load_inv(float* dst,
                                         const float* __restrict__ inv,
                                         int base, int rows, int t) {
  for (int c = t; c < kTileRows / 4; c += NT) {
    const bool ok = 4 * c < rows;
    // rows is a multiple of 4 except in the last tile: read whole chunks
    // only where all 4 rows are valid, the rest element by element
    if (ok && 4 * c + 4 <= rows) {
      cp_async16(dst + 4 * c, inv + base + 4 * c, true);
    } else {
      for (int j = 0; j < 4; ++j)
        dst[4 * c + j] = 4 * c + j < rows ? inv[base + 4 * c + j] : 0.f;
    }
  }
}

// The exact plain-order dot product of a tile row with a query, both
// zero-padded to the row's DW data words (the padding adds exact zeros),
// read 16 bytes at a time.
template <typename T>
__device__ __forceinline__ float exact_dot(const uint32_t* row,
                                           const float* q, int DW);
template <>
__device__ __forceinline__ float exact_dot<float>(const uint32_t* row,
                                                  const float* q, int DW) {
  const float4* x4 = reinterpret_cast<const float4*>(row);
  const float4* q4 = reinterpret_cast<const float4*>(q);
  float acc = 0.f;
#pragma unroll 4
  for (int c = 0; c < DW / 4; ++c) {
    const float4 x = x4[c], qa = q4[c];
    acc = __fadd_rn(acc, __fmul_rn(qa.x, x.x));
    acc = __fadd_rn(acc, __fmul_rn(qa.y, x.y));
    acc = __fadd_rn(acc, __fmul_rn(qa.z, x.z));
    acc = __fadd_rn(acc, __fmul_rn(qa.w, x.w));
  }
  return acc;
}
template <>
__device__ __forceinline__ float exact_dot<__nv_bfloat16>(
    const uint32_t* row, const float* q, int DW) {
  const uint4* x8 = reinterpret_cast<const uint4*>(row);
  const float4* q4 = reinterpret_cast<const float4*>(q);
  float acc = 0.f;
#pragma unroll 2
  for (int c = 0; c < DW / 4; ++c) {
    const uint4 w = x8[c];
    const float4 qa = q4[2 * c], qb = q4[2 * c + 1];
    acc = __fadd_rn(acc, __fmul_rn(qa.x, bf16_lo(w.x)));
    acc = __fadd_rn(acc, __fmul_rn(qa.y, bf16_hi(w.x)));
    acc = __fadd_rn(acc, __fmul_rn(qa.z, bf16_lo(w.y)));
    acc = __fadd_rn(acc, __fmul_rn(qa.w, bf16_hi(w.y)));
    acc = __fadd_rn(acc, __fmul_rn(qb.x, bf16_lo(w.z)));
    acc = __fadd_rn(acc, __fmul_rn(qb.y, bf16_hi(w.z)));
    acc = __fadd_rn(acc, __fmul_rn(qb.z, bf16_lo(w.w)));
    acc = __fadd_rn(acc, __fmul_rn(qb.w, bf16_hi(w.w)));
  }
  return acc;
}

// Floats of one exact query row on the screen path: the tile row's
// elements, plus 4 (stride = 4 mod 8 words: the rescore's 16-byte reads of
// different queries spread over the banks).
__host__ __device__ __forceinline__ int query_stride(int D, int elem_bytes) {
  return data_words(D, elem_bytes) * 4 / elem_bytes + 4;
}

// ------------------------------------------------------ register top-k --

// One compare-exchange of a warp bitonic network over the lane pairs
// (lane, lane ^ stride): with `up` the lower lane keeps the better entry.
__device__ __forceinline__ void bitonic_step(float& v, int& i, int stride,
                                             bool up, int lane) {
  const float ov = __shfl_xor_sync(kFull, v, stride);
  const int oi = __shfl_xor_sync(kFull, i, stride);
  const bool lower = (lane & stride) == 0;
  if (lower == up ? better(ov, oi, v, i) : better(v, i, ov, oi)) {
    v = ov;
    i = oi;
  }
}

// Sort one entry per lane, best in lane 0 (15 steps).
__device__ __forceinline__ void warp_sort(float& v, int& i, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      bitonic_step(v, i, stride, (lane & size) == 0, lane);
}

// A sorted top-k list (k <= 32 * KS) spread over a warp: entry j lives in
// slot j / 32 of lane j % 32. Empty entries are (-inf, INT_MAX).
template <int KS>
struct List {
  float v[KS];
  int i[KS];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int s = 0; s < KS; ++s) { v[s] = -CUDART_INF_F; i[s] = INT_MAX; }
  }

  // entry j, in every lane
  __device__ __forceinline__ void get(int j, float& ov, int& oi) const {
    float x = v[0];
    int y = i[0];
#pragma unroll
    for (int s = 1; s < KS; ++s)
      if ((j >> 5) == s) { x = v[s]; y = i[s]; }
    ov = __shfl_sync(kFull, x, j & 31);
    oi = __shfl_sync(kFull, y, j & 31);
  }

  // insert (cv, ci) if it ranks among the first k; whole warp, uniform
  __device__ __forceinline__ void insert(int k, float cv, int ci, int lane) {
    int pos = 0;
#pragma unroll
    for (int s = 0; s < KS; ++s)
      pos += __popc(__ballot_sync(
          kFull, 32 * s + lane < k && better(v[s], i[s], cv, ci)));
    if (pos >= k) return;
    float uv[KS];
    int ui[KS];
#pragma unroll
    for (int s = 0; s < KS; ++s) {  // entry j - 1, read before any write
      float a = __shfl_up_sync(kFull, v[s], 1);
      int b = __shfl_up_sync(kFull, i[s], 1);
      if (s > 0) {
        const float ca = __shfl_sync(kFull, v[s > 0 ? s - 1 : 0], 31);
        const int cb = __shfl_sync(kFull, i[s > 0 ? s - 1 : 0], 31);
        if (lane == 0) { a = ca; b = cb; }
      }
      uv[s] = a;
      ui[s] = b;
    }
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int j = 32 * s + lane;
      if (j > pos) { v[s] = uv[s]; i[s] = ui[s]; }
      else if (j == pos) { v[s] = cv; i[s] = ci; }
    }
  }

  // insert the candidates (v, i) of the lanes in `mask`: one at a time, or,
  // for many at once with KS == 1, sorted (bitonic) and merged with the
  // list (its 32 lanes stay sorted: lanes past k hold worse entries)
  __device__ __forceinline__ void insert_lanes(int k, unsigned mask, float cv,
                                               int ci, int lane) {
    if (KS == 1 && __popc(mask) > 4) {
      const bool mine = (mask >> lane) & 1u;
      float sv = mine ? cv : -CUDART_INF_F;
      int si = mine ? ci : INT_MAX;
      warp_sort(sv, si, lane);
      // best-first list against the reversed chunk: the better of each
      // pair is a bitonic sequence holding the best 32 of both
      const float rv = __shfl_sync(kFull, sv, 31 - lane);
      const int ri = __shfl_sync(kFull, si, 31 - lane);
      if (better(rv, ri, v[0], i[0])) { v[0] = rv; i[0] = ri; }
#pragma unroll
      for (int stride = 16; stride > 0; stride >>= 1)
        bitonic_step(v[0], i[0], stride, true, lane);
      return;
    }
    while (mask) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      insert(k, __shfl_sync(kFull, cv, src), __shfl_sync(kFull, ci, src),
             lane);
    }
  }

  // merge `count` entries (pv, pi) (any order) into the list
  __device__ __forceinline__ void merge(int k, const float* pv, const int* pi,
                                        int count, int lane) {
    for (int c0 = 0; c0 < count; c0 += 32) {
      const int c = c0 + lane;
      const float cv = c < count ? pv[c] : -CUDART_INF_F;
      const int ci = c < count ? pi[c] : INT_MAX;
      float kv;
      int ki;
      get(k - 1, kv, ki);
      insert_lanes(k, __ballot_sync(kFull, ci != INT_MAX &&
                                                better(cv, ci, kv, ki)),
                   cv, ci, lane);
    }
  }

  // entries 0..k-1 to (ov, oi)
  __device__ __forceinline__ void store(int k, float* ov, int* oi,
                                        int lane) const {
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int j = 32 * s + lane;
      if (j < k) { ov[j] = v[s]; oi[j] = i[s]; }
    }
  }
};

// ------------------------------------------------------------- kernels --

struct Stats {            // optional (nullptr: off)
  int survivors;          // candidates that passed the filter
  unsigned max_err_bits;  // screen path: max |s~ - v| / (||q|| ||b|| |inv|), f32 bits
  // SM cycles summed over blocks, by phase, from thread 0's clock64() at
  // the block's barriers. Screen path: tile wait, screen + filter, exact
  // rescore + insertion. Small path: tile wait, dots + insertion, the
  // block's final merge.
  unsigned long long cycles[3];
};

// Queries q0.. into shared memory: exact values (bf16-rounded when kRoundQ)
// at stride qstride, zero past D, and their norms qnorm[q] = ||q|| (the
// eps of the screen).
template <bool kRoundQ, int NQ, int NT>
__device__ __forceinline__ void load_queries(float* qx, int qstride,
                                             float* qnorm,
                                             const float* __restrict__ queries,
                                             int q0, int B, int D, int t) {
  for (int q = t >> 5; q < NQ; q += NT / 32) {
    for (int d = t & 31; d < qstride; d += 32) {
      float x = 0.f;
      if (q0 + q < B && d < D) {
        x = queries[static_cast<size_t>(q0 + q) * D + d];
        if (kRoundQ) x = __bfloat162float(__float2bfloat16_rn(x));
      }
      qx[q * qstride + d] = x;
    }
  }
  __syncthreads();
  if (t < NQ) {
    float ss = 0.f;
    for (int d = 0; d < D; ++d)
      ss = __fadd_rn(ss, __fmul_rn(qx[t * qstride + d], qx[t * qstride + d]));
    qnorm[t] = sqrtf(ss);
  }
}

// Screen path. Grid (S, ceil(B / 32)), kScreenThreads threads.
template <typename T, bool kInv, bool kRoundQ, int KS>
__global__ void __launch_bounds__(kScreenThreads, KS >= 4 ? 1 : 2)
screen_kernel(const T* __restrict__ bank, const float* __restrict__ inv_norms,
              int n, int D, const float* __restrict__ queries, int B, int k,
              float eps_c, float* __restrict__ part_v,
              int* __restrict__ part_i, Stats* stats) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int NT = kScreenThreads;
  const int DW = data_words(D, sizeof(T));
  const int W = DW + 4;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* ring = smem;                                  // [2][128][W]
  float* inv_s = reinterpret_cast<float*>(ring + 2 * kTileRows * W);  // [2][128]
  uint32_t* qm = reinterpret_cast<uint32_t*>(inv_s + 2 * kTileRows);  // [32][W] MMA words
  const int QS = query_stride(D, sizeof(T));
  float* qx = reinterpret_cast<float*>(qm + kScreenQ * W);  // [32][QS] exact
  float* qnorm = qx + kScreenQ * QS;                     // [32]
  float* tau = qnorm + kScreenQ;                         // [32]
  int* cnt = reinterpret_cast<int*>(tau + kScreenQ);     // [32] survivors per query
  int* nsurv = cnt + kScreenQ;                           // [1] the block's survivors
  float* cand_s = reinterpret_cast<float*>(nsurv + 1);   // [32][128] s~, then v
  uint8_t* cand = reinterpret_cast<uint8_t*>(cand_s + kScreenQ * kTileRows);  // [32][128] rows

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.y * kScreenQ;
  const int S = gridDim.x;

  zero_padding<NT>(ring, D, sizeof(T), W, t);
  load_queries<kRoundQ, kScreenQ, NT>(qx, QS, qnorm, queries, q0, B, D, t);
  // the MMA operand copy of the queries, zero past D
  for (int e = t; e < kScreenQ * W; e += NT) {
    const int q = e / W, w = e - q * W;
    uint32_t word = 0u;
    if (kBf16) {
      const int d = 2 * w;
      const float lo = d < D ? qx[q * QS + d] : 0.f;
      const float hi = d + 1 < D ? qx[q * QS + d + 1] : 0.f;
      const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
      word = *reinterpret_cast<const uint32_t*>(&p);
    } else if (w < D) {
      word = to_tf32(qx[q * QS + w]);
    }
    qm[e] = word;
  }
  if (t < kScreenQ) { tau[t] = -CUDART_INF_F; cnt[t] = 0; }
  if (t == 0) *nsurv = 0;
  __syncthreads();  // padding zeroed before any cp.async lands beside it
  unsigned long long cyc[3] = {0, 0, 0}, mark = 0;
  const bool timed = stats != nullptr && t == 0;

  List<KS> list[kScreenQ / 8];  // warp w owns queries w, w + 8, w + 16, w + 24
#pragma unroll
  for (int j = 0; j < kScreenQ / 8; ++j) list[j].clear();

  int tile = blockIdx.x;
  if (tile * kTileRows < n) {
    load_tile<T, NT>(ring, bank, tile * kTileRows,
                     min(kTileRows, n - tile * kTileRows), D, W, t);
    if (kInv) load_inv<NT>(inv_s, inv_norms, tile * kTileRows,
                           min(kTileRows, n - tile * kTileRows), t);
  }
  cp_async_commit();
  for (int it = 0; tile * kTileRows < n; ++it, tile += S) {
    const int stage = it & 1;
    const int base = tile * kTileRows;
    const int rows = min(kTileRows, n - base);
    const int next = tile + S;
    if (next * kTileRows < n) {  // tile t+1 loads while tile t is computed
      load_tile<T, NT>(ring + (stage ^ 1) * kTileRows * W, bank,
                       next * kTileRows, min(kTileRows, n - next * kTileRows),
                       D, W, t);
      if (kInv) load_inv<NT>(inv_s + (stage ^ 1) * kTileRows, inv_norms,
                             next * kTileRows,
                             min(kTileRows, n - next * kTileRows), t);
    }
    if (timed) mark = clock64();
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (timed) { const auto now = clock64(); cyc[0] += now - mark; mark = now; }
    const uint32_t* tl = ring + stage * kTileRows * W;
    const float* tinv = inv_s + stage * kTileRows;

    // ---- screen: s~ of rows 16 warp .. +15 against the 32 queries
    {
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
      float ss0 = 0.f, ss1 = 0.f;
      const int m0 = 16 * warp;
      const uint32_t* ar0 = tl + (m0 + g) * W + tq;
      const uint32_t* ar1 = ar0 + 8 * W;
      const uint32_t* br = qm + g * W + tq;
#pragma unroll 2
      for (int kw = 0; kw < DW; kw += 8) {
        uint32_t a0 = ar0[kw], a1 = ar1[kw], a2 = ar0[kw + 4],
                 a3 = ar1[kw + 4];
        // ||b_r||^2 by fused multiply-adds: only eps reads it (see the note)
        if (kBf16) {
          float x;
          x = bf16_lo(a0); ss0 = __fmaf_rn(x, x, ss0);
          x = bf16_hi(a0); ss0 = __fmaf_rn(x, x, ss0);
          x = bf16_lo(a2); ss0 = __fmaf_rn(x, x, ss0);
          x = bf16_hi(a2); ss0 = __fmaf_rn(x, x, ss0);
          x = bf16_lo(a1); ss1 = __fmaf_rn(x, x, ss1);
          x = bf16_hi(a1); ss1 = __fmaf_rn(x, x, ss1);
          x = bf16_lo(a3); ss1 = __fmaf_rn(x, x, ss1);
          x = bf16_hi(a3); ss1 = __fmaf_rn(x, x, ss1);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(acc[nt], a0, a1, a2, a3, br[nt * 8 * W + kw],
                     br[nt * 8 * W + kw + 4]);
        } else {
          const float f0 = __uint_as_float(a0), f1 = __uint_as_float(a1),
                      f2 = __uint_as_float(a2), f3 = __uint_as_float(a3);
          ss0 = __fmaf_rn(f2, f2, __fmaf_rn(f0, f0, ss0));
          ss1 = __fmaf_rn(f3, f3, __fmaf_rn(f1, f1, ss1));
          a0 = to_tf32(f0); a1 = to_tf32(f1); a2 = to_tf32(f2); a3 = to_tf32(f3);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_tf32(acc[nt], a0, a1, a2, a3, br[nt * 8 * W + kw],
                     br[nt * 8 * W + kw + 4]);
        }
      }
      ss0 += __shfl_xor_sync(kFull, ss0, 1);
      ss0 += __shfl_xor_sync(kFull, ss0, 2);
      ss1 += __shfl_xor_sync(kFull, ss1, 1);
      ss1 += __shfl_xor_sync(kFull, ss1, 2);
      const float bn[2] = {sqrtf(ss0), sqrtf(ss1)};
      float inv_r[2] = {1.f, 1.f};
      if (kInv) { inv_r[0] = tinv[m0 + g]; inv_r[1] = tinv[m0 + g + 8]; }
      // s~ (K2: times inv[r]) and eps of accumulator j of n-tile nt
      auto screened = [&](int nt, int j, float& s, float& e) {
        const int h = j >> 1;
        s = acc[nt][j];
        e = eps_c * qnorm[nt * 8 + 2 * tq + (j & 1)] * bn[h];
        if (kInv) { s = s * inv_r[h]; e = e * fabsf(inv_r[h]); }
      };
      // ---- seed (the block's first tile, k <= 32): tau_q from the lower
      // bounds s~ - eps <= v of the tile's rows, so the first tile is not
      // rescored whole. Each lane takes the largest of 4 rows' bounds; k
      // of these 32 maxima come from k different rows, so the k-th largest
      // is at most the tile's k-th exact value, hence at most the final one
      if (KS == 1 && it == 0) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int q = nt * 8 + 2 * tq + (j & 1);
            const int r = m0 + g + 8 * (j >> 1);
            float s, e;
            screened(nt, j, s, e);
            cand_s[q * kTileRows + r] = r < rows ? s - e : -CUDART_INF_F;
          }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kScreenQ / 8; ++j) {
          const int q = warp + 8 * j;
          if (q0 + q >= B) continue;  // uniform across the warp
          const float* lb = cand_s + q * kTileRows;
          float m = fmaxf(fmaxf(lb[lane], lb[lane + 32]),
                          fmaxf(lb[lane + 64], lb[lane + 96]));
          int mi = lane;
          warp_sort(m, mi, lane);
          m = __shfl_sync(kFull, m, k - 1);
          if (lane == 0) tau[q] = m;
        }
        __syncthreads();
      }
      // ---- filter: s~ + eps >= tau_q, survivors to the candidate lists
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = nt * 8 + 2 * tq + (j & 1);
          const int r = m0 + g + 8 * (j >> 1);
          float s, e;
          screened(nt, j, s, e);
          if (r < rows && q0 + q < B && s + e >= tau[q]) {
            const int slot = atomicAdd(&cnt[q], 1);
            cand[q * kTileRows + slot] = static_cast<uint8_t>(r);
            cand_s[q * kTileRows + slot] = s;
          }
        }
    }
    __syncthreads();
    if (timed) { const auto now = clock64(); cyc[1] += now - mark; mark = now; }

    // ---- the warp that owns queries w, w + 8, w + 16, w + 24 rescores
    // their survivors exactly, 32 at a time (lane i takes the i-th of the
    // four lists laid end to end), and inserts them under (value, row)
    int c[kScreenQ / 8], total = 0;
#pragma unroll
    for (int j = 0; j < kScreenQ / 8; ++j) {
      c[j] = cnt[warp + 8 * j];
      total += c[j];
    }
    unsigned entered[kScreenQ / 8] = {};
    for (int f0 = 0; f0 < total; f0 += 32) {
      const int f = f0 + lane;
      int j = -1, slot = f;
#pragma unroll
      for (int u = 0; u < kScreenQ / 8; ++u) {
        if (j < 0 && slot < c[u]) j = u;
        else if (j < 0) slot -= c[u];
      }
      float v = -CUDART_INF_F;
      int ri = INT_MAX;
      if (j >= 0) {
        const int q = warp + 8 * j;
        const int r = cand[q * kTileRows + slot];
        v = exact_dot<T>(tl + r * W, qx + q * QS, DW);
        if (kInv) v = __fmul_rn(v, tinv[r]);
        ri = base + r;
        if (stats != nullptr) {  // the observed screen error
          const uint32_t* x = tl + r * W;
          float ss = 0.f;
          for (int d = 0; d < D; ++d) {
            const float xd =
                kBf16 ? __bfloat162float(
                            reinterpret_cast<const __nv_bfloat16*>(x)[d])
                      : __uint_as_float(x[d]);
            ss = __fadd_rn(ss, __fmul_rn(xd, xd));
          }
          float den = qnorm[q] * sqrtf(ss);
          if (kInv) den *= fabsf(tinv[r]);
          if (den > 0.f)
            atomicMax(&stats->max_err_bits,
                      __float_as_uint(
                          fabsf(cand_s[q * kTileRows + slot] - v) / den));
        }
      }
#pragma unroll
      for (int u = 0; u < kScreenQ / 8; ++u) {
        if (c[u] == 0) continue;  // uniform across the warp
        float kv;
        int ki;
        list[u].get(k - 1, kv, ki);
        const unsigned mask =
            __ballot_sync(kFull, j == u && better(v, ri, kv, ki));
        entered[u] |= mask;
        list[u].insert_lanes(k, mask, v, ri, lane);
      }
    }
#pragma unroll
    for (int j = 0; j < kScreenQ / 8; ++j) {
      float kv = 0.f;
      int ki;
      if (entered[j]) list[j].get(k - 1, kv, ki);  // uniform
      if (lane == 0) {
        if (entered[j]) tau[warp + 8 * j] = kv;
        cnt[warp + 8 * j] = 0;
      }
    }
    if (lane == 0 && total) atomicAdd(nsurv, total);
    __syncthreads();  // stage free for the next load, taus published
    if (timed) cyc[2] += clock64() - mark;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < kScreenQ / 8; ++j) {
    const int q = warp + 8 * j;
    if (q0 + q < B) {
      const size_t o = (static_cast<size_t>(q0 + q) * S + blockIdx.x) * k;
      list[j].store(k, part_v + o, part_i + o, lane);
    }
  }
  if (timed) {
    atomicAdd(&stats->survivors, *nsurv);
    for (int p = 0; p < 3; ++p) atomicAdd(&stats->cycles[p], cyc[p]);
  }
}

// Small-batch path. Grid (S, ceil(B / NQ)), kSmallThreads threads.
template <typename T, bool kInv, bool kRoundQ, int KS, int NQ>
__global__ void __launch_bounds__(kSmallThreads)
small_kernel(const T* __restrict__ bank, const float* __restrict__ inv_norms,
             int n, int D, const float* __restrict__ queries, int B, int k,
             float* __restrict__ part_v, int* __restrict__ part_i,
             Stats* stats) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int NT = kSmallThreads;
  const int DW = data_words(D, sizeof(T));
  const int W = DW + 4;
  const int QL = DW * 4 / static_cast<int>(sizeof(T));  // padded elements
  extern __shared__ __align__(16) uint32_t smem[];
  const int ring_words = max(2 * kTileRows * W, kSmallWarps * NQ * k * 2);
  uint32_t* ring = smem;                                   // [2][128][W]
  float* inv_s = reinterpret_cast<float*>(ring + ring_words);  // [2][128]
  float* qx = inv_s + 2 * kTileRows;                       // [NQ][QL]
  float* qnorm = qx + NQ * QL;                             // [NQ]
  int* passed = reinterpret_cast<int*>(qnorm + NQ);        // [1]

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int q0 = blockIdx.y * NQ;
  const int S = gridDim.x;

  zero_padding<NT>(ring, D, sizeof(T), W, t);
  load_queries<kRoundQ, NQ, NT>(qx, QL, qnorm, queries, q0, B, D, t);
  if (t == 0) *passed = 0;
  __syncthreads();

  List<KS> list[NQ];  // this warp's rows only; merged at the end
#pragma unroll
  for (int q = 0; q < NQ; ++q) list[q].clear();
  int my_passed = 0;
  unsigned long long cyc[3] = {0, 0, 0}, mark = 0;
  const bool timed = stats != nullptr && t == 0;

  int tile = blockIdx.x;
  if (tile * kTileRows < n) {
    load_tile<T, NT>(ring, bank, tile * kTileRows,
                     min(kTileRows, n - tile * kTileRows), D, W, t);
    if (kInv) load_inv<NT>(inv_s, inv_norms, tile * kTileRows,
                           min(kTileRows, n - tile * kTileRows), t);
  }
  cp_async_commit();
  for (int it = 0; tile * kTileRows < n; ++it, tile += S) {
    const int stage = it & 1;
    const int base = tile * kTileRows;
    const int rows = min(kTileRows, n - base);
    const int next = tile + S;
    if (next * kTileRows < n) {
      load_tile<T, NT>(ring + (stage ^ 1) * kTileRows * W, bank,
                       next * kTileRows, min(kTileRows, n - next * kTileRows),
                       D, W, t);
      if (kInv) load_inv<NT>(inv_s + (stage ^ 1) * kTileRows, inv_norms,
                             next * kTileRows,
                             min(kTileRows, n - next * kTileRows), t);
    }
    if (timed) mark = clock64();
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (timed) { const auto now = clock64(); cyc[0] += now - mark; mark = now; }

    // exact dots of row t with the NQ queries, in the plain order (the
    // zero padding past D adds exact zeros)
    const uint32_t* row = ring + stage * kTileRows * W + t * W;
    float acc[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[q] = 0.f;
    if (kBf16) {
      const uint4* x8 = reinterpret_cast<const uint4*>(row);
      for (int c = 0; c < DW / 4; ++c) {
        const uint4 w = x8[c];
        const float x[8] = {bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y),
                            bf16_hi(w.y), bf16_lo(w.z), bf16_hi(w.z),
                            bf16_lo(w.w), bf16_hi(w.w)};
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float4* q4 = reinterpret_cast<const float4*>(qx + q * QL) + 2 * c;
          const float4 qa = q4[0], qb = q4[1];
          acc[q] = __fadd_rn(acc[q], __fmul_rn(qa.x, x[0]));
          acc[q] = __fadd_rn(acc[q], __fmul_rn(qa.y, x[1]));
          acc[q] = __fadd_rn(acc[q], __fmul_rn(qa.z, x[2]));
          acc[q] = __fadd_rn(acc[q], __fmul_rn(qa.w, x[3]));
          acc[q] = __fadd_rn(acc[q], __fmul_rn(qb.x, x[4]));
          acc[q] = __fadd_rn(acc[q], __fmul_rn(qb.y, x[5]));
          acc[q] = __fadd_rn(acc[q], __fmul_rn(qb.z, x[6]));
          acc[q] = __fadd_rn(acc[q], __fmul_rn(qb.w, x[7]));
        }
      }
    } else {
      const float4* x4 = reinterpret_cast<const float4*>(row);
      for (int c = 0; c < DW / 4; ++c) {
        const float4 x = x4[c];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float4 qa = reinterpret_cast<const float4*>(qx + q * QL)[c];
          acc[q] = __fadd_rn(acc[q], __fmul_rn(qa.x, x.x));
          acc[q] = __fadd_rn(acc[q], __fmul_rn(qa.y, x.y));
          acc[q] = __fadd_rn(acc[q], __fmul_rn(qa.z, x.z));
          acc[q] = __fadd_rn(acc[q], __fmul_rn(qa.w, x.w));
        }
      }
    }
    const bool valid = t < rows;
    const float inv = kInv ? inv_s[stage * kTileRows + t] : 1.f;
    const int r = base + t;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      if (q0 + q >= B) continue;  // uniform
      const float v = kInv ? __fmul_rn(acc[q], inv) : acc[q];
      float kv;
      int ki;
      list[q].get(k - 1, kv, ki);
      const bool pass = valid && better(v, r, kv, ki);
      my_passed += pass;
      list[q].insert_lanes(k, __ballot_sync(kFull, pass), v, r, lane);
    }
    __syncthreads();  // stage free for the next load
    if (timed) cyc[1] += clock64() - mark;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (timed) mark = clock64();

  // merge the warps' lists per query, through the (now idle) ring
  float* mv = reinterpret_cast<float*>(ring);          // [NQ][warps][k]
  int* mi = reinterpret_cast<int*>(ring) + kSmallWarps * NQ * k;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
    list[q].store(k, mv + (q * kSmallWarps + warp) * k,
                  mi + (q * kSmallWarps + warp) * k, lane);
  if (stats != nullptr && my_passed) atomicAdd(passed, my_passed);
  __syncthreads();
  for (int q = warp; q < NQ; q += kSmallWarps) {
    if (q0 + q >= B) continue;
    List<KS> m;
    m.clear();
    m.merge(k, mv + q * kSmallWarps * k, mi + q * kSmallWarps * k,
            kSmallWarps * k, lane);
    const size_t o = (static_cast<size_t>(q0 + q) * S + blockIdx.x) * k;
    m.store(k, part_v + o, part_i + o, lane);
  }
  __syncthreads();
  if (timed) {
    cyc[2] = clock64() - mark;
    atomicAdd(&stats->survivors, *passed);
    for (int p = 0; p < 3; ++p) atomicAdd(&stats->cycles[p], cyc[p]);
  }
}

// One block per query: the top k of its S lists, scaled, with the tail.
template <int KS, bool kTailZero>
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
             int S, int k, int n, const float* __restrict__ queries, int D,
             float* __restrict__ out_v, int64_t* __restrict__ out_i) {
  __shared__ float fv[kMergeWarps];
  __shared__ int fi[kMergeWarps];
  extern __shared__ __align__(16) float msm[];  // [warps][k] values, indices
  float* wv = msm;
  int* wi = reinterpret_cast<int*>(msm + kMergeWarps * k);
  const int b = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* pv = part_v + static_cast<size_t>(b) * S * k;
  const int* pi = part_i + static_cast<size_t>(b) * S * k;
  const int L = S * k;

  // the floor: the best of the lists' k-th entries (the global k-th is at
  // least as good, since that list alone holds k entries at or above it)
  float bv = -CUDART_INF_F;
  int bi = INT_MAX;
  for (int s = t; s < S; s += kMergeThreads) {
    const float v = pv[s * k + k - 1];
    const int i = pi[s * k + k - 1];
    if (better(v, i, bv, bi)) { bv = v; bi = i; }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, bv, o);
    const int oi = __shfl_xor_sync(kFull, bi, o);
    if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
  }
  if (lane == 0) { fv[warp] = bv; fi[warp] = bi; }
  __syncthreads();
  bv = fv[0];
  bi = fi[0];
  for (int w = 1; w < kMergeWarps; ++w)
    if (better(fv[w], fi[w], bv, bi)) { bv = fv[w]; bi = fi[w]; }

  // each warp: a strided share of the entries at or above the floor
  List<KS> list;
  list.clear();
  constexpr int kBatch = 4;  // chunks loaded before any is merged
  for (int c0 = 32 * warp; c0 < L; c0 += kBatch * kMergeThreads) {
    float v[kBatch];
    int i[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u * kMergeThreads + lane;
      v[u] = c < L ? pv[c] : -CUDART_INF_F;
      i[u] = c < L ? pi[c] : INT_MAX;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      float kv;
      int ki;
      list.get(k - 1, kv, ki);
      const bool keep = i[u] != INT_MAX && !better(bv, bi, v[u], i[u]) &&
                        better(v[u], i[u], kv, ki);
      list.insert_lanes(k, __ballot_sync(kFull, keep), v[u], i[u], lane);
    }
  }
  list.store(k, wv + warp * k, wi + warp * k, lane);
  __syncthreads();
  if (warp != 0) return;
  list.clear();
  list.merge(k, wv, wi, kMergeWarps * k, lane);

  // 1 / max(||q||, 1e-12) of the f32 query, ||q|| summed in the plain order
  float scale = 0.f;
  if (lane == 0) {
    const float* q = queries + static_cast<size_t>(b) * D;
    float ss = 0.f;
    for (int d = 0; d < D; ++d) ss = __fadd_rn(ss, __fmul_rn(q[d], q[d]));
    scale = __frcp_rn(fmaxf(__fsqrt_rn(ss), 1e-12f));
  }
  scale = __shfl_sync(kFull, scale, 0);
  int m = 0;  // real entries (they come first)
#pragma unroll
  for (int s = 0; s < KS; ++s)
    m += __popc(__ballot_sync(kFull, 32 * s + lane < k &&
                                         list.i[s] != INT_MAX));
  float* ov = out_v + static_cast<size_t>(b) * k;
  int64_t* oi = out_i + static_cast<size_t>(b) * k;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int j = 32 * s + lane;
    if (j >= k) continue;
    if (j < m) {
      ov[j] = __fmul_rn(list.v[s], scale);
      oi[j] = list.i[s];
    } else {  // fewer than k valid rows
      ov[j] = -CUDART_INF_F;
      oi[j] = kTailZero ? 0 : n + (j - m);
    }
  }
}

// ---------------------------------------------------------------- host --

inline int sm_count() {
  static int cache[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cache[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cache[dev] = sms > 0 ? sms : 132;
  }
  return cache[dev];
}

// Blocks of Kernel resident per SM at `smem` bytes, once per kernel and row
// width D (the kernel's opt-in shared-memory limit is raised on first use).
template <auto Kernel>
int blocks_per_sm(int threads, size_t smem, int D) {
  static int cache[129] = {0};
  static bool raised = false;
  if (!raised) {
    cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         232448);
    raised = true;
  }
  if (D < 1 || D > 128) return 1;
  if (cache[D] == 0) {
    int nb = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, Kernel, threads,
                                                      smem) != cudaSuccess ||
        nb < 1)
      nb = 1;
    cache[D] = nb;
  }
  return cache[D];
}

inline size_t screen_smem(int D, int elem_bytes) {
  const int W = row_words(D, elem_bytes);
  return 4 * (static_cast<size_t>(2) * kTileRows * W + 2 * kTileRows +
              kScreenQ * W + kScreenQ * query_stride(D, elem_bytes) +
              3 * kScreenQ + 1 +
              kScreenQ * kTileRows) +
         kScreenQ * kTileRows;
}

inline size_t small_smem(int D, int elem_bytes, int NQ, int k) {
  const int W = row_words(D, elem_bytes);
  const int QL = data_words(D, elem_bytes) * 4 / elem_bytes;
  const size_t ring = static_cast<size_t>(2) * kTileRows * W;
  const size_t lists = static_cast<size_t>(kSmallWarps) * NQ * k * 2;
  return 4 * ((ring > lists ? ring : lists) + 2 * kTileRows + NQ * QL + NQ +
              1);
}

// queries per block: 32 on the screen path, else 1, 2, 4 or 8
inline int queries_per_block(int B) {
  return B >= kScreenMinB ? kScreenQ : B <= 1 ? 1 : B <= 2 ? 2 : B <= 4 ? 4 : 8;
}

// One call's kernels, chosen by shape alone: the splits S of the bank (one
// whole wave of S x query-block blocks), then the scan and the merge.
template <typename T, bool kInv, bool kRoundQ, bool kTailZero, int KS>
struct Scan {
  // eps(q, r) / (||q|| ||b_r||): TF32; bf16 with exact (already bf16)
  // queries; bf16 with f32 queries rounded (see the note at the top)
  static constexpr float kEps = sizeof(T) == 4 ? 0.0078125f
                                : kRoundQ      ? 0.0009765625f
                                               : 0.015625f;

  template <int NQ>
  static int small_occupancy(int D, int k) {
    return blocks_per_sm<small_kernel<T, kInv, kRoundQ, KS, NQ>>(
        kSmallThreads, small_smem(D, sizeof(T), NQ, k), D);
  }

  static int occupancy(int D, int B, int k) {
    switch (queries_per_block(B)) {
      case kScreenQ:
        return blocks_per_sm<screen_kernel<T, kInv, kRoundQ, KS>>(
            kScreenThreads, screen_smem(D, sizeof(T)), D);
      case 1: return small_occupancy<1>(D, k);
      case 2: return small_occupancy<2>(D, k);
      case 4: return small_occupancy<4>(D, k);
      default: return small_occupancy<8>(D, k);
    }
  }

  static int splits(int n, int D, int B, int k) {
    const int qpb = queries_per_block(B);
    const int qblocks = (B + qpb - 1) / qpb;
    const int tiles = n > 0 ? (n + kTileRows - 1) / kTileRows : 1;
    const int S = occupancy(D, B, k) * sm_count() / qblocks;
    return S < 1 ? 1 : (S < tiles ? S : tiles);
  }

  template <int NQ>
  static void small(dim3 grid, const T* bank, const float* inv, int n, int D,
                    const float* queries, int B, int k, float* part_v,
                    int* part_i, Stats* stats, cudaStream_t st) {
    small_kernel<T, kInv, kRoundQ, KS, NQ>
        <<<grid, kSmallThreads, small_smem(D, sizeof(T), NQ, k), st>>>(
            bank, inv, n, D, queries, B, k, part_v, part_i, stats);
  }

  static int run(const T* bank, const float* inv, int n, int D,
                 const float* queries, int B, int k, int S, float* part_v,
                 int* part_i, float* out_v, int64_t* out_i, Stats* stats,
                 cudaStream_t st) {
    occupancy(D, B, k);  // raises the kernel's shared-memory limit once
    const int qpb = queries_per_block(B);
    const dim3 grid(S, (B + qpb - 1) / qpb);
    switch (qpb) {
      case kScreenQ:
        screen_kernel<T, kInv, kRoundQ, KS>
            <<<grid, kScreenThreads, screen_smem(D, sizeof(T)), st>>>(
                bank, inv, n, D, queries, B, k, kEps, part_v, part_i, stats);
        break;
      case 1: small<1>(grid, bank, inv, n, D, queries, B, k, part_v, part_i, stats, st); break;
      case 2: small<2>(grid, bank, inv, n, D, queries, B, k, part_v, part_i, stats, st); break;
      case 4: small<4>(grid, bank, inv, n, D, queries, B, k, part_v, part_i, stats, st); break;
      default: small<8>(grid, bank, inv, n, D, queries, B, k, part_v, part_i, stats, st); break;
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    merge_kernel<KS, kTailZero>
        <<<B, kMergeThreads, sizeof(float) * 2 * kMergeWarps * k, st>>>(
            part_v, part_i, S, k, n, queries, D, out_v, out_i);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace scan
