// Segment sums in a fixed order for Hopper (sm_90a), plain C interface:
// the normal-equation sums of the port's PGO solvers (centralized,
// distributed, chordal) and MAC's dense-tier Laplacian.
//
// Replaces no TPU kernel. The JAX package sums these with one-hot matmuls
// (cslam_tpu/pgo/solver.py:154-195, cslam_tpu/pgo/distributed.py:380-400),
// whose order is fixed, so its runs repeat. The port summed with
// index_add_ / index_put_(accumulate=True): atomics on the card, whose order
// changes from run to run, so two eager runs of one problem drifted apart
// (up to 1e-2 m over an 8 x 256 GNC). Here the order is a plan made once
// per problem (cslam_tpu_torch/ops/segment_sum.py): perm lists the source
// rows by destination, in source order within one, and offsets[s] ..
// offsets[s + 1] is segment s's range of perm (CSR).
//
// Contract: src [n_src, C] float32, perm [n_src] int64, offsets [n_seg + 1]
// int64, out [n_seg, C] float32; out[s][c] = the sum over k in
// offsets[s] .. offsets[s + 1] of src[perm[k]][c], added in k's order from
// +0.0, each add rounded to float32 (the plain version, segment_sum_ref,
// adds the same way, and so does the CPU's index_add_ over the
// concatenated sources; the build has --fmad=false and the adds are
// __fadd_rn, so nothing contracts). An empty segment gives +0.0.
//
// Design: the work is a gather and a short sum per row, bound by bytes
// (each source row read once, each destination row written once; about
// 0.02-0.2 ms at the solvers' shapes at 3.35 TB/s). One warp takes
// 32 / C segments for C < 32 (lane = segment slot x component, so the
// lanes of a segment read one source row's C consecutive floats), or one
// segment with lanes striding the components for C >= 32 (36: lanes 0-3
// take two). perm[k] is the same address for a segment's lanes (one
// broadcast load). Warps stride over the segments; enough blocks are
// started to fill the card once. A launch adds one to *count (thread 0 of
// block 0), so replays from a CUDA graph are counted too.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__global__ void segment_sum_kernel(const float* __restrict__ src,
                                   const long long* __restrict__ perm,
                                   const long long* __restrict__ offsets,
                                   float* __restrict__ out, long long n_seg,
                                   int C, unsigned long long* count) {
  if (count != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(count, 1ULL);
  const int lane = threadIdx.x & 31;
  const int per_warp = C < 32 ? 32 / C : 1;   // segments per warp
  const int slot = C < 32 ? lane / C : 0;
  const int c0 = C < 32 ? lane % C : lane;
  const int c_step = C < 32 ? C : 32;
  if (slot >= per_warp) return;                // idle lanes (32 % C)
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long warps =
      (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long s = warp * per_warp + slot; s < n_seg;
       s += warps * per_warp) {
    const long long begin = offsets[s], end = offsets[s + 1];
    for (int c = c0; c < C; c += c_step) {
      float acc = 0.0f;
      for (long long k = begin; k < end; ++k)
        acc = __fadd_rn(acc, src[perm[k] * C + c]);
      out[s * C + c] = acc;
    }
  }
}

}  // namespace

extern "C" {

// src: [n_src, C] float32; perm: [n_src] int64; offsets: [n_seg + 1] int64;
// out: [n_seg, C] float32. count: nullptr or a device uint64 that each
// launch adds one to. Returns cudaGetLastError() after the launch.
int cslam_segment_sum(const float* src, const long long* perm,
                      const long long* offsets, float* out, long long n_seg,
                      int C, void* count, void* stream) {
  if (n_seg < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long per_warp = C < 32 ? 32 / C : 1;
  const long long warps = (n_seg + per_warp - 1) / per_warp;
  long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  segment_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      src, perm, offsets, out, n_seg, C,
      static_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
