// Batched small symmetric eigensolver and SVD for Hopper (sm_90a), plain C
// interface: LOBPCG's dense linear algebra inside MAC's Woodbury tier.
//
// Replaces no TPU kernel. It replaces library calls of the port's LOBPCG
// (cslam_tpu_torch/ops/lobpcg.py, a translation of JAX's lobpcg_standard,
// which the JAX package compiles into its Frank-Wolfe while_loop):
//   * torch.linalg.eigh of the Rayleigh-Ritz matrix [3k, 3k] (12 x 12 at
//     block k = 4) and of SVQB's Gram matrices [k, k] (4 x 4), several
//     per LOBPCG iteration;
//   * torch.linalg.svd of the k x k top block in _extend_basis, once per
//     LOBPCG call.
// On the card both library calls read an error flag on the host after
// every call (cuSOLVER's info), so a loop that holds them can neither run
// without a host read per iteration nor be captured in a CUDA graph. These
// kernels make no host read: a matrix that does not converge within the
// sweep cap, or that holds a NaN or an infinity, gets NaN outputs, which
// the Frank-Wolfe loop turns into a failed selection on the host at its
// one read.
//
// Contract (the plain versions in ops/small_linalg.py are the library
// calls themselves):
//   eigh: A [batch, n, n] float32 symmetric, only its lower triangle read
//   (as torch.linalg.eigh), n <= 16. w [batch, n] eigenvalues DESCENDING;
//   V [batch, n, n] one eigenvector per column, each with its
//   largest-magnitude entry positive (the first such entry on a tie).
//   svd: A [batch, n, n] float32, n <= 16. U [batch, n, n], S [batch, n]
//   descending, Vh [batch, n, n], A = U diag(S) Vh; each right singular
//   vector (a row of Vh) has its largest-magnitude entry positive, its left
//   one following; a zero singular value's left vector is completed to an
//   orthonormal U.
//
// Design: Jacobi in float64 (the inputs are float32; the H100's FP64 rate
// makes double free at this size and leaves the results relatively
// accurate) in a parallel (round-robin) order, one warp per matrix. n <= 16
// is rounded up to an even N (odd n: one dummy index whose pairs never
// rotate) and each step of a sweep treats N/2 disjoint pairs at once, so a
// sweep is N - 1 steps in a row (3 at n = 4, 11 at n = 12) instead of the
// n(n - 1)/2 rotations of a cyclic order. The steps are unrolled over a
// compile-time N (one template per even size), so each lane's register
// arrays are indexed statically; no shared memory and no __syncwarp inside
// a sweep, and the build has --fmad=false, so that the mirrors in
// ops/small_linalg.py (eigh_jacobi_ref, svd_jacobi_ref: the same arithmetic
// in torch float64) equal the kernels bit for bit.
//   eigh: two-sided. Lane r keeps row r of A and of V; each rotation's
//   (c, s) is computed once, by the lane of the pair's lower index, and
//   broadcast by shuffle; the column updates are lane-local and the row
//   updates take the partner row by shuffle. It stops when the
//   off-diagonal norm is below 1e-13 of the Frobenius norm (each lane's
//   row summed in column order, the lanes in a shuffle tree).
//   svd: one-sided (Hestenes). Lane j keeps column j of A and of V. At a
//   step each lane takes its partner's columns by 2N independent shuffles,
//   forms alpha, beta, gamma (the pair's squared norms and dot product,
//   summed in row order; both lanes of a pair get the same bits, with the
//   pair's lower index first) and rotates its own columns: no reduction
//   across lanes at all. A pair is skipped where |gamma| <= 1e-15 n
//   sqrt(alpha beta); a sweep with no rotation anywhere (__any_sync) ends
//   the loop. Then each lane's singular value is its column's norm, its
//   place in the descending order comes from shuffles, and its left
//   vector is its column over that norm. A zero singular value's left
//   vector is completed to an orthonormal U by Gram-Schmidt on lane 0 in
//   shared memory (in the sorted order, a rare path).
// Both loops are capped at 40 sweeps.
//
// What bounds it on an H100 SXM: the chain of dependent steps, not the
// card's rates and not the launch. Its work is a few thousand flops per
// matrix and a few KB, but each step is a chain of shuffles, sums and
// (eigh) a broadcast, with a float64 division and square roots in the
// rotation, then N independent updates of a and v. A 12 x 12 eigh from
// LOBPCG takes 5-8 sweeps, 55-88 steps; the 4 x 4 SVD of its basis
// extension 3 steps per sweep against the 6 rotations in a row of a
// cyclic order. The loop around the kernels is replayed from
// CUDA graphs, so their launches cost about a microsecond each. A batch
// fills the card's SMs one warp per matrix, but LOBPCG's calls are batch
// 1.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 16;
constexpr int kWarps = 4;  // matrices per block
constexpr int kMaxSweeps = 40;
constexpr double kOffTol = 1e-26;  // squared: off-norm <= 1e-13 |A|_F

__device__ __forceinline__ double warp_sum(double x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stable Jacobi rotation (t = tan) that zeroes apq between app and aqq.
__device__ __forceinline__ double rotation_tan(double app, double aqq,
                                               double apq) {
  const double theta = (aqq - app) / (2.0 * apq);
  if (fabs(theta) > 1e150) return 0.5 / theta;
  return (theta >= 0.0 ? 1.0 : -1.0) /
         (fabs(theta) + sqrt(theta * theta + 1.0));
}

// Round-robin (circle) ordering of N indices, N even: step k (0 <= k <
// N - 1) pairs N - 1 with k, and (k - i) mod (N - 1) with (k + i) mod
// (N - 1) for i = 1 .. N/2 - 1. The N/2 pairs of a step are disjoint, and
// the N - 1 steps of a sweep meet every pair once. partner(k, j) is j's
// partner at step k.
__host__ __device__ constexpr int rr_partner(int N, int k, int j) {
  return j == N - 1 ? k : j == k ? N - 1 : (2 * k - j + (N - 1)) % (N - 1);
}

// Step K of a sweep in the lane that owns row `lane` of A (a, its diagonal
// entry also in d) and of V (v). Lanes >= N hold zeros and partner
// themselves. Each pair's rotation is computed once, by the lane of its
// lower index p (a_qq by shuffle from lane q), and broadcast by shuffle;
// a pair that holds the dummy index (n odd, index n) or has a_pq == 0
// gets the identity (t = 0). With alpha_j, beta_j the coefficients of
// column j and of its partner column jb in the rotated column j (p: c and
// -s; q: c and s), row r and its partner row rb mix the same way, and
// every new entry is
//   A'[r][j] = (alpha_r alpha_j A[r][j] + beta_r beta_j A[rb][jb])
//            + (alpha_r beta_j A[r][jb] + beta_r alpha_j A[rb][j]),
// summed in that order, so that A' is exactly as symmetric as A (the
// build has --fmad=false). Then each pair's diagonal gets the usual
// a_pp - t a_pq, a_qq + t a_pq and its a_pq, a_qp exact zeros. V' = V J is
// lane-local. ops/small_linalg.eigh_jacobi_ref does the same arithmetic.
template <int N, int K>
__device__ __forceinline__ void jacobi_step(int lane, int n, double (&a)[N],
                                            double (&v)[N], double& d) {
  constexpr int M = N - 1;
  const int q = lane >= N ? lane : rr_partner(N, K, lane);
  const bool low = lane < q;  // this lane owns the pair's row p
  double apq = 0.0;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j == q) apq = a[j];
  const double aqq = __shfl_sync(0xffffffffu, d, q);
  double t = 0.0;
  if (low && q < n && apq != 0.0) t = rotation_tan(d, aqq, apq);
  const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
  const int lo = low ? lane : q;
  const double tm = __shfl_sync(0xffffffffu, t, lo);
  const double cm = __shfl_sync(0xffffffffu, c, lo);
  const double sm = __shfl_sync(0xffffffffu, s, lo);
  const double ar = cm, br = low ? -sm : sm;
  double na[N], nv[N];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int x = i == 0 ? K : (K - i + M) % M;
    const int y = i == 0 ? M : (K + i) % M;
    const int pp = x < y ? x : y, qq = x < y ? y : x;
    const double cp = __shfl_sync(0xffffffffu, c, pp);
    const double sp = __shfl_sync(0xffffffffu, s, pp);
    const double bp = __shfl_sync(0xffffffffu, a[pp], q);
    const double bq = __shfl_sync(0xffffffffu, a[qq], q);
    // column pp: alpha cp, beta -sp, partner qq
    na[pp] = ((ar * cp) * a[pp] + (br * -sp) * bq) +
             ((ar * -sp) * a[qq] + (br * cp) * bp);
    // column qq: alpha cp, beta sp, partner pp
    na[qq] = ((ar * cp) * a[qq] + (br * sp) * bp) +
             ((ar * sp) * a[pp] + (br * cp) * bq);
    nv[pp] = cp * v[pp] + -sp * v[qq];
    nv[qq] = cp * v[qq] + sp * v[pp];
  }
  const double dn = low ? d - tm * apq : d + tm * apq;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    a[j] = j == lane ? dn : j == q ? 0.0 : na[j];
    v[j] = nv[j];
  }
  d = dn;
}

template <int N, int K = 0>
__device__ __forceinline__ void jacobi_sweep(int lane, int n, double (&a)[N],
                                             double (&v)[N], double& d) {
  if constexpr (K < N - 1) {
    jacobi_step<N, K>(lane, n, a, v, d);
    jacobi_sweep<N, K + 1>(lane, n, a, v, d);
  }
}

// One warp per matrix; n <= N = n rounded up to even. Lane r holds row r
// of A and of V in registers (indexed statically: the steps are unrolled
// over the compile-time N).
template <int N>
__global__ void __launch_bounds__(32 * kWarps)
    eigh_kernel(const float* __restrict__ A, float* __restrict__ w,
                float* __restrict__ V, int batch, int n,
                unsigned long long* count) {
  if (count != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(count, 1ull);
  __shared__ double sv[kWarps][N][N + 1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= batch) return;  // the whole warp leaves together
  const float* Ab = A + static_cast<size_t>(b) * n * n;

  double a[N], v[N];
  bool finite = true;
  double fro = 0.0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float x = 0.0f;
    if (lane < n && j < n)
      x = lane >= j ? Ab[lane * n + j] : Ab[j * n + lane];
    finite = finite && isfinite(x);
    a[j] = x;
    v[j] = lane == j ? 1.0 : 0.0;
    fro += a[j] * a[j];
  }
  finite = __all_sync(0xffffffffu, finite);
  fro = warp_sum(fro);
  double d = 0.0;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j == lane) d = a[j];

  bool converged = false;
  for (int sweep = 0; finite && sweep < kMaxSweeps; ++sweep) {
    double off = 0.0;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j != lane) off += a[j] * a[j];
    if (warp_sum(off) <= kOffTol * fro) {
      converged = true;
      break;
    }
    jacobi_sweep<N>(lane, n, a, v, d);
  }

  float* wb = w + static_cast<size_t>(b) * n;
  float* Vb = V + static_cast<size_t>(b) * n * n;
  if (!converged) {
    for (int idx = lane; idx < n * n; idx += 32) Vb[idx] = nanf("");
    if (lane < n) wb[lane] = nanf("");
    return;
  }
  double(*sm)[N + 1] = sv[warp];
  if (lane < N) {
#pragma unroll
    for (int j = 0; j < N; ++j) sm[lane][j] = v[j];
  }
  // this lane's eigenvalue's place: descending, ties by ascending index
  int rank = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const double dj = __shfl_sync(0xffffffffu, d, j);
    if (j < n && (dj > d || (dj == d && j < lane))) ++rank;
  }
  __syncwarp();
  if (lane < n) {
    // column `lane` of V, its largest-magnitude entry (the first on a tie)
    // made positive
    int imax = 0;
    for (int i = 1; i < n; ++i)
      if (fabs(sm[i][lane]) > fabs(sm[imax][lane])) imax = i;
    const double sign = sm[imax][lane] < 0.0 ? -1.0 : 1.0;
    wb[rank] = static_cast<float>(d);
    for (int i = 0; i < n; ++i)
      Vb[i * n + rank] = static_cast<float>(sign * sm[i][lane]);
  }
}

// Step K of a sweep of the one-sided Jacobi SVD in the lane that owns
// column `lane` of A (a) and of V (v). Lanes >= N hold zeros and partner
// themselves. The lane takes its partner's columns by shuffle (all lanes
// shuffle, outside any branch), sums alpha = |x|^2, beta = |y|^2 and gamma
// = x . y in row order, and names the pair's squared norms with its lower
// index first (app, aqq), so both lanes of a pair hold the same bits and
// take the same decision and rotation. A pair that holds a zero column
// (the dummy index n of an odd n, or a zero column of A) has gamma == 0
// and is skipped. Each lane's new column is c x + sg y, sg = -s in the
// lower lane and s in the upper one (x_p' = c x_p - s x_q, x_q' = s x_p +
// c x_q). ops/small_linalg.svd_jacobi_ref does the same arithmetic.
template <int N, int K>
__device__ __forceinline__ void svd_step(int lane, int n, double (&a)[N],
                                         double (&v)[N], bool& rotated) {
  const int q = lane >= N ? lane : rr_partner(N, K, lane);
  const bool low = lane < q;
  double y[N], w[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    y[i] = __shfl_sync(0xffffffffu, a[i], q);
    w[i] = __shfl_sync(0xffffffffu, v[i], q);
  }
  double sx = 0.0, sy = 0.0, gamma = 0.0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    sx += a[i] * a[i];
    sy += y[i] * y[i];
    gamma += a[i] * y[i];
  }
  const double app = low ? sx : sy, aqq = low ? sy : sx;
  if (fabs(gamma) <= 1e-15 * n * sqrt(app * aqq) || gamma == 0.0) return;
  rotated = true;
  const double t = rotation_tan(app, aqq, gamma);
  const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
  const double sg = low ? -s : s;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a[i] = c * a[i] + sg * y[i];
    v[i] = c * v[i] + sg * w[i];
  }
}

template <int N, int K = 0>
__device__ __forceinline__ void svd_sweep(int lane, int n, double (&a)[N],
                                          double (&v)[N], bool& rotated) {
  if constexpr (K < N - 1) {
    svd_step<N, K>(lane, n, a, v, rotated);
    svd_sweep<N, K + 1>(lane, n, a, v, rotated);
  }
}

// Lane 0 of a warp whose singular values (sigma, by column) include a
// zero: the left vectors (u, one per column, rows 0 .. n - 1) in the
// sorted order (order[jj] = the column of the jj-th largest), each zero
// one replaced by the first unit vector e that Gram-Schmidt (two passes
// against every earlier column, then its norm) leaves with a norm above
// 0.5, normalized. ops/small_linalg.svd_jacobi_ref repeats it.
template <int N>
__device__ __forceinline__ void complete_basis(double (*u)[N + 1],
                                               const double* sigma,
                                               const int* order, int n) {
  for (int jj = 0; jj < n; ++jj) {
    const int j = order[jj];
    if (sigma[j] > 0.0) continue;
    for (int e = 0; e < n; ++e) {
      for (int i = 0; i < n; ++i) u[i][j] = i == e ? 1.0 : 0.0;
      for (int pass = 0; pass < 2; ++pass) {
        for (int kk = 0; kk < jj; ++kk) {
          const int k = order[kk];
          double d = 0.0;
          for (int i = 0; i < n; ++i) d += u[i][k] * u[i][j];
          for (int i = 0; i < n; ++i) u[i][j] -= d * u[i][k];
        }
      }
      double norm = 0.0;
      for (int i = 0; i < n; ++i) norm += u[i][j] * u[i][j];
      norm = sqrt(norm);
      if (norm > 0.5) {
        for (int i = 0; i < n; ++i) u[i][j] /= norm;
        break;
      }
    }
  }
}

// One warp per matrix; n <= N = n rounded up to even. Lane j holds column
// j of A and of V in registers (indexed statically: the steps are unrolled
// over the compile-time N).
template <int N>
__global__ void __launch_bounds__(32 * kWarps)
    svd_kernel(const float* __restrict__ A, float* __restrict__ U,
               float* __restrict__ S, float* __restrict__ Vh, int batch,
               int n, unsigned long long* count) {
  if (count != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(count, 1ull);
  __shared__ double su[kWarps][N][N + 1];
  __shared__ double ss[kWarps][N];
  __shared__ int so[kWarps][N];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= batch) return;  // the whole warp leaves together
  const float* Ab = A + static_cast<size_t>(b) * n * n;

  double a[N], v[N];
  bool finite = true;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = 0.0f;
    if (lane < n && i < n) x = Ab[i * n + lane];
    finite = finite && isfinite(x);
    a[i] = x;
    v[i] = i == lane ? 1.0 : 0.0;
  }
  finite = __all_sync(0xffffffffu, finite);

  bool converged = false;
  for (int sweep = 0; finite && sweep < kMaxSweeps; ++sweep) {
    bool rotated = false;
    svd_sweep<N>(lane, n, a, v, rotated);
    if (!__any_sync(0xffffffffu, rotated)) {
      converged = true;
      break;
    }
  }

  float* Ub = U + static_cast<size_t>(b) * n * n;
  float* Sb = S + static_cast<size_t>(b) * n;
  float* Vhb = Vh + static_cast<size_t>(b) * n * n;
  if (!converged) {
    for (int idx = lane; idx < n * n; idx += 32) {
      Ub[idx] = nanf("");
      Vhb[idx] = nanf("");
    }
    if (lane < n) Sb[lane] = nanf("");
    return;
  }
  double sq = 0.0;
#pragma unroll
  for (int i = 0; i < N; ++i) sq += a[i] * a[i];
  const double sigma = sqrt(sq);
  // this lane's singular value's place: descending, ties by ascending index
  int rank = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const double sj = __shfl_sync(0xffffffffu, sigma, j);
    if (j < n && (sj > sigma || (sj == sigma && j < lane))) ++rank;
  }
  double u[N];
#pragma unroll
  for (int i = 0; i < N; ++i) u[i] = sigma > 0.0 ? a[i] / sigma : 0.0;
  if (__any_sync(0xffffffffu, lane < n && sigma == 0.0)) {
    if (lane < N) {
#pragma unroll
      for (int i = 0; i < N; ++i) su[warp][i][lane] = u[i];
    }
    if (lane < n) {
      ss[warp][lane] = sigma;
      so[warp][rank] = lane;
    }
    __syncwarp();
    if (lane == 0) complete_basis<N>(su[warp], ss[warp], so[warp], n);
    __syncwarp();
    if (lane < N) {
#pragma unroll
      for (int i = 0; i < N; ++i) u[i] = su[warp][i][lane];
    }
  }
  if (lane < n) {
    // the right vector (column `lane` of V) with its largest-magnitude
    // entry (the first on a tie) made positive; the left one follows
    double vmax = v[0];
#pragma unroll
    for (int i = 1; i < N; ++i)
      if (i < n && fabs(v[i]) > fabs(vmax)) vmax = v[i];
    const double sign = vmax < 0.0 ? -1.0 : 1.0;
    Sb[rank] = static_cast<float>(sigma);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < n) {
        Vhb[rank * n + i] = static_cast<float>(sign * v[i]);
        Ub[i * n + rank] = static_cast<float>(sign * u[i]);
      }
    }
  }
}

int blocks_for(int batch) { return (batch + kWarps - 1) / kWarps; }
int threads_for(int batch) { return 32 * (batch < kWarps ? batch : kWarps); }

}  // namespace

extern "C" {

// A: [batch, n, n] float32 (lower triangle read). w: [batch, n]; V: [batch,
// n, n]. count: nullptr or a device int64 that the launch adds one to when
// it runs (a launch replayed from a CUDA graph counts there too). Returns
// cudaGetLastError() after the launch.
int cslam_small_eigh(const float* A, float* w, float* V, int batch, int n,
                     void* count, void* stream) {
  if (batch < 1 || n < 1 || n > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks_for(batch)), block(threads_for(batch));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* c = static_cast<unsigned long long*>(count);
  switch (n + (n & 1)) {  // odd n: one dummy index
    case 2: eigh_kernel<2><<<grid, block, 0, st>>>(A, w, V, batch, n, c); break;
    case 4: eigh_kernel<4><<<grid, block, 0, st>>>(A, w, V, batch, n, c); break;
    case 6: eigh_kernel<6><<<grid, block, 0, st>>>(A, w, V, batch, n, c); break;
    case 8: eigh_kernel<8><<<grid, block, 0, st>>>(A, w, V, batch, n, c); break;
    case 10: eigh_kernel<10><<<grid, block, 0, st>>>(A, w, V, batch, n, c); break;
    case 12: eigh_kernel<12><<<grid, block, 0, st>>>(A, w, V, batch, n, c); break;
    case 14: eigh_kernel<14><<<grid, block, 0, st>>>(A, w, V, batch, n, c); break;
    default: eigh_kernel<16><<<grid, block, 0, st>>>(A, w, V, batch, n, c); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// A: [batch, n, n] float32. U, Vh: [batch, n, n]; S: [batch, n]. count:
// as cslam_small_eigh's. Returns cudaGetLastError() after the launch.
int cslam_small_svd(const float* A, float* U, float* S, float* Vh, int batch,
                    int n, void* count, void* stream) {
  if (batch < 1 || n < 1 || n > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks_for(batch)), block(threads_for(batch));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* c = static_cast<unsigned long long*>(count);
  switch (n + (n & 1)) {  // odd n: one dummy column
    case 2: svd_kernel<2><<<grid, block, 0, st>>>(A, U, S, Vh, batch, n, c); break;
    case 4: svd_kernel<4><<<grid, block, 0, st>>>(A, U, S, Vh, batch, n, c); break;
    case 6: svd_kernel<6><<<grid, block, 0, st>>>(A, U, S, Vh, batch, n, c); break;
    case 8: svd_kernel<8><<<grid, block, 0, st>>>(A, U, S, Vh, batch, n, c); break;
    case 10: svd_kernel<10><<<grid, block, 0, st>>>(A, U, S, Vh, batch, n, c); break;
    case 12: svd_kernel<12><<<grid, block, 0, st>>>(A, U, S, Vh, batch, n, c); break;
    case 14: svd_kernel<14><<<grid, block, 0, st>>>(A, U, S, Vh, batch, n, c); break;
    default: svd_kernel<16><<<grid, block, 0, st>>>(A, U, S, Vh, batch, n, c); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
