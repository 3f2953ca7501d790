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
// Design: cyclic Jacobi in float64 (the inputs are float32; the H100's
// FP64 rate makes double free at this size and leaves the eigenvalues
// relatively accurate), one warp per matrix, the matrix and the rotations
// in shared memory: eigh rotates rows and columns two sided, lane r owning
// row r; the SVD is one-sided (Hestenes): lane r owns row r, and each pair
// of columns is orthogonalized from three warp-shuffle sums. The
// convergence test (off-diagonal norm below 1e-13 of the Frobenius norm;
// for the SVD a sweep without a rotation) runs inside the kernel, capped
// at 40 sweeps.
//
// What bounds it on an H100 SXM: the serial chain of rotations, not the
// card's rates and not the launch. Its work is a few thousand flops per
// matrix and a few KB, but a 12 x 12 matrix takes 6-8 sweeps of 66
// rotations applied one after another, and each rotation is a chain of
// dependent float64 divisions and square roots (which every lane
// recomputes), shared-memory round trips and two __syncwarp()s, built
// with --fmad=false. chip_smoke.py measures 0.218 ms of device time per
// 12 x 12 call on an H100 80GB HBM3 at 700 W, about 0.4 us per rotation;
// the 4 x 4 call takes 0.017 ms. The loop around the kernel is replayed
// from CUDA graphs, so its launches cost about a microsecond each. A
// batch fills the card's SMs one warp per matrix, but LOBPCG's calls are
// batch 1. The design that would shorten the chain (ROADMAP item 28): a
// parallel round-robin ordering, n/2 disjoint rotations per step, one
// lane pair each, with each rotation's parameters computed once and
// broadcast by shuffle: n - 1 steps per sweep instead of n(n - 1)/2
// rotations.
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

// order[j] = index of the j-th largest key (ties by ascending index).
__device__ void sort_descending(const double* key, int n, int* order) {
  for (int j = 0; j < n; ++j) order[j] = j;
  for (int j = 0; j < n; ++j) {
    int best = j;
    for (int i = j + 1; i < n; ++i) {
      const double a = key[order[i]], b = key[order[best]];
      if (a > b || (a == b && order[i] < order[best])) best = i;
    }
    const int t = order[j];
    order[j] = order[best];
    order[best] = t;
  }
}

// -1 or +1: the sign that makes column c of m (n rows) have its
// largest-magnitude entry positive.
__device__ double column_sign(double (*m)[kMaxN + 1], int n, int c) {
  int imax = 0;
  for (int i = 1; i < n; ++i)
    if (fabs(m[i][c]) > fabs(m[imax][c])) imax = i;
  return m[imax][c] < 0.0 ? -1.0 : 1.0;
}

__global__ void eigh_kernel(const float* __restrict__ A, float* __restrict__ w,
                            float* __restrict__ V, int batch, int n,
                            unsigned long long* count) {
  if (count != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(count, 1ull);
  __shared__ double sa[kWarps][kMaxN][kMaxN + 1];
  __shared__ double sv[kWarps][kMaxN][kMaxN + 1];
  __shared__ double sd[kWarps][kMaxN];
  __shared__ int so[kWarps][kMaxN];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= batch) return;  // the whole warp leaves together
  double(*a)[kMaxN + 1] = sa[warp];
  double(*v)[kMaxN + 1] = sv[warp];
  const float* Ab = A + static_cast<size_t>(b) * n * n;

  bool finite = true;
  double fro = 0.0;
  for (int idx = lane; idx < n * n; idx += 32) {
    const int i = idx / n, j = idx % n;
    const float x = i >= j ? Ab[i * n + j] : Ab[j * n + i];
    finite = finite && isfinite(x);
    a[i][j] = x;
    v[i][j] = i == j ? 1.0 : 0.0;
    fro += static_cast<double>(x) * x;
  }
  finite = __all_sync(0xffffffffu, finite);
  fro = warp_sum(fro);
  __syncwarp();

  bool converged = false;
  for (int sweep = 0; finite && sweep < kMaxSweeps; ++sweep) {
    double off = 0.0;
    for (int idx = lane; idx < n * n; idx += 32) {
      const int i = idx / n, j = idx % n;
      if (i != j) off += a[i][j] * a[i][j];
    }
    if (warp_sum(off) <= kOffTol * fro) {
      converged = true;
      break;
    }
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        const double apq = a[p][q];
        if (apq == 0.0) continue;  // the same shared value in every lane
        const double app = a[p][p], aqq = a[q][q];
        const double t = rotation_tan(app, aqq, apq);
        const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
        double arp = 0.0, arq = 0.0, vrp = 0.0, vrq = 0.0;
        if (lane < n) {
          arp = a[lane][p];
          arq = a[lane][q];
          vrp = v[lane][p];
          vrq = v[lane][q];
        }
        __syncwarp();
        if (lane < n) {
          if (lane != p && lane != q) {
            const double np = c * arp - s * arq, nq = s * arp + c * arq;
            a[lane][p] = np;
            a[p][lane] = np;
            a[lane][q] = nq;
            a[q][lane] = nq;
          }
          v[lane][p] = c * vrp - s * vrq;
          v[lane][q] = s * vrp + c * vrq;
        }
        if (lane == 0) {
          a[p][p] = app - t * apq;
          a[q][q] = aqq + t * apq;
          a[p][q] = 0.0;
          a[q][p] = 0.0;
        }
        __syncwarp();
      }
    }
  }

  float* wb = w + static_cast<size_t>(b) * n;
  float* Vb = V + static_cast<size_t>(b) * n * n;
  if (!converged) {
    for (int idx = lane; idx < n * n; idx += 32) Vb[idx] = nanf("");
    if (lane < n) wb[lane] = nanf("");
    return;
  }
  if (lane < n) sd[warp][lane] = a[lane][lane];
  __syncwarp();
  if (lane == 0) sort_descending(sd[warp], n, so[warp]);
  __syncwarp();
  if (lane < n) {
    const int c = so[warp][lane];
    wb[lane] = static_cast<float>(sd[warp][c]);
    const double sign = column_sign(v, n, c);
    for (int i = 0; i < n; ++i)
      Vb[i * n + lane] = static_cast<float>(sign * v[i][c]);
  }
}

__global__ void svd_kernel(const float* __restrict__ A, float* __restrict__ U,
                           float* __restrict__ S, float* __restrict__ Vh,
                           int batch, int n, unsigned long long* count) {
  if (count != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(count, 1ull);
  __shared__ double sa[kWarps][kMaxN][kMaxN + 1];
  __shared__ double sv[kWarps][kMaxN][kMaxN + 1];
  __shared__ double ss[kWarps][kMaxN];
  __shared__ int so[kWarps][kMaxN];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= batch) return;
  double(*a)[kMaxN + 1] = sa[warp];
  double(*v)[kMaxN + 1] = sv[warp];
  const float* Ab = A + static_cast<size_t>(b) * n * n;

  bool finite = true;
  for (int idx = lane; idx < n * n; idx += 32) {
    const int i = idx / n, j = idx % n;
    const float x = Ab[idx];
    finite = finite && isfinite(x);
    a[i][j] = x;
    v[i][j] = i == j ? 1.0 : 0.0;
  }
  finite = __all_sync(0xffffffffu, finite);
  __syncwarp();

  // lane r owns row r of a and of v: no lane reads another's row until the
  // sweep ends
  bool converged = false;
  for (int sweep = 0; finite && sweep < kMaxSweeps; ++sweep) {
    bool rotated = false;
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        const double x = lane < n ? a[lane][p] : 0.0;
        const double y = lane < n ? a[lane][q] : 0.0;
        const double alpha = warp_sum(x * x), beta = warp_sum(y * y);
        const double gamma = warp_sum(x * y);
        if (fabs(gamma) <= 1e-15 * n * sqrt(alpha * beta) || gamma == 0.0)
          continue;  // the same sums in every lane
        rotated = true;
        const double t = rotation_tan(alpha, beta, gamma);
        const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
        if (lane < n) {
          a[lane][p] = c * x - s * y;
          a[lane][q] = s * x + c * y;
          const double vp = v[lane][p], vq = v[lane][q];
          v[lane][p] = c * vp - s * vq;
          v[lane][q] = s * vp + c * vq;
        }
      }
    }
    if (!rotated) {
      converged = true;
      break;
    }
  }
  __syncwarp();

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
  for (int j = 0; j < n; ++j) {
    const double x = lane < n ? a[lane][j] : 0.0;
    const double norm = sqrt(warp_sum(x * x));
    if (lane == 0) ss[warp][j] = norm;
  }
  __syncwarp();
  if (lane == 0) {
    sort_descending(ss[warp], n, so[warp]);
    // left vectors: a's columns scaled to unit length; a zero column is
    // completed by Gram-Schmidt from the unit vectors (in the sorted
    // order, so the completed columns come last)
    for (int jj = 0; jj < n; ++jj) {
      const int j = so[warp][jj];
      const double sigma = ss[warp][j];
      if (sigma > 0.0) {
        for (int i = 0; i < n; ++i) a[i][j] /= sigma;
        continue;
      }
      for (int e = 0; e < n; ++e) {
        for (int i = 0; i < n; ++i) a[i][j] = i == e ? 1.0 : 0.0;
        for (int pass = 0; pass < 2; ++pass) {
          for (int kk = 0; kk < jj; ++kk) {
            const int k = so[warp][kk];
            double d = 0.0;
            for (int i = 0; i < n; ++i) d += a[i][k] * a[i][j];
            for (int i = 0; i < n; ++i) a[i][j] -= d * a[i][k];
          }
        }
        double norm = 0.0;
        for (int i = 0; i < n; ++i) norm += a[i][j] * a[i][j];
        norm = sqrt(norm);
        if (norm > 0.5) {
          for (int i = 0; i < n; ++i) a[i][j] /= norm;
          break;
        }
      }
    }
  }
  __syncwarp();
  if (lane < n) {
    const int c = so[warp][lane];
    Sb[lane] = static_cast<float>(ss[warp][c]);
    const double sign = column_sign(v, n, c);
    for (int i = 0; i < n; ++i) {
      Vhb[lane * n + i] = static_cast<float>(sign * v[i][c]);
      Ub[i * n + lane] = static_cast<float>(sign * a[i][c]);
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
  eigh_kernel<<<blocks_for(batch), threads_for(batch), 0,
                static_cast<cudaStream_t>(stream)>>>(
      A, w, V, batch, n, static_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}

// A: [batch, n, n] float32. U, Vh: [batch, n, n]; S: [batch, n]. count:
// as cslam_small_eigh's. Returns cudaGetLastError() after the launch.
int cslam_small_svd(const float* A, float* U, float* S, float* Vh, int batch,
                    int n, void* count, void* stream) {
  if (batch < 1 || n < 1 || n > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  svd_kernel<<<blocks_for(batch), threads_for(batch), 0,
               static_cast<cudaStream_t>(stream)>>>(
      A, U, S, Vh, batch, n, static_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
