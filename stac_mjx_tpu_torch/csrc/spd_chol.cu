// Batched damped SPD solve for Hopper (sm_90a): x_f = (A_f + lam_f I)^-1 g_f.
//
// Replaces the TPU kernel stac_mjx_tpu/ops/spd.py::_chol_solve_kernel (the
// Pallas batched Cholesky that every Levenberg-Marquardt iteration of the
// lockstep pose solve runs). Same arithmetic: lam added to the diagonal on
// the on-chip copy of A, right-looking Cholesky with an rsqrt pivot, forward
// substitution fused into the factor loop, back substitution on the factor.
// No pivoting and no failure flag: a non-positive pivot makes rsqrt return
// NaN (or inf * 0 = NaN for a zero pivot), the NaN spreads to x, and the LM
// accept test (f_new < f_x is false for NaN) rejects that step, exactly as
// with the TPU kernel.
//
// What bounds it on an H100: the n-step dependency chain of the factor (each
// column needs the previous column's Schur update) and the barrier latency
// between steps, not bytes. At F = 10,000 systems of n = 37, A is 55 MB in
// f32, which the card reads in about 16 us at 3.35 TB/s; the chain is ~4n
// barriers per system.
//
// Design: one CTA per system, A kept in shared memory for the whole solve
// (n*n + 2n floats: 5.6 KB at n = 37, 21.6 KB at n = 73). The TPU kernel put
// 128 frames in the vector lanes to amortise its sequential chain; here the
// chains of different systems run concurrently in different CTAs instead.
// With 128 threads and a few KB of shared memory per CTA an SM holds 16 CTAs,
// so 132 SMs run ~2,100 systems at once: the path's F (10,000 frames on the
// fine ik pass, 1,250 on the coarse pass, 40 on the root batch) fills the
// card in a few waves, and each SM always has several independent chains to
// switch between while one waits at a barrier. Threads split each column's
// scaling, the trailing (lower-triangle) Schur update, and each back
// substitution step. Batching several systems per CTA, wgmma and TMA are
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxN = 96;  // (n*n + 2n) floats stay under the 48 KB default

__global__ void __launch_bounds__(kThreads)
spd_chol_solve_kernel(const float* __restrict__ A, const float* __restrict__ g,
                      const float* __restrict__ lam, float* __restrict__ x,
                      int n) {
  extern __shared__ float smem[];
  float* a = smem;        // n*n, row-major; the lower triangle becomes L
  float* y = a + n * n;   // right-hand side, then the forward solution
  float* xs = y + n;      // back-substitution result
  const int tid = threadIdx.x;
  const size_t f = blockIdx.x;
  const float* Af = A + f * n * n;
  const float lam_f = lam ? lam[f] : 0.0f;

  // Load A (coalesced) with lam on the diagonal: row-major diagonal entries
  // sit at multiples of n + 1.
  for (int i = tid; i < n * n; i += kThreads) {
    float v = Af[i];
    if (i % (n + 1) == 0) v += lam_f;
    a[i] = v;
  }
  for (int i = tid; i < n; i += kThreads) y[i] = g[f * n + i];
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    // Pivot. Every thread reads a[j][j] and y[j] (final after the previous
    // column's update) before the barrier; row j is then rewritten.
    const float d = a[j * n + j];
    const float rinv = rsqrtf(d);
    const float sd = d * rinv;  // sqrt(d); NaN when d <= 0
    const float yj = y[j] / sd;
    __syncthreads();
    // Column j of L, and fold y_j into the remaining right-hand side.
    for (int r = j + tid; r < n; r += kThreads) {
      if (r == j) {
        a[j * n + j] = sd;
        y[j] = yj;
      } else {
        const float l = a[r * n + j] * rinv;
        a[r * n + j] = l;
        y[r] -= l * yj;
      }
    }
    __syncthreads();
    // Rank-1 Schur update of the trailing lower triangle.
    const int m = n - j - 1;
    for (int idx = tid; idx < m * m; idx += kThreads) {
      const int r = j + 1 + idx / m;
      const int c = j + 1 + idx % m;
      if (c <= r) a[r * n + c] -= a[r * n + j] * a[c * n + j];
    }
    __syncthreads();
  }

  // Back substitution L^T x = y, column-oriented: once x_j is known, remove
  // its contribution L[j][i] x_j from every y_i with i < j.
  for (int j = n - 1; j >= 0; --j) {
    const float xj = y[j] / a[j * n + j];
    if (tid == 0) xs[j] = xj;
    for (int i = tid; i < j; i += kThreads) y[i] -= a[j * n + i] * xj;
    __syncthreads();
  }
  for (int i = tid; i < n; i += kThreads) x[f * n + i] = xs[i];
}

}  // namespace

extern "C" int spd_chol_max_n() { return kMaxN; }

// A (F, n, n), g (F, n), lam (F,) or null, x (F, n): f32, contiguous, on the
// device. Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int spd_chol_solve_f32(const float* A, const float* g,
                                  const float* lam_or_null, float* x, int F,
                                  int n, void* stream) {
  if (F == 0) return 0;
  if (F < 0 || n <= 0 || n > kMaxN) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(n * n + 2 * n) * sizeof(float);
  spd_chol_solve_kernel<<<F, kThreads, smem, (cudaStream_t)stream>>>(
      A, g, lam_or_null, x, n);
  return (int)cudaGetLastError();
}
