// Batched damped SPD solve for Hopper (sm_90a): x_f = (A_f + lam_f I)^-1 g_f.
//
// Replaces the TPU kernel stac_mjx_tpu/ops/spd.py::_chol_solve_kernel (the
// Pallas batched Cholesky that every Levenberg-Marquardt iteration of the
// lockstep pose solve runs). Same arithmetic: lam added to the diagonal on
// chip, right-looking Cholesky with an rsqrt pivot, forward substitution
// fused into the factor loop, back substitution on L^T. The substitutions
// multiply by the pivot's rsqrt where the TPU kernel divides by its square
// root (the same quotient to rounding). No pivoting and no failure flag: a
// non-positive pivot makes rsqrtf return NaN (inf for a zero pivot, whose
// products with the column are inf or NaN), the non-finite values spread to
// that system's x and to no other system's, and the LM accept test
// (f_new < f_x is false for NaN) rejects the step, as with the TPU kernel.
// Built without --use_fast_math, so rsqrtf keeps that behaviour.
//
// What bounds it on an H100, per system of size n: it must read the lower
// triangle of A plus g and lam and write x (3,112 B at n = 37), and do
// ~n^3/3 + 2n^2 flops: 3.4 flop per byte, far below the card's ~20 flop per
// byte fp32 balance, so device memory is the roofline. On the main path:
//  - F >= 1,250 (the ik's coarse and fine passes): memory and, in practice,
//    instruction issue: 10,000 systems at n = 37 are 31 MB, 9.3 us at
//    3.35 TB/s, while the column loop issues ~10^2 warp instructions per
//    column per system.
//  - F <= 250 (the fit's pose passes, the ik's root batch, the flat-LM root
//    solve): the latency of one system's chain of n dependent columns.
//
// Design: one warp per system, kWarps systems per CTA, no CTA barrier (a
// warp whose system index is >= F returns at once; the rest synchronise
// only within the warp, with shuffles and __syncwarp).
//  - Load: the warp copies the lower triangle of A_f into its own shared
//    memory with 4-byte cp.async: consecutive lanes read consecutive
//    addresses, so global reads coalesce, and no register carries the copy.
//    A system is n^2 * 4 bytes, not 16-byte aligned for odd n, so per-system
//    bulk (TMA) copies do not apply. Rows sit at a stride S >= n with S/4
//    odd, which keeps the float4 row reads free of bank conflicts. The warp
//    waits for its copy at once: the other resident warps (16 per SM at
//    n = 37, 8 at n = 73) overlap their loads with its factor. Overlap within
//    the warp was built and measured slower on an H100 80GB HBM3 at 700 W
//    (scripts/compare_spd_kernels.py, n = 37, F = 10,000): a persistent grid
//    whose warps stage the next system into a second area during the
//    factor took 0.0916 ms, the same grid without the second area 0.0901 ms,
//    and this kernel 0.0853 ms. With every warp starting at once the
//    persistent grid keeps their load and factor phases in step.
//  - Grid: one warp per system. The body sits in a grid-stride loop over
//    systems, which with this grid runs once per warp; on the same card the
//    loop form measured 4-5% faster at n = 37 (0.0847 against 0.0885 ms at
//    F = 10,000, 8.9 against 9.3 us at F <= 250) and 15% at n = 73,
//    F = 1,250 than the same body without the loop (same script).
//  - Factor in registers: lane l owns rows l, l + 32, l + 64 (R row blocks)
//    and holds each row's lower-triangle columns. The kernel is templated on
//    N, n rounded up to a multiple of 8; the runtime n guards the rest. The
//    register window shifts one column per step (a[k][0] is always column j),
//    so every register index is static while the column loop is a runtime
//    loop: the code stays small, builds in seconds and keeps A out of local
//    memory. Column step j: the pivot and y_j arrive by shuffle from their
//    owner lane, issued during the previous step's update (the owner of row
//    j + 1 computes its next diagonal from its own L[j + 1, j]), so the
//    chain per column is a shuffle, an rsqrt and a few FMAs; each lane scales
//    its L[i, j] and folds y_j into its y_i; the lanes write column j to a
//    double-buffered per-warp buffer (one __syncwarp per column) and read it
//    back as broadcast float4s, kBatch columns at a time, for the rank-1
//    update of their rows. Entries above the diagonal take junk updates that
//    are never read, so the update needs no per-row predicate.
//  - Back substitution, column-oriented: L's columns go to shared memory
//    during the factor; x_j goes from its owner to all lanes by one shuffle,
//    and each lane removes L[j, c] x_j from its y_c (conflict-free reads).
//  - No tensor cores: the solve is memory-bound at 3.4 flop per byte; TF32
//    mma/wgmma would break the 1e-4 relative bound against float64 that the
//    LM accept test needs, and wgmma's 64-row tiles do not fit n = 37.
//  - Registers: N = 80 (n = 73) holds 32 + 64 + 80 row entries per lane,
//    under the 255 limit without spills; chip_smoke.py prints ptxas'
//    registers and spills for every instantiation.
//
// n from 97 to 128 (spd_chol_wide_kernel, templated on P3 = 8, 16, 32): a
// fourth row block does not fit. At N = 104 the lane would hold
// 32 + 64 + 96 + 104 = 296 row entries, over the 255-register limit, and the
// lower triangle at n = 128 is 258 floats a lane even if spread evenly. So
// rows 0..95 stay in registers exactly as at N = 96 (the same shifting
// window, three row blocks), and rows 96..n-1 (at most 32) stay in shared
// memory, updated there in place:
//  - Shared memory per warp: rows 0..95 of the staged A packed by rows
//    (row i at i(i+1)/2, 4,656 floats), which take L's rows in place as
//    their owner computes them (only the owner touches a row until the back
//    substitution); rows 96..n-1 by columns, P3 rows a column at the odd
//    stride P3 + 1 (P3 = 8, 16 or 32, a power of two >= n - 96), so lanes
//    reading one column, or one row across columns, hit distinct banks; the
//    two column buffers. 23.4 KB a warp at n = 102, so two CTAs (eight
//    warps, the register limit at 255 a thread) share an SM; 36.6 KB at
//    n = 128. The square staging of N <= 96 would need 44-68 KB a warp.
//  - Column step j: lane r keeps row 96 + r's pivot-column entry, right-hand
//    side and next diagonal as a fourth row block, read from and written to
//    shared memory, so the pivot chain and look-ahead are those of N <= 96.
//    The rank-1 update of the shared rows is spread over the whole warp:
//    lane t updates row t mod P3 in every (32 / P3)-th column, so at n = 102
//    (six shared rows) a lane updates a quarter of the trailing columns
//    instead of all of them. One more __syncwarp per column publishes it.
//  - Batches of 8 columns in the register update (16 at N <= 96) keep the
//    batch's loads within the register budget the fourth block's scalars
//    take.
//  - Back substitution as at N <= 96, L's row j read from the packed rows or
//    the column-major block, both conflict-free across lanes.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // systems (one warp each) per CTA
constexpr int kMaxN = 96;   // the largest n with every row in registers
constexpr int kWideMaxN = 128;  // the largest n: rows past kMaxN in shared memory
constexpr int kBatch = 16;  // columns per guarded batch of the Schur update
constexpr unsigned kFull = 0xffffffffu;

// Row stride of the staged A in shared memory: >= n, a multiple of 4 (float4
// rows), and S/4 odd, so eight lanes reading float4s of eight different rows
// hit distinct bank groups.
__host__ __device__ constexpr int row_stride(int n) { return 4 * (((n + 3) / 4) | 1); }

// Columns of row block k held in registers (row i needs columns <= i).
__host__ __device__ constexpr int width(int N, int k) { return N < 32 * (k + 1) ? N : 32 * (k + 1); }

// Per-warp shared memory, in floats: the staged rows of A, later L's columns
// at the odd stride n | 1 (<= S + 1), then two column buffers of 32R + 4.
__host__ __device__ constexpr int stage_floats(int n) { return (n * (row_stride(n) + 1) + 3) / 4 * 4; }
__host__ __device__ constexpr int col_floats(int R) { return 32 * R + 4; }
__host__ __device__ constexpr int warp_floats(int n, int R) { return stage_floats(n) + 2 * col_floats(R); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Issues the copy of the lower triangle of one system (Af, n x n row-major)
// into s at row stride S: flat index t = r * n + c walks the matrix 32
// entries at a time, (r, c) kept without a division per step. Completes at
// the lane's next cp.async.wait_all.
__device__ __forceinline__ void stage_lower(float* s, const float* Af, int n, int S, int lane) {
  int r = lane / n, c = lane - (lane / n) * n;
  const int dr = 32 / n, dc = 32 - (32 / n) * n;
  for (int t = lane; t < n * n; t += 32) {
    if (c <= r) cp_async4(s + r * S + c, Af + t);
    c += dc;
    r += dr;
    if (c >= n) {
      c -= n;
      ++r;
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kWarps * 32)
spd_chol_warp_kernel(const float* __restrict__ A, const float* __restrict__ g,
                     const float* __restrict__ lam, float* __restrict__ x, int F,
                     int n) {
  constexpr int R = (N + 31) / 32;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long stride = (long)gridDim.x * kWarps;
  long f = (long)blockIdx.x * kWarps + warp;
  if (f >= F) return;
  const int S = row_stride(n);
  const int S2 = n | 1;  // odd stride of L's columns: conflict-free row reads
  float* s = smem + warp * warp_floats(n, R);
  float* cbuf = s + stage_floats(n);  // two buffers of col_floats(R)

  // 1. Stage the lower triangle of A_f.
  stage_lower(s, A + f * n * n, n, S, lane);
  for (; f < F; f += stride) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();

    // 2. Own rows into registers (row block k keeps its first width(k) columns),
    //    lam on the diagonal, right-hand side. Rows >= n are zero.
    const float lam_f = lam ? lam[f] : 0.0f;
    float a[R][N];
    float y[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = lane + 32 * k;
      y[k] = i < n ? g[f * n + i] : 0.0f;
      if (i < n) s[i * S + i] += lam_f;
#pragma unroll
      for (int c4 = 0; c4 < width(N, k); c4 += 4) {
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (i < n && c4 < n) v = *reinterpret_cast<const float4*>(s + i * S + c4);
        a[k][c4] = v.x;
        a[k][c4 + 1] = v.y;
        a[k][c4 + 2] = v.z;
        a[k][c4 + 3] = v.w;
      }
    }
    __syncwarp();  // the staged rows are read: the area now takes L by columns

    // 3. Right-looking factor, forward substitution folded in. The register
    //    window shifts by one column per step, so a[k][0] is always column j
    //    and every register index is static while j is a runtime loop.
    //    dv[k] is row i's diagonal at the next step: the owner of row j + 1
    //    computes it from its own L[j + 1, j], ahead of the Schur update, and
    //    the next pivot and y_{j+1} are shuffled before this step's FMAs, so
    //    their latency hides behind them. rinvk[k] = 1 / L[i, i] for row i.
    float dv[R], rinvk[R];
#pragma unroll
    for (int k = 0; k < R; ++k) rinvk[k] = 0.0f;
    float d = __shfl_sync(kFull, a[0][0], 0);
    float ynext = __shfl_sync(kFull, y[0], 0);
    for (int j = 0; j < n; ++j) {
      const float rinv = rsqrtf(d);  // NaN when d < 0, inf when d == 0
      const float yj = ynext * rinv;
      float* cb = cbuf + (j & 1) * col_floats(R);  // cb[c] = L[j + 1 + c, j]
      float* lj = s + j * S2;                      // lj[i] = L[i, j]
      float l[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {  // branch-free: selects and one predicated store
        const int i = lane + 32 * k;
        l[k] = a[k][0] * rinv;
        dv[k] = a[k][1] - l[k] * l[k];
        const float yk = y[k] - l[k] * yj;
        y[k] = i > j ? yk : (i == j ? yj : y[k]);
        rinvk[k] = i == j ? rinv : rinvk[k];
        cb[i > j ? i - j - 1 : col_floats(R) - 1] = l[k];  // rows <= j: a spare slot
        if (i < n) lj[i] = l[k];  // rows <= j land where L^T is never read
      }
      {  // look ahead: the pivot and right-hand side of step j + 1
        const int kn = (j + 1) >> 5;
        float dsel = dv[0], ysel = y[0];
#pragma unroll
        for (int k = 1; k < R; ++k) {
          if (kn == k) {
            dsel = dv[k];
            ysel = y[k];
          }
        }
        d = __shfl_sync(kFull, dsel, (j + 1) & 31);
        ynext = __shfl_sync(kFull, ysel, (j + 1) & 31);
      }
      __syncwarp();
      // Rank-1 update of the trailing columns, shifted into place:
      // a[i, j+1+c] -= L[i, j] L[j+1+c, j], kBatch columns per batch: a batch's
      // column reads issue together and its FMAs run unguarded (rows <= j and
      // columns >= n take junk that is never read); only whole batches past
      // the last column are skipped.
      const int rem = n - 1 - j;
#pragma unroll
      for (int b = 0; b < N; b += kBatch) {
        if (b < rem) {
          float lc[kBatch];
#pragma unroll
          for (int q = 0; q < kBatch / 4; ++q) {
            if (b + 4 * q < N) {
              const float4 v = *reinterpret_cast<const float4*>(cb + b + 4 * q);
              lc[4 * q] = v.x;
              lc[4 * q + 1] = v.y;
              lc[4 * q + 2] = v.z;
              lc[4 * q + 3] = v.w;
            }
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
#pragma unroll
            for (int k = 0; k < R; ++k) {
              const int c = b + u;
              if (c + 1 < width(N, k)) a[k][c] = a[k][c + 1] - l[k] * lc[u];
            }
          }
        }
      }
    }
    __syncwarp();

    // 4. Back substitution L^T x = y, column-oriented: once x_j is known,
    //    lane c removes L[j, c] x_j (column c of L, row j) from its y_c.
    for (int j = n - 1; j >= 0; --j) {
      const int kj = j >> 5;
      float xv = y[0] * rinvk[0];
#pragma unroll
      for (int k = 1; k < R; ++k) {
        if (kj == k) xv = y[k] * rinvk[k];
      }
      const float xj = __shfl_sync(kFull, xv, j & 31);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int c = lane + 32 * k;
        const float lcj = s[min(c, n - 1) * S2 + j];
        y[k] = c < j ? y[k] - lcj * xj : (c == j ? xj : y[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = lane + 32 * k;
      if (i < n) x[f * n + i] = y[k];
    }
    __syncwarp();  // L's columns are read: the area may take a system's rows
    if (f + stride < F) stage_lower(s, A + (f + stride) * n * n, n, S, lane);
  }
}

template <int N>
int launch(const float* A, const float* g, const float* lam, float* x, int F, int n,
           cudaStream_t stream) {
  constexpr int R = (N + 31) / 32;
  const size_t smem = sizeof(float) * kWarps * warp_floats(n, R);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        spd_chol_warp_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (F + kWarps - 1) / kWarps;
  spd_chol_warp_kernel<N><<<grid, kWarps * 32, smem, stream>>>(A, g, lam, x, F, n);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- n > 96

__host__ __device__ constexpr int tri(int i) { return i * (i + 1) / 2; }
// Per-warp shared memory, in floats (each part a multiple of 4): the packed
// rows 0..kMaxN-1, the column-major rows kMaxN..n-1 (P3 a column, n columns
// rounded up to 4), two column buffers.
__host__ __device__ constexpr int wide_cols(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ constexpr int wide_floats(int n, int P3) {
  return tri(kMaxN) + wide_cols(n) * (P3 + 1) + 2 * col_floats(4);
}
constexpr int kWideBatch = 8;  // columns per guarded batch of the register update

// The lower triangle of one system (n > kMaxN) into the packed rows P and
// the column-major block Q (row kMaxN + r of column c at Q[c * QS + r]).
template <int QS>
__device__ __forceinline__ void stage_wide(float* P, float* Q, const float* Af, int n, int lane) {
  int r = 0, c = lane;  // n > 32: t = lane is in row 0
  for (int t = lane; t < n * n; t += 32) {
    if (c <= r) cp_async4(r < kMaxN ? P + tri(r) + c : Q + c * QS + (r - kMaxN), Af + t);
    c += 32;
    if (c >= n) {
      c -= n;
      ++r;
    }
  }
}

template <int P3>  // rows a column of the shared block holds: a power of two >= n - kMaxN
__global__ void __launch_bounds__(kWarps * 32)
spd_chol_wide_kernel(const float* __restrict__ A, const float* __restrict__ g,
                     const float* __restrict__ lam, float* __restrict__ x, int F,
                     int n) {
  constexpr int R = 3;                 // register row blocks: rows 0..95
  constexpr int QS = P3 + 1;           // its odd column stride
  constexpr int G = 32 / P3;           // lanes sharing one shared row in the update
  constexpr int CB = col_floats(4);    // floats of one column buffer
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long stride = (long)gridDim.x * kWarps;
  long f = (long)blockIdx.x * kWarps + warp;
  if (f >= F) return;
  float* P = smem + warp * wide_floats(n, P3);
  float* Q = P + tri(kMaxN);
  float* cbuf = Q + wide_cols(n) * QS;
  const int i3 = kMaxN + lane;  // the shared row this lane owns (if < n)

  stage_wide<QS>(P, Q, A + f * n * n, n, lane);
  for (; f < F; f += stride) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();

    // Register rows as at N = 96 (every one < n), lam on each diagonal; the
    // owner of a shared row puts lam on its diagonal in place.
    const float lam_f = lam ? lam[f] : 0.0f;
    float a[R][kMaxN];
    float y[R + 1];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = lane + 32 * k;
      y[k] = g[f * n + i];
      P[tri(i) + i] += lam_f;
#pragma unroll
      for (int c = 0; c < width(kMaxN, k); ++c) a[k][c] = P[tri(i) + c];
    }
    y[R] = i3 < n ? g[f * n + i3] : 0.0f;
    if (i3 < n) Q[i3 * QS + lane] += lam_f;

    float dv[R + 1], rinvk[R + 1];
#pragma unroll
    for (int k = 0; k <= R; ++k) rinvk[k] = 0.0f;
    float d = __shfl_sync(kFull, a[0][0], 0);
    float ynext = __shfl_sync(kFull, y[0], 0);
    for (int j = 0; j < n; ++j) {
      const float rinv = rsqrtf(d);  // NaN when d < 0, inf when d == 0
      const float yj = ynext * rinv;
      float* cb = cbuf + (j & 1) * CB;  // cb[c] = L[j + 1 + c, j]
      float l[R + 1];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int i = lane + 32 * k;
        l[k] = a[k][0] * rinv;
        dv[k] = a[k][1] - l[k] * l[k];
        const float yk = y[k] - l[k] * yj;
        y[k] = i > j ? yk : (i == j ? yj : y[k]);
        rinvk[k] = i == j ? rinv : rinvk[k];
        cb[i > j ? i - j - 1 : CB - 1] = l[k];
        if (i >= j) P[tri(i) + j] = l[k];  // L's row i, in place of A's
      }
      {  // the shared row: its column-j entry in place, zero past n
        const float aj = i3 < n ? Q[j * QS + lane] : 0.0f;
        const float an = i3 < n && j + 1 < n ? Q[(j + 1) * QS + lane] : 0.0f;
        l[R] = aj * rinv;
        dv[R] = an - l[R] * l[R];
        const float yk = y[R] - l[R] * yj;
        y[R] = i3 > j ? yk : (i3 == j ? yj : y[R]);
        rinvk[R] = i3 == j ? rinv : rinvk[R];
        cb[i3 > j ? i3 - j - 1 : CB - 1] = l[R];
        if (i3 < n) Q[j * QS + lane] = l[R];
      }
      {  // look ahead: the pivot and right-hand side of step j + 1
        const int kn = (j + 1) >> 5;
        float dsel = dv[0], ysel = y[0];
#pragma unroll
        for (int k = 1; k <= R; ++k) {
          if (kn == k) {
            dsel = dv[k];
            ysel = y[k];
          }
        }
        d = __shfl_sync(kFull, dsel, (j + 1) & 31);
        ynext = __shfl_sync(kFull, ysel, (j + 1) & 31);
      }
      __syncwarp();
      // Rank-1 update of the register rows, as at N <= 96.
      const int rem = n - 1 - j;
#pragma unroll
      for (int b = 0; b < kMaxN; b += kWideBatch) {
        if (b < rem) {
          float lc[kWideBatch];
#pragma unroll
          for (int q = 0; q < kWideBatch / 4; ++q) {
            const float4 v = *reinterpret_cast<const float4*>(cb + b + 4 * q);
            lc[4 * q] = v.x;
            lc[4 * q + 1] = v.y;
            lc[4 * q + 2] = v.z;
            lc[4 * q + 3] = v.w;
          }
#pragma unroll
          for (int u = 0; u < kWideBatch; ++u) {
#pragma unroll
            for (int k = 0; k < R; ++k) {
              const int c = b + u;
              if (c + 1 < width(kMaxN, k)) a[k][c] = a[k][c + 1] - l[k] * lc[u];
            }
          }
        }
      }
      {  // rank-1 update of the shared rows: lane t takes row t mod P3
        const int r = lane & (P3 - 1);
        const float lr = __shfl_sync(kFull, l[R], r);  // L[kMaxN + r, j], 0 past n
        for (int c = j + 1 + lane / P3; c < n; c += G) Q[c * QS + r] -= lr * cb[c - j - 1];
      }
      __syncwarp();
    }

    // Back substitution L^T x = y, column-oriented, as at N <= 96.
    for (int j = n - 1; j >= 0; --j) {
      const int kj = j >> 5;
      float xv = y[0] * rinvk[0];
#pragma unroll
      for (int k = 1; k <= R; ++k) {
        if (kj == k) xv = y[k] * rinvk[k];
      }
      const float xj = __shfl_sync(kFull, xv, j & 31);
      const float* Lj = P + tri(min(j, kMaxN - 1));  // L's row j (< kMaxN), packed
#pragma unroll
      for (int k = 0; k <= R; ++k) {
        const int c = lane + 32 * k;
        const float lcj = j < kMaxN ? Lj[min(c, j)] : Q[min(c, n - 1) * QS + (j - kMaxN)];
        y[k] = c < j ? y[k] - lcj * xj : (c == j ? xj : y[k]);
      }
    }
#pragma unroll
    for (int k = 0; k <= R; ++k) {
      const int i = lane + 32 * k;
      if (i < n) x[f * n + i] = y[k];
    }
    __syncwarp();  // L is read: the areas may take the next system
    if (f + stride < F) stage_wide<QS>(P, Q, A + (f + stride) * n * n, n, lane);
  }
}

template <int P3>
int launch_wide(const float* A, const float* g, const float* lam, float* x, int F, int n,
                cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * wide_floats(n, P3);
  const cudaError_t e = cudaFuncSetAttribute(
      spd_chol_wide_kernel<P3>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (F + kWarps - 1) / kWarps;
  spd_chol_wide_kernel<P3><<<grid, kWarps * 32, smem, stream>>>(A, g, lam, x, F, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spd_chol_max_n() { return kWideMaxN; }

// A (F, n, n), g (F, n), lam (F,) or null, x (F, n): f32, contiguous, on the
// device. Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int spd_chol_solve_f32(const float* A, const float* g,
                                  const float* lam_or_null, float* x, int F,
                                  int n, void* stream) {
  if (F == 0) return 0;
  if (F < 0 || n <= 0 || n > kWideMaxN) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch ((n + 7) / 8) {
    case 1: return launch<8>(A, g, lam_or_null, x, F, n, st);
    case 2: return launch<16>(A, g, lam_or_null, x, F, n, st);
    case 3: return launch<24>(A, g, lam_or_null, x, F, n, st);
    case 4: return launch<32>(A, g, lam_or_null, x, F, n, st);
    case 5: return launch<40>(A, g, lam_or_null, x, F, n, st);
    case 6: return launch<48>(A, g, lam_or_null, x, F, n, st);
    case 7: return launch<56>(A, g, lam_or_null, x, F, n, st);
    case 8: return launch<64>(A, g, lam_or_null, x, F, n, st);
    case 9: return launch<72>(A, g, lam_or_null, x, F, n, st);
    case 10: return launch<80>(A, g, lam_or_null, x, F, n, st);
    case 11: return launch<88>(A, g, lam_or_null, x, F, n, st);
    case 12: return launch<96>(A, g, lam_or_null, x, F, n, st);
    case 13: return launch_wide<8>(A, g, lam_or_null, x, F, n, st);
    case 14: return launch_wide<16>(A, g, lam_or_null, x, F, n, st);
    default: return launch_wide<32>(A, g, lam_or_null, x, F, n, st);
  }
}
