// Batched Kalman filter and RTS smoother of the I2C solver for Hopper (sm_90a).
//
// Replaces the two TPU kernels of benchmarking_mpc_solvers_tpu/ops/
// i2c_pallas.py:i2c_smooth_batch: the forward filter (kernel body :121) and
// the backward smoother (kernel body :239). Over the augmented latent
// xi = (x, u) of size D with a feature observation of size Z:
//
//   filter, t = 0..T-1:  sig_y = J P J^T + R, gain L = P J^T sig_y^-1 by a
//     Z x Z Cholesky factorisation and two triangular solves per row,
//     mu_f = mu_p + L (g - (J mu_p + z0)), sig_f = sym(P - L J P), then the
//     prediction mu_n = m + F mu_f, sig_n = F sig_f F^T + Q;
//   smoother, t = T-2..0: G = sig_f F^T sig_pred^-1 by a D x D Cholesky solve,
//     mu_s = mu_f + G (mu_next - mu_pred), sig_s = sig_f + G (sig_next -
//     sig_pred) G^T, seeded with the filtered moments of t = T-1, which are
//     also the last output row.
//
// Every product, both factorisations and every triangular solve are written
// out here. Each sum is taken in the reference body's order (from 0 upwards,
// the other term added where the reference adds it), the Cholesky diagonal
// is floored at 1e-30 in a way that lets a NaN through (fmaxf would swallow
// it; the solver's failure guard needs it at the output), divisions are true
// divisions and sqrtf is the IEEE one, so with --fmad=false the kernels round
// as the plain PyTorch versions do.
//
// Bound on the H100: bytes. Per (scenario, t) the filter reads D^2 + D + ZD +
// Z floats and writes 2 (D + D^2); the smoother reads 2 (D + D^2) + D^2 and
// writes D. At D = Z = 5, B = 10240, T = 50 that is 246 MB and 184 MB.
// Design: one thread per scenario, the loop over t inside the thread, mean
// and covariance carried in registers, D and Z template parameters so that
// every matrix loop unrolls. Inputs are read batch-first as the solver builds
// them: a thread reads its own contiguous per-t blocks, neighbouring threads
// lie T*D*D floats apart, so loads do not coalesce across a warp. The filter
// hands the smoother its four outputs through global memory. Spreading one
// scenario's matrix work over several lanes, and a time-major layout, are
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
constexpr int kMaxDim = 6;

// max(s, 1e-30) that keeps a NaN: the comparison is false for NaN.
__device__ __forceinline__ float floor_keep_nan(float s) { return s < 1e-30f ? 1e-30f : s; }

// Lower Cholesky factor of the symmetric N x N matrix A (its lower triangle
// is read), diagonal floored at 1e-30.
template <int N>
__device__ __forceinline__ void chol(const float (&A)[N][N], float (&L)[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = (i == j) ? sqrtf(floor_keep_nan(s)) : s / L[j][j];
    }
}

// x = (L L^T)^-1 b: forward then backward substitution.
template <int N>
__device__ __forceinline__ void chol_solve(const float (&L)[N][N], const float (&b)[N],
                                           float (&x)[N]) {
  float y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

template <int D, int Z>
__global__ void __launch_bounds__(kThreads)
i2c_filter_kernel(const float* __restrict__ F, const float* __restrict__ m,
                  const float* __restrict__ J, const float* __restrict__ z0,
                  const float* __restrict__ R, int r_stride,
                  const float* __restrict__ mu0, const float* __restrict__ sig0,
                  const float* __restrict__ Qproc, const float* __restrict__ g_z,
                  float* __restrict__ mu_f_out, float* __restrict__ sig_f_out,
                  float* __restrict__ mu_pred_out, float* __restrict__ sig_pred_out,
                  int B, int T) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float mu_p[D], sig_p[D][D], Rt[Z][Z];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    mu_p[i] = mu0[(size_t)b * D + i];
#pragma unroll
    for (int j = 0; j < D; ++j) sig_p[i][j] = sig0[i * D + j];
  }
#pragma unroll
  for (int a = 0; a < Z; ++a)
#pragma unroll
    for (int c = 0; c < Z; ++c) Rt[a][c] = R[(size_t)b * r_stride + a * Z + c];

  for (int t = 0; t < T; ++t) {
    const size_t bt = (size_t)b * T + t;
    float Jt[Z][D], PJt[D][Z], sig_y[Z][Z], Lc[Z][Z], sols[D][Z], innov[Z];
#pragma unroll
    for (int a = 0; a < Z; ++a)
#pragma unroll
      for (int k = 0; k < D; ++k) Jt[a][k] = J[(bt * Z + a) * D + k];
    // PJt = sig_p J^T
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int a = 0; a < Z; ++a) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) s = s + sig_p[i][k] * Jt[a][k];
        PJt[i][a] = s;
      }
    // sig_y = R + J sig_p J^T (the factorisation reads its lower triangle)
#pragma unroll
    for (int a = 0; a < Z; ++a)
#pragma unroll
      for (int c = 0; c <= a; ++c) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) s = s + Jt[a][k] * PJt[k][c];
        sig_y[a][c] = Rt[a][c] + s;
      }
    chol<Z>(sig_y, Lc);
    // gain rows: sig_y x = PJt[i][:]
#pragma unroll
    for (int i = 0; i < D; ++i) chol_solve<Z>(Lc, PJt[i], sols[i]);
#pragma unroll
    for (int a = 0; a < Z; ++a) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < D; ++k) s = s + Jt[a][k] * mu_p[k];
      innov[a] = g_z[t * Z + a] - (s + z0[bt * Z + a]);
    }
    float mu_f[D], sf[D][D], sig_f[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int a = 0; a < Z; ++a) s = s + sols[i][a] * innov[a];
      mu_f[i] = mu_p[i] + s;
    }
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int a = 0; a < Z; ++a) s = s + sols[i][a] * PJt[j][a];
        sf[i][j] = sig_p[i][j] - s;
      }
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) sig_f[i][j] = 0.5f * (sf[i][j] + sf[j][i]);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      mu_f_out[bt * D + i] = mu_f[i];
#pragma unroll
      for (int j = 0; j < D; ++j) sig_f_out[(bt * D + i) * D + j] = sig_f[i][j];
    }
    // predict: mu_n = m + F mu_f, sig_n = F sig_f F^T + Q
    float Ft[D][D], FS[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) Ft[i][j] = F[(bt * D + i) * D + j];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < D; ++k) s = s + Ft[i][k] * mu_f[k];
      mu_p[i] = m[bt * D + i] + s;
    }
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) s = s + Ft[i][k] * sig_f[k][j];
        FS[i][j] = s;
      }
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) s = s + FS[i][k] * Ft[j][k];
        sig_p[i][j] = s + Qproc[i * D + j];
      }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      mu_pred_out[bt * D + i] = mu_p[i];
#pragma unroll
      for (int j = 0; j < D; ++j) sig_pred_out[(bt * D + i) * D + j] = sig_p[i][j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
i2c_rts_kernel(const float* __restrict__ mu_f, const float* __restrict__ sig_f,
               const float* __restrict__ mu_pred, const float* __restrict__ sig_pred,
               const float* __restrict__ F, float* __restrict__ mu_s, int B, int T) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  // the carry starts from the filtered moments of t = T-1, the last output row
  float mu_next[D], sig_next[D][D];
  {
    const size_t bl = (size_t)b * T + (T - 1);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      mu_next[i] = mu_f[bl * D + i];
      mu_s[bl * D + i] = mu_next[i];
#pragma unroll
      for (int j = 0; j < D; ++j) sig_next[i][j] = sig_f[(bl * D + i) * D + j];
    }
  }
  for (int t = T - 2; t >= 0; --t) {
    const size_t bt = (size_t)b * T + t;
    float sig_ft[D][D], sig_pt[D][D], Ft[D][D], M[D][D], Lc[D][D], G[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        sig_ft[i][j] = sig_f[(bt * D + i) * D + j];
        sig_pt[i][j] = sig_pred[(bt * D + i) * D + j];
        Ft[i][j] = F[(bt * D + i) * D + j];
      }
    // M = F sig_f; G^T = sig_pred^-1 M, one right-hand side per column of M
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) s = s + Ft[i][k] * sig_ft[k][j];
        M[i][j] = s;
      }
    chol<D>(sig_pt, Lc);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float col[D];
#pragma unroll
      for (int k = 0; k < D; ++k) col[k] = M[k][i];
      chol_solve<D>(Lc, col, G[i]);
    }
    float dmu[D], mu_sm[D], Dlt[D][D], GD[D][D];
#pragma unroll
    for (int k = 0; k < D; ++k) dmu[k] = mu_next[k] - mu_pred[bt * D + k];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < D; ++k) s = s + G[i][k] * dmu[k];
      mu_sm[i] = mu_f[bt * D + i] + s;
    }
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) Dlt[i][j] = sig_next[i][j] - sig_pt[i][j];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) s = s + G[i][k] * Dlt[k][j];
        GD[i][j] = s;
      }
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) s = s + GD[i][k] * G[j][k];
        sig_next[i][j] = sig_ft[i][j] + s;
      }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      mu_next[i] = mu_sm[i];
      mu_s[bt * D + i] = mu_sm[i];
    }
  }
}

struct FilterArgs {
  const float *F, *m, *J, *z0, *R;
  int r_stride;
  const float *mu0, *sig0, *Qproc, *g_z;
  float *mu_f, *sig_f, *mu_pred, *sig_pred;
  int B, T;
  cudaStream_t stream;
};

template <int D, int Z>
int launch_filter(const FilterArgs& a) {
  const dim3 grid((a.B + kThreads - 1) / kThreads);
  i2c_filter_kernel<D, Z><<<grid, kThreads, 0, a.stream>>>(
      a.F, a.m, a.J, a.z0, a.R, a.r_stride, a.mu0, a.sig0, a.Qproc, a.g_z, a.mu_f, a.sig_f,
      a.mu_pred, a.sig_pred, a.B, a.T);
  return (int)cudaGetLastError();
}

template <int D>
int launch_filter_z(const FilterArgs& a, int Z) {
  switch (Z) {
    case 1: return launch_filter<D, 1>(a);
    case 2: return launch_filter<D, 2>(a);
    case 3: return launch_filter<D, 3>(a);
    case 4: return launch_filter<D, 4>(a);
    case 5: return launch_filter<D, 5>(a);
    case 6: return launch_filter<D, 6>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D>
int launch_rts(const float* mu_f, const float* sig_f, const float* mu_pred,
               const float* sig_pred, const float* F, float* mu_s, int B, int T,
               cudaStream_t stream) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  i2c_rts_kernel<D><<<grid, kThreads, 0, stream>>>(mu_f, sig_f, mu_pred, sig_pred, F, mu_s, B,
                                                  T);
  return (int)cudaGetLastError();
}

}  // namespace

// Batch-first float32 contiguous device arrays: F (B, T, D, D), m (B, T, D),
// J (B, T, Z, D), z0 (B, T, Z), R (Z, Z) with r_per_scenario == 0 or
// (B, Z, Z) otherwise, mu0 (B, D), sig0 and Qproc (D, D), g_z (T, Z); out
// mu_f, mu_pred (B, T, D), sig_f, sig_pred (B, T, D, D). 1 <= D, Z <= 6,
// B, T >= 1. Returns the launch's cudaGetLastError().
extern "C" int i2c_filter_launch(const float* F, const float* m, const float* J,
                                 const float* z0, const float* R, const float* mu0,
                                 const float* sig0, const float* Qproc, const float* g_z,
                                 float* mu_f, float* sig_f, float* mu_pred, float* sig_pred,
                                 int B, int T, int D, int Z, int r_per_scenario,
                                 cudaStream_t stream) {
  if (Z < 1 || Z > kMaxDim) return (int)cudaErrorInvalidValue;
  const FilterArgs a{F, m, J, z0, R, r_per_scenario ? Z * Z : 0, mu0, sig0, Qproc, g_z,
                     mu_f, sig_f, mu_pred, sig_pred, B, T, stream};
  switch (D) {
    case 1: return launch_filter_z<1>(a, Z);
    case 2: return launch_filter_z<2>(a, Z);
    case 3: return launch_filter_z<3>(a, Z);
    case 4: return launch_filter_z<4>(a, Z);
    case 5: return launch_filter_z<5>(a, Z);
    case 6: return launch_filter_z<6>(a, Z);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The filter's four outputs and F as above; out mu_s (B, T, D): rows 0..T-2
// smoothed, row T-1 the filtered mean. 1 <= D <= 6, B, T >= 1.
extern "C" int i2c_rts_launch(const float* mu_f, const float* sig_f, const float* mu_pred,
                              const float* sig_pred, const float* F, float* mu_s, int B,
                              int T, int D, cudaStream_t stream) {
  switch (D) {
#define BMPC_RTS_CASE(n) \
  case n:                \
    return launch_rts<n>(mu_f, sig_f, mu_pred, sig_pred, F, mu_s, B, T, stream);
    BMPC_RTS_CASE(1)
    BMPC_RTS_CASE(2)
    BMPC_RTS_CASE(3)
    BMPC_RTS_CASE(4)
    BMPC_RTS_CASE(5)
    BMPC_RTS_CASE(6)
#undef BMPC_RTS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
