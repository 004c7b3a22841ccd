// Fused trajectory-derivative kernel for Hopper (sm_90a): linearize the
// dynamics and Gauss-Newton-quadratize the stage cost at every (scenario, t)
// point of a batch of trajectories in one launch.
//
// Replaces the TPU kernel benchmarking_mpc_solvers_tpu/ops/fused_derivs.py:
// fused_derivs (kernel body :86). Per point (x, u) it pushes the S+1 basis
// tangents through the model's dynamics and feature transform, one at a
// time as the reference does with jax.jvp, and forms
//   A = df/dx, Bd = df/du, c = f(x, u) - sum_j A_j x_j - Bd u (in that order),
//   grad = 2 J^T W_sym (z - g),  H = 2 J^T W_sym J  (J the transform Jacobian),
//   q = grad[:S], r = grad[S], Q = H[:S, :S], M = H[S, :S], R = H[S, S],
// with the rows of W_sym contracted over their nonzero entries only, in
// index order, and a feature row whose weights are all zero left out of the
// dot products (so an overflowed, unweighted feature cannot poison them).
// The tangents come from bmpc::Dual (models.cuh): the model functors are
// templates on the scalar, so the physics is written once.
//
// Bound on the H100: bytes. Per point the function reads S+1 floats and
// writes 2S^2 + 4S + 2 (50 at S = 4): 220 B, 22.5 MB at SQP's shape
// (B=1024, T=100), 6.7 us at 3.35 TB/s; the S+1 dual passes are ~2(S+1)
// model steps per point (acrobot: ~2.5 k FP32 operations, 0.26 G in all,
// 3.9 us at 67 TFLOP/s).
// Design: one thread per point, no carry over t. The tangent loop is kept
// rolled (one dual pass live at a time) so the acrobot's RK4 step fits the
// register file; the transform Jacobian (Z x (S+1) floats) waits in local
// memory for the Gauss-Newton products. Each thread writes its own rows
// (stride 2S^2 + ...), not coalesced; staging the outputs through shared
// memory is later work.
#include <cuda_runtime.h>

#include "models.cuh"

namespace {

constexpr int kThreads = 128;

template <class M>
__global__ void __launch_bounds__(kThreads)
fused_derivs_kernel(const float* __restrict__ xs, const float* __restrict__ us,
                    const float* __restrict__ gz, float* __restrict__ A,
                    float* __restrict__ Bd, float* __restrict__ c, float* __restrict__ Q,
                    float* __restrict__ R, float* __restrict__ Mx, float* __restrict__ q,
                    float* __restrict__ r, int B, int T, bmpc::SymW w) {
  using bmpc::Dual;
  constexpr int S = M::S;
  constexpr int Z = S + 1;
  constexpr int D = S + 1;
  constexpr int kW = bmpc::kMaxZ;
  const size_t n = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= (size_t)B * T) return;
  const int b = (int)(n / T);
  const int t = (int)(n % T);
  const float* xp = xs + ((size_t)b * (T + 1) + t) * S;
  float x[S];
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = xp[i];
  const float u = us[n];

  float Jz[D][Z];  // Jz[j][i] = d z_i / d (x, u)_j
  float zv[Z], resid[S];
#pragma unroll 1
  for (int j = 0; j < D; ++j) {
    Dual xd[S], xn[S], zd[Z];
    float xj = u;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      xd[i] = Dual(x[i], i == j ? 1.0f : 0.0f);
      if (i == j) xj = x[i];
    }
    const Dual ud(u, j == S ? 1.0f : 0.0f);
    M::dynamics(xd, ud, xn);
    M::transform(xd, ud, zd);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if (j == 0) resid[i] = xn[i].v;
      resid[i] = resid[i] - xn[i].d * xj;
      if (j < S) {
        A[(n * S + i) * S + j] = xn[i].d;
      } else {
        Bd[n * S + i] = xn[i].d;
      }
    }
#pragma unroll
    for (int i = 0; i < Z; ++i) {
      Jz[j][i] = zd[i].d;
      if (j == 0) zv[i] = zd[i].v;
    }
  }
#pragma unroll
  for (int i = 0; i < S; ++i) c[n * S + i] = resid[i];

  // Wv = W_sym (z - g); a row of W_sym without a nonzero entry is skipped
  float Wv[Z];
  bool has[Z];
#pragma unroll
  for (int i = 0; i < Z; ++i) {
    float acc = 0.0f;
    has[i] = false;
#pragma unroll
    for (int k = 0; k < Z; ++k) {
      const float wik = w.w[i * kW + k];
      if (wik != 0.0f) {
        acc = acc + wik * (zv[k] - gz[t * Z + k]);
        has[i] = true;
      }
    }
    Wv[i] = acc;
  }
  float grad[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < Z; ++i)
      if (has[i]) acc = acc + Jz[j][i] * Wv[i];
    grad[j] = 2.0f * acc;
  }
#pragma unroll
  for (int i = 0; i < S; ++i) q[n * S + i] = grad[i];
  r[n] = grad[S];

  // H[j1][j2] = 2 sum_i Jz[j1][i] (W_sym Jz[j2])[i], one column j2 at a time
#pragma unroll
  for (int j2 = 0; j2 < D; ++j2) {
    float WJ[Z];
#pragma unroll
    for (int i = 0; i < Z; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < Z; ++k) {
        const float wik = w.w[i * kW + k];
        if (wik != 0.0f) acc = acc + wik * Jz[j2][k];
      }
      WJ[i] = acc;
    }
#pragma unroll
    for (int j1 = 0; j1 < D; ++j1) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < Z; ++i)
        if (has[i]) acc = acc + Jz[j1][i] * WJ[i];
      const float h = 2.0f * acc;
      if (j1 < S && j2 < S) {
        Q[(n * S + j1) * S + j2] = h;
      } else if (j1 == S && j2 < S) {
        Mx[n * S + j2] = h;
      } else if (j1 == S && j2 == S) {
        R[n] = h;
      }
    }
  }
}

}  // namespace

// xs (B, T+1, S), us (B, T), gz (T, S+1); out A (B, T, S, S), Bd (B, T, S),
// c (B, T, S), Q (B, T, S, S), R (B, T), Mx (B, T, S), q (B, T, S), r (B, T):
// float32, contiguous, on the device. w_sym: host array of MAX_Z*MAX_Z dense
// symmetrised stage-cost weights. Returns the launch's cudaGetLastError().
extern "C" int fused_derivs_launch(int model_id, const float* xs, const float* us,
                                   const float* gz, float* A, float* Bd, float* c,
                                   float* Q, float* R, float* Mx, float* q, float* r,
                                   int B, int T, const float* w_sym,
                                   cudaStream_t stream) {
  bmpc::SymW w;
  for (int i = 0; i < bmpc::kMaxZ * bmpc::kMaxZ; ++i) w.w[i] = w_sym[i];
  const size_t n = (size_t)B * T;
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  BMPC_DISPATCH_MODEL(model_id,
      fused_derivs_kernel<M><<<grid, kThreads, 0, stream>>>(
          xs, us, gz, A, Bd, c, Q, R, Mx, q, r, B, T, w));
  return (int)cudaGetLastError();
}
