// Batched scalar-action Riccati backward pass for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarking_mpc_solvers_tpu/ops/riccati_pallas.py:
// riccati_backward_batch (kernel body :107). For each of B scenarios it runs
// the whole backward recursion over the horizon in one launch: the Q-terms,
// the mu-regularised gain solve (q_uu + mu*sum f_u^2, q_ux + mu*f_u^T f_x),
// the Q_uu > 0 check (check_pd: a failed step divides by 1 and goes on; ok is
// the product over t), the UNregularised value recursion with V_xx
// symmetrised every step, and with c the affine residual (V_x + V_xx c).
// Each sum is taken in the reference kernel's order, starting from 0, so
// with --fmad=false the kernel rounds as the plain PyTorch version does.
//
// Bound on the H100: bytes. At iLQR's shape (B=1024, T=100, S=4) the kernel
// reads ~46 floats per (scenario, t) (l_x, l_u, l_xx, l_uu, l_ux, f_x, f_u)
// and writes 5 (k, K): ~21 MB, 6 us at 3.35 TB/s, against ~0.6 k FP32
// operations per (scenario, t), 64 M in all, 1.0 us at 67 TFLOP/s.
// Design: one thread per scenario, V_x and V_xx in registers across the
// horizon (S is a template parameter, S <= 8, so every matrix loop unrolls),
// inputs read batch-first as the solver lays them out: each thread reads
// its own contiguous per-t blocks. 1024 scenarios are only 1024 threads on
// 132 SMs, in blocks of 32 to spread them over 32 SMs; the recursion is
// sequential in t and latency-bound. Splitting a scenario's S x S work over
// a warp is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;

template <int S>
__global__ void __launch_bounds__(kThreads)
riccati_backward_kernel(const float* __restrict__ l_x, const float* __restrict__ l_u,
                        const float* __restrict__ l_xx, const float* __restrict__ l_uu,
                        const float* __restrict__ l_ux, const float* __restrict__ f_x,
                        const float* __restrict__ f_u, const float* __restrict__ mu,
                        const float* __restrict__ c, float* __restrict__ ks,
                        float* __restrict__ Ks, float* __restrict__ ok, int B, int T,
                        int check_pd) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t bT1 = (size_t)b * (T + 1);
  float vx[S], vxx[S][S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    vx[i] = l_x[(bT1 + T) * S + i];
#pragma unroll
    for (int j = 0; j < S; ++j) vxx[i][j] = l_xx[((bT1 + T) * S + i) * S + j];
  }
  const float mu_b = mu[b];
  float okf = 1.0f;

  for (int t = T - 1; t >= 0; --t) {
    const size_t bt = (size_t)b * T + t;
    const size_t bt1 = bT1 + t;
    float fx[S][S], fu[S], vxc[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      fu[i] = f_u[bt * S + i];
#pragma unroll
      for (int j = 0; j < S; ++j) fx[i][j] = f_x[(bt * S + i) * S + j];
    }
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if (c != nullptr) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < S; ++k) s = s + vxx[i][k] * c[bt * S + k];
        vxc[i] = vx[i] + s;
      } else {
        vxc[i] = vx[i];
      }
    }
    float q_x[S], q_ux[S], q_ux_r[S], K[S], m[S][S], q_xx[S][S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < S; ++i) s = s + fx[i][j] * vxc[i];
      q_x[j] = l_x[bt1 * S + j] + s;
    }
    float q_u = 0.0f;
#pragma unroll
    for (int i = 0; i < S; ++i) q_u = q_u + fu[i] * vxc[i];
    q_u = l_u[bt] + q_u;
#pragma unroll
    for (int i = 0; i < S; ++i)
#pragma unroll
      for (int j = 0; j < S; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < S; ++k) s = s + vxx[i][k] * fx[k][j];
        m[i][j] = s;  // (V_xx f_x)[i][j]
      }
#pragma unroll
    for (int j = 0; j < S; ++j)
#pragma unroll
      for (int jp = 0; jp < S; ++jp) {
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < S; ++i) s = s + fx[i][j] * m[i][jp];
        q_xx[j][jp] = l_xx[(bt1 * S + j) * S + jp] + s;
      }
    float q_uu = 0.0f;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      float w = 0.0f;  // (V_xx f_u)[i]
#pragma unroll
      for (int k = 0; k < S; ++k) w = w + vxx[i][k] * fu[k];
      q_uu = q_uu + fu[i] * w;
    }
    q_uu = l_uu[bt] + q_uu;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < S; ++i) s = s + fu[i] * m[i][j];
      q_ux[j] = l_ux[bt * S + j] + s;
    }
    // mu enters the gain solve only
    float fufu = 0.0f;
#pragma unroll
    for (int i = 0; i < S; ++i) fufu = fufu + fu[i] * fu[i];
    const float q_uu_r = q_uu + mu_b * fufu;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < S; ++i) s = s + fu[i] * fx[i][j];
      q_ux_r[j] = q_ux[j] + mu_b * s;
    }
    float inv;
    if (check_pd) {
      const bool pd = q_uu_r > 0.0f;
      okf = okf * (pd ? 1.0f : 0.0f);
      inv = 1.0f / (pd ? q_uu_r : 1.0f);
    } else {
      inv = 1.0f / q_uu_r;
    }
    const float k = -q_u * inv;
#pragma unroll
    for (int j = 0; j < S; ++j) K[j] = -q_ux_r[j] * inv;

    // UNregularised value recursion, V_xx symmetrised
#pragma unroll
    for (int j = 0; j < S; ++j) vx[j] = q_x[j] + K[j] * (q_uu * k + q_u) + q_ux[j] * k;
    float vnew[S][S];
#pragma unroll
    for (int j = 0; j < S; ++j)
#pragma unroll
      for (int jp = 0; jp < S; ++jp)
        vnew[j][jp] = q_xx[j][jp] + K[j] * q_uu * K[jp] + K[j] * q_ux[jp] + q_ux[j] * K[jp];
#pragma unroll
    for (int j = 0; j < S; ++j)
#pragma unroll
      for (int jp = 0; jp < S; ++jp) vxx[j][jp] = 0.5f * (vnew[j][jp] + vnew[jp][j]);

    ks[bt] = k;
#pragma unroll
    for (int j = 0; j < S; ++j) Ks[bt * S + j] = K[j];
  }
  ok[b] = okf;
}

template <int S>
int launch(const float* l_x, const float* l_u, const float* l_xx, const float* l_uu,
           const float* l_ux, const float* f_x, const float* f_u, const float* mu,
           const float* c, float* ks, float* Ks, float* ok, int B, int T, int check_pd,
           cudaStream_t stream) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  riccati_backward_kernel<S><<<grid, kThreads, 0, stream>>>(
      l_x, l_u, l_xx, l_uu, l_ux, f_x, f_u, mu, c, ks, Ks, ok, B, T, check_pd);
  return (int)cudaGetLastError();
}

}  // namespace

// Batch-first float32 contiguous device arrays: l_x (B, T+1, S), l_u (B, T),
// l_xx (B, T+1, S, S), l_uu (B, T), l_ux (B, T, S), f_x (B, T, S, S),
// f_u (B, T, S), mu (B,), c (B, T, S) or null; out ks (B, T), Ks (B, T, S),
// ok (B,) as 1.0/0.0. Returns the launch's cudaGetLastError().
extern "C" int riccati_backward_launch(const float* l_x, const float* l_u,
                                       const float* l_xx, const float* l_uu,
                                       const float* l_ux, const float* f_x,
                                       const float* f_u, const float* mu,
                                       const float* c, float* ks, float* Ks,
                                       float* ok, int B, int T, int S,
                                       int check_pd, cudaStream_t stream) {
  switch (S) {
#define BMPC_RICCATI_CASE(n) \
  case n:                    \
    return launch<n>(l_x, l_u, l_xx, l_uu, l_ux, f_x, f_u, mu, c, ks, Ks, ok, B, T, check_pd, stream);
    BMPC_RICCATI_CASE(1)
    BMPC_RICCATI_CASE(2)
    BMPC_RICCATI_CASE(3)
    BMPC_RICCATI_CASE(4)
    BMPC_RICCATI_CASE(5)
    BMPC_RICCATI_CASE(6)
    BMPC_RICCATI_CASE(7)
    BMPC_RICCATI_CASE(8)
#undef BMPC_RICCATI_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
