// Fused line-search (feedback rollout) kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarking_mpc_solvers_tpu/ops/
// fused_linesearch.py: fused_linesearch (kernel body :122). It evaluates all
// n_alpha x B candidates of a batched iLQR/SQP iteration in one launch:
// candidate n = a*B + b rolls from x0[b] with
//   u_t = clip(us[b,t] + alpha_a*ks[b,t] + sum_i Ks[b,t,i]*(x_i - xref[b,t,i]), lo, hi),
// adds the clipped nonzero-W stage cost at (x, u), steps the dynamics, and
// with_terminal adds the clipped terminal cost at zero action against
// g_z[T-1]. It writes the clipped controls, the summed costs and, when
// xs_hat is given, every state of the trajectory (x0 included).
//
// Bound on the H100: bytes. At iLQR's shape (n_alpha=10, B=1024, T=100,
// cart-pole) the function reads us, ks, Ks and xref once (B*T*(2 + 2S)
// floats, 4 MB) and writes us_hat and the costs (n_alpha*B*(T+1) floats,
// 4 MB), plus 16.5 MB of states with return_states: 2.5 us (7.4 us) at
// 3.35 TB/s, against 1.0 M rollout steps of ~75 FP32 operations, 1.2 us at
// 67 TFLOP/s.
// Design: one thread per candidate (10,240 threads), state in registers,
// the per-scenario inputs read batch-first: the n_alpha candidates of a
// scenario read the same lines, which the L1/L2 caches serve. The model and
// cost device functions are those of fused_rollout.cu (models.cuh). Writes
// are per-thread rows (stride T), not coalesced; staging them through
// shared memory is later work.
#include <cuda_runtime.h>

#include "models.cuh"

namespace {

constexpr int kThreads = 128;

template <class M>
__global__ void __launch_bounds__(kThreads)
fused_linesearch_kernel(const float* __restrict__ alphas, const float* __restrict__ x0,
                        const float* __restrict__ us, const float* __restrict__ ks,
                        const float* __restrict__ Ks, const float* __restrict__ xref,
                        const float* __restrict__ gz, float* __restrict__ us_hat,
                        float* __restrict__ costs, float* __restrict__ xs_hat, int n_a,
                        int B, int T, float lo, float hi, int with_terminal,
                        bmpc::QuadW q, bmpc::QuadW q_term) {
  constexpr int S = M::S;
  constexpr int Z = S + 1;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_a * B) return;
  const int b = n % B;
  const float alpha = alphas[n / B];
  float x[S], xn[S], z[Z];
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = x0[(size_t)b * S + i];
  float acc = 0.0f;
  for (int t = 0; t < T; ++t) {
    const size_t bt = (size_t)b * T + t;
    const size_t bt1 = (size_t)b * (T + 1) + t;
    float fb = 0.0f;
#pragma unroll
    for (int i = 0; i < S; ++i) fb = fb + Ks[bt * S + i] * (x[i] - xref[bt1 * S + i]);
    const float u = bmpc::clampf(us[bt] + alpha * ks[bt] + fb, lo, hi);
    us_hat[(size_t)n * T + t] = u;
    if (xs_hat != nullptr) {
#pragma unroll
      for (int i = 0; i < S; ++i) xs_hat[((size_t)n * (T + 1) + t) * S + i] = x[i];
    }
    M::transform(x, u, z);
    const float c = bmpc::quad_cost<Z>(z, gz + t * Z, q);
    M::dynamics(x, u, xn);
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = xn[i];
    acc = acc + c;
  }
  if (xs_hat != nullptr) {
#pragma unroll
    for (int i = 0; i < S; ++i) xs_hat[((size_t)n * (T + 1) + T) * S + i] = x[i];
  }
  if (with_terminal) {
    M::transform(x, 0.0f, z);
    acc = acc + bmpc::quad_cost<Z>(z, gz + (T - 1) * Z, q_term);
  }
  costs[n] = acc;
}

}  // namespace

// alphas (n_a,), x0 (B, S), us/ks (B, T), Ks (B, T, S), xref (B, T+1, S),
// gz (T, S+1); out us_hat (n_a, B, T), costs (n_a, B), xs_hat
// (n_a, B, T+1, S) or null: float32, contiguous, on the device. w, w_term:
// host arrays of MAX_Z*MAX_Z upper-triangle stage and terminal cost weights.
// Returns the launch's cudaGetLastError().
extern "C" int fused_linesearch_launch(int model_id, const float* alphas,
                                       const float* x0, const float* us,
                                       const float* ks, const float* Ks,
                                       const float* xref, const float* gz,
                                       float* us_hat, float* costs, float* xs_hat,
                                       int n_a, int B, int T, float lo, float hi,
                                       int with_terminal, const float* w,
                                       const float* w_term, cudaStream_t stream) {
  bmpc::QuadW q, q_term;
  for (int i = 0; i < bmpc::kMaxZ * bmpc::kMaxZ; ++i) {
    q.w[i] = w[i];
    q_term.w[i] = w_term[i];
  }
  const dim3 grid((n_a * B + kThreads - 1) / kThreads);
  BMPC_DISPATCH_MODEL(model_id,
      fused_linesearch_kernel<M><<<grid, kThreads, 0, stream>>>(
          alphas, x0, us, ks, Ks, xref, gz, us_hat, costs, xs_hat, n_a, B, T, lo, hi,
          with_terminal, q, q_term));
  return (int)cudaGetLastError();
}
