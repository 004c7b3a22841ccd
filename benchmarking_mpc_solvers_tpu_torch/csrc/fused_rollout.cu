// Fused rollout-cost kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarking_mpc_solvers_tpu/ops/fused.py:
// fused_rollout_costs_tm (kernel body :81): N independent horizon-T
// rollouts from x0 (S, N) under the time-major action stream us (T, N),
// returning the summed stage costs (N,), each the nonzero-W quadratic on
// transform(x, u) - g_z[t], clipped to +-1e30, evaluated before the step.
//
// Bound on the H100: at the two-stage MPPI tier's shape (N = 8192*32,
// T = 50, cart-pole) the kernel reads 52 MB of actions and 4 MB of states,
// 17 us at 3.35 TB/s, and does 13.1 M rollout steps of ~59 float ops, 12 us
// at 67 TFLOP/s: it is bound by bytes, with operations close behind.
// Design: one thread per rollout, state in registers across the
// horizon, us[t, n] read coalesced along n, the model's device function and
// the cost helper shared with fused_mppi.cu through models.cuh.
#include <cuda_runtime.h>

#include "models.cuh"

namespace {

template <class M>
__global__ void __launch_bounds__(256)
fused_rollout_kernel(const float* __restrict__ x0, const float* __restrict__ us,
                     const float* __restrict__ gz, float* __restrict__ out,
                     int T, int N, bmpc::QuadW q) {
  constexpr int S = M::S;
  constexpr int Z = S + 1;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float x[S], xn[S], z[Z];
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = x0[(size_t)i * N + n];
  float acc = 0.0f;
  for (int t = 0; t < T; ++t) {
    const float u = us[(size_t)t * N + n];
    M::transform(x, u, z);
    const float c = bmpc::quad_cost<Z>(z, gz + t * Z, q);
    M::dynamics(x, u, xn);
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = xn[i];
    acc = acc + c;
  }
  out[n] = acc;
}

}  // namespace

// x0 (S, N), us (T, N), gz (T, S+1), out (N,): float32, contiguous, on the
// device. w: host array of MAX_Z*MAX_Z upper-triangle cost weights. Returns
// the launch's cudaGetLastError().
extern "C" int fused_rollout_costs_launch(int model_id, const float* x0,
                                          const float* us, const float* gz,
                                          float* out, int T, int N,
                                          const float* w, cudaStream_t stream) {
  bmpc::QuadW q;
  for (int i = 0; i < bmpc::kMaxZ * bmpc::kMaxZ; ++i) q.w[i] = w[i];
  const dim3 block(256);
  const dim3 grid((N + 255) / 256);
  BMPC_DISPATCH_MODEL(model_id,
      fused_rollout_kernel<M><<<grid, block, 0, stream>>>(x0, us, gz, out, T, N, q));
  return (int)cudaGetLastError();
}
