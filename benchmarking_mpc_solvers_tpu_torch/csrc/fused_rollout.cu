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
// at 67 TFLOP/s; each division and sincosf is a sequence of instructions on
// the card, so the rate at which the SMs issue instructions comes first
// (chip_smoke.py counts the rollout loop's and prints that floor).
// Design: one thread per rollout, state in registers across the horizon,
// us[t, n] read coalesced along n, the model's device function and the cost
// helper shared with fused_mppi.cu through models.cuh. A step issues few
// instructions beside its arithmetic:
// - the stage cost is compiled for the model's own nonzero weights
//   (M::kCostTerms, as fused_cem.cu): no tests of the zero weights and no
//   loads of their goals (cart-pole: 2 terms of 15);
// - step t+1's action is loaded while step t computes (one register), so the
//   load's latency stays off the state's dependent chain.
// Neither changes an operation of the sum, so the costs keep their bits.
#include <cuda_runtime.h>

#include "models.cuh"

namespace {

constexpr int kThreads = 256;

template <class M>
__global__ void __launch_bounds__(kThreads)
fused_rollout_kernel(const float* __restrict__ x0, const float* __restrict__ us,
                     const float* __restrict__ gz, float* __restrict__ out,
                     int T, int N, bmpc::QuadW q) {
  constexpr int S = M::S;
  constexpr int Z = S + 1;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  float x[S], xn[S], z[Z];
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = x0[(size_t)i * N + n];
  const float* un = us + n;  // this rollout's action of step t + 1
  float u_next = T > 0 ? *un : 0.0f;
  float acc = 0.0f;
  for (int t = 0; t < T; ++t) {
    const float u = u_next;
    if (t + 1 < T) {
      un += N;
      u_next = *un;
    }
    M::transform(x, u, z);
    const float c = bmpc::quad_cost<Z, M::kCostTerms>(z, gz + t * Z, q);
    M::dynamics(x, u, xn);
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = xn[i];
    acc = acc + c;
  }
  out[n] = acc;
}

}  // namespace

// x0 (S, N), us (T, N), gz (T, S+1), out (N,): float32, contiguous, on the
// device. w: host array of MAX_Z*MAX_Z upper-triangle cost weights, nonzero
// exactly at the model's kCostTerms. Returns the launch's cudaGetLastError().
extern "C" int fused_rollout_costs_launch(int model_id, const float* x0,
                                          const float* us, const float* gz,
                                          float* out, int T, int N,
                                          const float* w, cudaStream_t stream) {
  bmpc::QuadW q;
  for (int i = 0; i < bmpc::kMaxZ * bmpc::kMaxZ; ++i) q.w[i] = w[i];
  const dim3 block(kThreads);
  const dim3 grid((N + kThreads - 1) / kThreads);
  BMPC_DISPATCH_MODEL(model_id, {
    // compiled for the model's own stage cost, the only one a registered
    // (frozen) model has: any other weights are refused
    if (bmpc::cost_terms(q) != M::kCostTerms) return (int)cudaErrorInvalidValue;
    fused_rollout_kernel<M><<<grid, block, 0, stream>>>(x0, us, gz, out, T, N, q);
  });
  return (int)cudaGetLastError();
}

// The launch shape at (model, N) on the current card, into out[4]: threads
// (rollouts) per block, blocks, registers per thread, resident blocks per
// SM. Returns a cudaError.
extern "C" int fused_rollout_launch_config(int model_id, int N, int* out) {
  BMPC_DISPATCH_MODEL(model_id, {
    const auto kernel = fused_rollout_kernel<M>;
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    const int vals[4] = {kThreads, (N + kThreads - 1) / kThreads, attr.numRegs, per_sm};
    for (int i = 0; i < 4; ++i) out[i] = vals[i];
    return 0;
  });
}
