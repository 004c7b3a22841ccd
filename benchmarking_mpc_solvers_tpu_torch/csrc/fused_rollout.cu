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
//   loads of their goals (cart-pole: 2 terms of 15); other weights take the
//   same kernel with the generic cost (models.cuh: generic_cost);
// - step t+1's action is loaded while step t computes (one register), so the
//   load's latency stays off the state's dependent chain.
// Neither changes an operation of the sum, so the costs keep their bits.
#include <cuda_runtime.h>

#include "models.cuh"

namespace {

constexpr int kThreads = 256;

template <class M, uint64_t kTerms>
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
    const float c = bmpc::quad_cost<Z, kTerms>(z, gz + t * Z, q);
    M::dynamics(x, u, xn);
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = xn[i];
    acc = acc + c;
  }
  out[n] = acc;
}

// The dummy family at any S (models.cuh: dummy_cost): the state stays x0,
// x_i of rollout n at x0[i * N + n].
__global__ void __launch_bounds__(kThreads)
fused_rollout_dummy_kernel(const float* __restrict__ x0, const float* __restrict__ us,
                           const float* __restrict__ gz, float* __restrict__ out, int T,
                           int N, int S, const int4* __restrict__ terms, int n_terms) {
  const int Z = S + 1;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const float* xn = x0 + n;
  float acc = 0.0f;
  for (int t = 0; t < T; ++t) {
    const float c = bmpc::dummy_cost(xn, N, S, us[(size_t)t * N + n], gz + t * Z, terms,
                                     n_terms);
    acc = acc + c;
  }
  out[n] = acc;
}

template <class M>
auto kernel_for(bool generic) {
  constexpr uint64_t kTerms = bmpc::compiled_terms<M>();
  return generic ? fused_rollout_kernel<M, 0> : fused_rollout_kernel<M, kTerms>;
}

}  // namespace

// x0 (S, N), us (T, N), gz (T, S+1), out (N,): float32, contiguous, on the
// device. w: host array of MAX_Z*MAX_Z upper-triangle cost weights (row
// stride MAX_Z). Returns the launch's cudaGetLastError().
extern "C" int fused_rollout_costs_launch(int model_id, const float* x0,
                                          const float* us, const float* gz,
                                          float* out, int T, int N,
                                          const float* w, cudaStream_t stream) {
  const bmpc::QuadW q = bmpc::quad_w(w);
  const dim3 block(kThreads);
  const dim3 grid((N + kThreads - 1) / kThreads);
  BMPC_DISPATCH_MODEL(model_id, {
    const auto kernel = kernel_for<M>(bmpc::generic_cost<M>(q));
    kernel<<<grid, block, 0, stream>>>(x0, us, gz, out, T, N, q);
  });
  return (int)cudaGetLastError();
}

// The launch shape at (model, N, weights w) on the current card, into
// out[5]: threads (rollouts) per block, blocks, registers per thread,
// resident blocks per SM, and 1 where the stage cost is the generic form (0:
// compiled for the model's kCostTerms). Returns a cudaError.
extern "C" int fused_rollout_launch_config(int model_id, int N, const float* w, int* out) {
  const bmpc::QuadW q = bmpc::quad_w(w);
  BMPC_DISPATCH_MODEL(model_id, {
    const bool generic = bmpc::generic_cost<M>(q);
    const auto kernel = kernel_for<M>(generic);
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    const int vals[5] = {kThreads, (N + kThreads - 1) / kThreads, attr.numRegs, per_sm,
                         generic ? 1 : 0};
    for (int i = 0; i < 5; ++i) out[i] = vals[i];
    return 0;
  });
}

// The dummy family at any S: the arguments of fused_rollout_costs_launch
// with S and the device array of n_terms weight terms (_build.dummy_terms)
// in place of the model id and the host weights.
extern "C" int fused_rollout_dummy_launch(int S, const float* x0, const float* us,
                                          const float* gz, float* out, int T, int N,
                                          const int4* terms, int n_terms,
                                          cudaStream_t stream) {
  fused_rollout_dummy_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      x0, us, gz, out, T, N, S, terms, n_terms);
  return (int)cudaGetLastError();
}
