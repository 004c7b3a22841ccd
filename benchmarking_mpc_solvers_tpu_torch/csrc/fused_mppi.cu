// Single-kernel MPPI step for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarking_mpc_solvers_tpu/ops/fused_mppi.py:
// fused_mppi_step (kernel body :171). For each of B scenarios it does the
// whole MPPI update in one launch:
//   pass 1: K rollouts over T steps, each step drawing delta from the
//           counter-based noise stream, cost = clipped nonzero-W quadratic +
//           lambda/std^2 * u * (std*delta), dynamics without clipping u;
//   softmax: non-finite cost -> 1e30, beta = min_k, w = exp(-(c-beta)/lam)/sum;
//   pass 2: regenerate the same deltas, plan[t] += sum_k w_k * std * delta_k,t.
//
// Noise: the reference's interpret-mode stream (interp_normals), bit for bit.
// Scenario b sits where the reference's padded (T, 8, Bp/8) layout puts it:
// lanes = pick_lanes(B), C = Bp/8, s = b / C, col = b % C, pid = col / lanes,
// l = col % lanes; seed_c = seed + k*7919 + pid*104729 (uint32 wrap); the
// uniforms use counter indices s*lanes + l and (8+s)*lanes + l.
//
// Bound on the H100: arithmetic, not bytes. The step reads the (T, B) plan
// and (S, B) states and writes the (T, B) plan, ~3 MB at B=8192, T=50, while
// it does B*K*T = 13.1 M rollout steps, each with two hashes, logf, sqrtf,
// cosf, the model's sinf/cosf and ~40 other float ops, and pass 2 repeats
// the noise. Design: one warp per scenario, one lane per sample k (K=32 is
// one warp; other K loop in strides of 32), so the 8192 scenarios give
// 262144 threads, enough to fill 132 SMs. Costs and weights stay in shared
// memory (K floats per warp), beta and the weight sum are warp shuffles, and
// pass 2 regenerates delta from the stateless counter instead of caching
// K*T values; one warp reduction per t writes plan[t, b]. Faster designs
// (fewer transcendentals, occupancy tuning) are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "models.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <class M>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
fused_mppi_kernel(const float* __restrict__ plan, const float* __restrict__ x0,
                  const float* __restrict__ gz, float* __restrict__ out, int T,
                  int B, int K, float stdv, float ctrl_scale, float lam,
                  uint32_t seed, int lanes, int C, bmpc::QuadW q) {
  constexpr int S = M::S;
  constexpr int Z = S + 1;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // uniform per warp: shuffles below see full warps
  float* wk = smem + warp * K;

  const int s = b / C, col = b % C;
  const int pid = col / lanes, l = col % lanes;
  const uint32_t i1 = (uint32_t)(s * lanes + l);
  const uint32_t i2 = (uint32_t)((8 + s) * lanes + l);
  const uint32_t seed_p = seed + (uint32_t)pid * 104729u;

  float xs0[S];
#pragma unroll
  for (int i = 0; i < S; ++i) xs0[i] = x0[i * B + b];

  // pass 1: score each of this lane's samples
  float cmin = 1e30f;
  for (int k = lane; k < K; k += 32) {
    const uint32_t seed_c = seed_p + (uint32_t)k * 7919u;
    float x[S], xn[S], z[Z];
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = xs0[i];
    float acc = 0.0f;
    for (int t = 0; t < T; ++t) {
      const float sd = stdv * bmpc::interp_normal(seed_c, (uint32_t)t, i1, i2);
      const float u = plan[t * B + b] + sd;
      M::transform(x, u, z);
      float c = bmpc::quad_cost<Z>(z, gz + t * Z, q);
      c = c + ctrl_scale * (u * sd);
      M::dynamics(x, u, xn);
#pragma unroll
      for (int i = 0; i < S; ++i) x[i] = xn[i];
      acc = acc + c;
    }
    if (!isfinite(acc)) acc = 1e30f;  // failure guard
    wk[k] = acc;
    cmin = fminf(cmin, acc);
  }
  const float beta = warp_min(cmin);
  float wsum = 0.0f;
  for (int k = lane; k < K; k += 32) {
    const float w = expf(-(wk[k] - beta) / lam);
    wk[k] = w;
    wsum += w;
  }
  const float total = warp_sum(wsum);

  // pass 2: regenerate the same noise, accumulate the weighted update
  for (int t = 0; t < T; ++t) {
    float upd = 0.0f;
    for (int k = lane; k < K; k += 32) {
      const uint32_t seed_c = seed_p + (uint32_t)k * 7919u;
      const float d = bmpc::interp_normal(seed_c, (uint32_t)t, i1, i2);
      upd += (wk[k] / total) * (stdv * d);
    }
    upd = warp_sum(upd);
    if (lane == 0) out[t * B + b] = plan[t * B + b] + upd;
  }
}

}  // namespace

// plan/out (T, B), x0 (S, B), gz (T, S+1): float32, contiguous, on the device.
// w: host array of MAX_Z*MAX_Z upper-triangle cost weights. Returns the
// launch's cudaGetLastError().
extern "C" int fused_mppi_step_launch(int model_id, const float* plan,
                                      const float* x0, const float* gz,
                                      float* out, int T, int B, int K,
                                      float stdv, float ctrl_scale, float lam,
                                      uint32_t seed, int lanes, int C,
                                      const float* w, cudaStream_t stream) {
  bmpc::QuadW q;
  for (int i = 0; i < bmpc::kMaxZ * bmpc::kMaxZ; ++i) q.w[i] = w[i];
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const size_t smem = sizeof(float) * K * kWarpsPerBlock;
  BMPC_DISPATCH_MODEL(model_id,
      fused_mppi_kernel<M><<<grid, block, smem, stream>>>(
          plan, x0, gz, out, T, B, K, stdv, ctrl_scale, lam, seed, lanes, C, q));
  return (int)cudaGetLastError();
}
