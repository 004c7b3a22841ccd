// Single-kernel CEM refinement for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarking_mpc_solvers_tpu/ops/fused_cem.py:
// fused_cem_step (kernel body :111). For each of B scenarios it runs all
// max_iter CEM iterations in one launch; per iteration:
//   pass 1: K samples u = clip(mean_t + std_t*delta, lo, hi), each scored by
//           a horizon-T rollout (clipped nonzero-W quadratic stage cost);
//   select: non-finite cost -> 1e30, then n_elite rounds of masked-min with
//           exclusion offset 4*T*1e30; every tied candidate is marked and the
//           weights are 1/count;
//   pass 2: m1 = sum_k w_k u_k, m2 = sum_k w_k u_k^2 (in k order), then
//           std_e = sqrt(max(m2 - m1^2, 0)) and the alpha-smoothing of mean
//           and std. std starts at std0 on every call; no epsilon exit.
//
// Noise: the reference's interpret-mode stream, bit for bit, under the
// combined seed seed + it*15485863 + k*7919 + pid*104729 (uint32 wrap), with
// scenario b in the slot of the reference's padded (T, 8, Bp/8) tiling
// (lanes, C, pid, counter indices as in fused_mppi.cu).
//
// Bound on the H100: operations. At the CEM sweep shape (B=10240, K=64,
// T=50, max_iter=3, cart-pole) the kernel moves 4.3 MB (plan in and out,
// states), 1.3 us at 3.35 TB/s, while it does B*K*T*max_iter = 98 M rollout
// steps, each with one noise draw (two hashes, logf, sqrtf, cosf), the clip
// and the model's sinf/cosf, ~72 FP32 operations: 0.11 ms at 67 TFLOP/s.
// That count takes each libm call and division as one operation; on the
// card each is a sequence of instructions, and what bounds the kernel is
// the rate at which the SMs issue them (chip_smoke.py counts the rollout
// loop's instructions and prints that floor).
// Design: one warp per scenario, one lane per sample k (K=64 is two per
// lane), so 10240 scenarios give 327,680 threads. mean, std, costs, the
// elite mask and the elites' list sit in shared memory (2T + 3K words per
// warp); the selection is warp-shuffle minima. Pass 2 gives lane j the
// steps t = j, j+32, ... and sums over the elites in k order, as the
// reference does, so the moments round exactly as the plain version; it
// redraws the noise of the elite samples only (w = 0 adds nothing), from a
// list of their k built once per iteration by ballots, n_elite*T draws
// instead of caching K*T samples. The rollout issues few instructions a
// step beside its arithmetic:
// - the stage cost is compiled for the model's own nonzero weights
//   (M::kCostTerms), so a step neither tests the zero weights nor loads
//   their goals (cart-pole: 2 terms of 15);
// - the model takes the sine and cosine of an angle with one sincosf
//   (models.cuh), one argument reduction where there were two.
// Neither changes an operation of the sum, so the plan and the elite masks
// keep the bits of the parent and of the plain version.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "models.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr uint32_t kItStride = 15485863u, kKStride = 7919u, kPidStride = 104729u;

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
fused_cem_kernel(const float* __restrict__ plan, const float* __restrict__ x0,
                 const float* __restrict__ gz, float* __restrict__ out,
                 float* __restrict__ masks, int T, int B, int K, int n_elite,
                 int max_iter, float alpha, float one_minus_alpha, float std0,
                 float lo, float hi, uint32_t seed, int lanes, int C,
                 bmpc::QuadW q) {
  constexpr int S = M::S;
  constexpr int Z = S + 1;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // uniform per warp: shuffles below see full warps
  float* mean = smem + warp * (2 * T + 3 * K);
  float* stdv = mean + T;
  float* cost = stdv + T;
  float* sel = cost + K;
  int* elite = reinterpret_cast<int*>(sel + K);  // the elites' k, in k order

  const int s = b / C, col = b % C;
  const int pid = col / lanes, l = col % lanes;
  const uint32_t i1 = (uint32_t)(s * lanes + l);
  const uint32_t i2 = (uint32_t)((8 + s) * lanes + l);
  const uint32_t seed_p = seed + (uint32_t)pid * kPidStride;
  const float excl = (float)(4.0 * (double)T * 1e30);  // as the reference rounds it

  for (int t = lane; t < T; t += 32) {
    mean[t] = plan[t * B + b];
    stdv[t] = std0;
  }
  float xs0[S];
#pragma unroll
  for (int i = 0; i < S; ++i) xs0[i] = x0[i * B + b];
  __syncwarp();

  for (int it = 0; it < max_iter; ++it) {
    const uint32_t seed_it = seed_p + (uint32_t)it * kItStride;
    // pass 1: score this lane's samples
    for (int k = lane; k < K; k += 32) {
      const uint32_t seed_c = seed_it + (uint32_t)k * kKStride;
      float x[S], xn[S], z[Z];
#pragma unroll
      for (int i = 0; i < S; ++i) x[i] = xs0[i];
      float acc = 0.0f;
      for (int t = 0; t < T; ++t) {
        const float d = bmpc::interp_normal(seed_c, (uint32_t)t, i1, i2);
        const float u = bmpc::clampf(mean[t] + stdv[t] * d, lo, hi);
        M::transform(x, u, z);
        const float c = bmpc::quad_cost<Z, M::kCostTerms>(z, gz + t * Z, q);
        M::dynamics(x, u, xn);
#pragma unroll
        for (int i = 0; i < S; ++i) x[i] = xn[i];
        acc = acc + c;
      }
      cost[k] = isfinite(acc) ? acc : 1e30f;  // failure guard
      sel[k] = 0.0f;
    }
    __syncwarp();

    // select: n_elite rounds of masked-min; ties are all marked
    for (int j = 0; j < n_elite; ++j) {
      float m = INFINITY;
      for (int k = lane; k < K; k += 32) m = fminf(m, cost[k] + sel[k] * excl);
      m = warp_min(m);
      for (int k = lane; k < K; k += 32)
        if (cost[k] + sel[k] * excl == m && sel[k] < 0.5f) sel[k] = 1.0f;
      __syncwarp();
    }
    float cnt = 0.0f;
    for (int k = lane; k < K; k += 32) cnt += sel[k];
    const float wsum = fmaxf(warp_sum(cnt), 1.0f);
    if (masks != nullptr)
      for (int k = lane; k < K; k += 32) masks[((size_t)it * K + k) * B + b] = sel[k];
    // the elites' k in k order (a sample with w = 0 adds nothing to a moment)
    int n_sel = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const bool on = k0 + lane < K && sel[k0 + lane] != 0.0f;
      const unsigned m = __ballot_sync(0xffffffffu, on);
      if (on) elite[n_sel + __popc(m & ((1u << lane) - 1u))] = k0 + lane;
      n_sel += __popc(m);
    }
    __syncwarp();

    // pass 2: elite moments per t, summed over k in order
    for (int t = lane; t < T; t += 32) {
      float m1 = 0.0f, m2 = 0.0f;
      for (int e = 0; e < n_sel; ++e) {
        const int k = elite[e];
        const float w = sel[k] / wsum;
        const uint32_t seed_c = seed_it + (uint32_t)k * kKStride;
        const float d = bmpc::interp_normal(seed_c, (uint32_t)t, i1, i2);
        const float u = bmpc::clampf(mean[t] + stdv[t] * d, lo, hi);
        m1 = m1 + w * u;
        m2 = m2 + w * (u * u);
      }
      const float e_std = sqrtf(fmaxf(m2 - m1 * m1, 0.0f));
      mean[t] = alpha * mean[t] + one_minus_alpha * m1;
      stdv[t] = alpha * stdv[t] + one_minus_alpha * e_std;
    }
    __syncwarp();
  }
  for (int t = lane; t < T; t += 32) out[t * B + b] = mean[t];
}

}  // namespace

// plan/out (T, B), x0 (S, B), gz (T, S+1): float32, contiguous, on the device;
// masks (max_iter, K, B) float32 or null. w: host array of MAX_Z*MAX_Z
// upper-triangle cost weights, nonzero exactly at the model's kCostTerms.
// Returns the launch's cudaGetLastError().
extern "C" int fused_cem_step_launch(int model_id, const float* plan,
                                     const float* x0, const float* gz,
                                     float* out, float* masks, int T, int B,
                                     int K, int n_elite, int max_iter,
                                     float alpha, float one_minus_alpha,
                                     float std0, float lo, float hi,
                                     uint32_t seed, int lanes, int C,
                                     const float* w, cudaStream_t stream) {
  bmpc::QuadW q;
  for (int i = 0; i < bmpc::kMaxZ * bmpc::kMaxZ; ++i) q.w[i] = w[i];
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const size_t smem = sizeof(float) * (2 * T + 3 * K) * kWarpsPerBlock;
  BMPC_DISPATCH_MODEL(model_id, {
    // compiled for the model's own stage cost, the only one a registered
    // (frozen) model has: any other weights are refused
    if (bmpc::cost_terms(q) != M::kCostTerms) return (int)cudaErrorInvalidValue;
    const auto kernel = fused_cem_kernel<M>;
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<grid, block, smem, stream>>>(
        plan, x0, gz, out, masks, T, B, K, n_elite, max_iter, alpha,
        one_minus_alpha, std0, lo, hi, seed, lanes, C, q);
  });
  return (int)cudaGetLastError();
}

// The launch shape at (model, T, K, B) on the current card, into out[6]:
// threads per block, scenarios per block, blocks, shared bytes per block,
// registers per thread, resident blocks per SM. Returns a cudaError.
extern "C" int fused_cem_launch_config(int model_id, int T, int K, int B, int* out) {
  BMPC_DISPATCH_MODEL(model_id, {
    const auto kernel = fused_cem_kernel<M>;
    const int threads = 32 * kWarpsPerBlock;
    const int smem = (int)sizeof(float) * (2 * T + 3 * K) * kWarpsPerBlock;
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return (int)e;
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (e != cudaSuccess) return (int)e;
    const int vals[6] = {threads, kWarpsPerBlock, (B + kWarpsPerBlock - 1) / kWarpsPerBlock,
                         smem, attr.numRegs, per_sm};
    for (int i = 0; i < 6; ++i) out[i] = vals[i];
    return 0;
  });
}
