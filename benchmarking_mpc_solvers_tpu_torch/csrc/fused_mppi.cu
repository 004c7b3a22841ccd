// Single-kernel MPPI step for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarking_mpc_solvers_tpu/ops/fused_mppi.py:
// fused_mppi_step (kernel body :171). For each of B scenarios it does the
// whole MPPI update in one launch:
//   pass 1: K rollouts over T steps, each step drawing delta from the
//           counter-based noise stream, cost = clipped nonzero-W quadratic +
//           lambda/std^2 * u * (std*delta), dynamics without clipping u;
//   softmax: non-finite cost -> 1e30, beta = min_k, w = exp(-(c-beta)/lam)/sum;
//   pass 2: plan[t] += sum_k w_k * std * delta_k,t.
//
// Noise: the reference's interpret-mode stream (interp_normals), bit for bit.
// Scenario b sits where the reference's padded (T, 8, Bp/8) layout puts it:
// lanes = pick_lanes(B), C = Bp/8, s = b / C, col = b % C, pid = col / lanes,
// l = col % lanes; seed_c = seed + k*7919 + pid*104729 (uint32 wrap); the
// uniforms use counter indices s*lanes + l and (8+s)*lanes + l.
//
// Bound on the H100: the rate at which the SMs issue instructions. The step
// reads the (T, B) plan and (S, B) states and writes the (T, B) plan, ~3 MB
// at B=8192, T=50, while it does B*K*T = 13.1 M rollout steps, each with two
// hashes, logf, sqrtf, cosf, the model's sincosf and ~40 other float ops;
// each libm call and division is a sequence of instructions on the card
// (chip_smoke.py counts the rollout loop's and prints that floor).
// Design: one warp per scenario, one lane per sample k (K=32 is one warp;
// other K loop in strides of 32), so the 8192 scenarios give 262144
// threads. Costs and weights stay in shared memory (K floats per warp),
// beta and the weight sum are warp shuffles, and one butterfly per t writes
// plan[t, b]. A step issues few instructions beside its arithmetic:
// - the stage cost is compiled for the model's own nonzero weights
//   (M::kCostTerms, as fused_cem.cu), so a step neither tests the zero
//   weights nor loads their goals (cart-pole: 2 terms of 15);
// - pass 1 keeps each std*delta in shared memory, [t][k] per scenario (a
//   warp's 32 stores and loads fall in 32 banks), and pass 2 reads them back,
//   as the TPU kernel caches its noise in VMEM (cache_noise): no second draw.
//   Where K*T*4 bytes exceed kCacheBytes the same kernel redraws the noise in
//   pass 2 instead (the TPU kernel's form when the cache does not fit);
// - a sample's weight w_k / sum is divided once per k, not once per (k, t).
// None changes an operation of the sums, so the plan keeps its bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "models.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr uint32_t kKStride = 7919u, kPidStride = 104729u;
// The largest noise cache of one scenario, K*T*4 bytes. Shared memory sets
// how many scenarios (warps) an SM holds, and so how much latency the other
// warps hide. Device ms of the cache against the redraw form (H100; B =
// 8192, the sweep's MPPI row B = 10240; kernel_ab.py builds each form with
// -DFUSED_MPPI_CACHE_BYTES=0 and a large value):
//   K=32 T=50   6,400 bytes, 32 an SM: 0.1562 against 0.1856
//   K=64 T=50  12,800 bytes, 16 an SM: 0.4139 against 0.4254
//   K=32 T=110 14,080 bytes, 16 an SM: 0.4170 against 0.4013
//   K=48 T=90  17,280 bytes, 12 an SM: 0.8047 against 0.6161
//   K=64 T=128 32,768 bytes,  4 an SM: 2.1818 against 0.8752
// The split lies between 12,800 and 14,080 bytes; above 13 KB the kernel
// redraws the noise.
#ifndef FUSED_MPPI_CACHE_BYTES
#define FUSED_MPPI_CACHE_BYTES (13 * 1024)
#endif
constexpr size_t kCacheBytes = FUSED_MPPI_CACHE_BYTES;

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

template <class M, bool kCache>
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
  float* wk = smem + warp * (K + (kCache ? K * T : 0));
  float* sdk = wk + K;  // the cache: std*delta of (k, t) at sdk[t*K + k]

  const int s = b / C, col = b % C;
  const int pid = col / lanes, l = col % lanes;
  const uint32_t i1 = (uint32_t)(s * lanes + l);
  const uint32_t i2 = (uint32_t)((8 + s) * lanes + l);
  const uint32_t seed_p = seed + (uint32_t)pid * kPidStride;

  float xs0[S];
#pragma unroll
  for (int i = 0; i < S; ++i) xs0[i] = x0[i * B + b];

  // pass 1: score each of this lane's samples
  float cmin = 1e30f;
  for (int k = lane; k < K; k += 32) {
    const uint32_t seed_c = seed_p + (uint32_t)k * kKStride;
    float x[S], xn[S], z[Z];
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = xs0[i];
    float acc = 0.0f;
    for (int t = 0; t < T; ++t) {
      const float sd = stdv * bmpc::interp_normal(seed_c, (uint32_t)t, i1, i2);
      if (kCache) sdk[t * K + k] = sd;
      const float u = plan[t * B + b] + sd;
      M::transform(x, u, z);
      float c = bmpc::quad_cost<Z, M::kCostTerms>(z, gz + t * Z, q);
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
  for (int k = lane; k < K; k += 32) wk[k] = wk[k] / total;
  // a lane reads back only the weights and noise it wrote: no barrier

  // pass 2: the weighted update, summed over this lane's k in order, then
  // across the warp
  for (int t = 0; t < T; ++t) {
    float upd = 0.0f;
    for (int k = lane; k < K; k += 32) {
      const float sd = kCache ? sdk[t * K + k]
                              : stdv * bmpc::interp_normal(seed_p + (uint32_t)k * kKStride,
                                                           (uint32_t)t, i1, i2);
      upd += wk[k] * sd;
    }
    upd = warp_sum(upd);
    if (lane == 0) out[t * B + b] = plan[t * B + b] + upd;
  }
}

// How a launch at (T, K) is cut: the noise cache or the redraw, and the
// dynamic shared bytes of a block (K weights and, with the cache, K*T noise
// values per warp).
struct Shape {
  bool cache;
  size_t smem;
};

Shape shape_for(int T, int K) {
  const size_t cache = sizeof(float) * (size_t)K * T;
  const bool use = cache <= kCacheBytes;
  return {use, kWarpsPerBlock * (sizeof(float) * K + (use ? cache : 0))};
}

using KernelFn = void (*)(const float*, const float*, const float*, float*, int, int, int,
                          float, float, float, uint32_t, int, int, bmpc::QuadW);

template <class M>
KernelFn kernel_for(bool cache) {
  return cache ? fused_mppi_kernel<M, true> : fused_mppi_kernel<M, false>;
}

// Shared memory beyond the default 48 KB. The sweep's MPPI row asks for 52,224
// bytes; there blocks of 4 warps ran 2 % faster than blocks of 2 under 48 KB.
template <class F>
cudaError_t allow_smem(F kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// plan/out (T, B), x0 (S, B), gz (T, S+1): float32, contiguous, on the device.
// w: host array of MAX_Z*MAX_Z upper-triangle cost weights, nonzero exactly
// at the model's kCostTerms. Returns the launch's cudaGetLastError().
extern "C" int fused_mppi_step_launch(int model_id, const float* plan,
                                      const float* x0, const float* gz,
                                      float* out, int T, int B, int K,
                                      float stdv, float ctrl_scale, float lam,
                                      uint32_t seed, int lanes, int C,
                                      const float* w, cudaStream_t stream) {
  bmpc::QuadW q;
  for (int i = 0; i < bmpc::kMaxZ * bmpc::kMaxZ; ++i) q.w[i] = w[i];
  const Shape sh = shape_for(T, K);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  BMPC_DISPATCH_MODEL(model_id, {
    // compiled for the model's own stage cost, the only one a registered
    // (frozen) model has: any other weights are refused
    if (bmpc::cost_terms(q) != M::kCostTerms) return (int)cudaErrorInvalidValue;
    const auto kernel = kernel_for<M>(sh.cache);
    const cudaError_t e = allow_smem(kernel, sh.smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, block, sh.smem, stream>>>(
        plan, x0, gz, out, T, B, K, stdv, ctrl_scale, lam, seed, lanes, C, q);
  });
  return (int)cudaGetLastError();
}

// The launch shape at (model, T, K, B) on the current card, into out[7]:
// threads per block, scenarios per block, blocks, shared bytes per block,
// registers per thread, resident blocks per SM, and 1 where pass 2 reads the
// noise cache (0: it redraws). Returns a cudaError.
extern "C" int fused_mppi_launch_config(int model_id, int T, int K, int B, int* out) {
  const Shape sh = shape_for(T, K);
  BMPC_DISPATCH_MODEL(model_id, {
    const auto kernel = kernel_for<M>(sh.cache);
    const int threads = 32 * kWarpsPerBlock;
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e == cudaSuccess) e = allow_smem(kernel, sh.smem);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, sh.smem);
    if (e != cudaSuccess) return (int)e;
    const int vals[7] = {threads, kWarpsPerBlock, (B + kWarpsPerBlock - 1) / kWarpsPerBlock,
                         (int)sh.smem,
                         attr.numRegs, per_sm, sh.cache ? 1 : 0};
    for (int i = 0; i < 7; ++i) out[i] = vals[i];
    return 0;
  });
}
