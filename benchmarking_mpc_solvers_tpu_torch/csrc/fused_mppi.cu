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
//   weights nor loads their goals (cart-pole: 2 terms of 15); other weights
//   (a reweighted plant, the dummy family) take the same kernel with the
//   generic cost, which tests each weight as it runs (same terms, same order);
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

template <class M, bool kCache, uint64_t kTerms>
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
      float c = bmpc::quad_cost<Z, kTerms>(z, gz + t * Z, q);
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

// Floats of a warp's shared memory in the dummy form: the kernel above's K
// weights and (with the cache) K*T noise values, after kTailOne's T
// four-float step records (rounded up to a float4, so the next warp's records
// stay aligned).
__host__ __device__ inline int dummy_warp_floats(int form, bool cache, int T, int K) {
  const int rest = K + (cache ? K * T : 0);
  return form == bmpc::kTailOne ? (4 * T + rest + 3) & ~3 : rest;
}

// The dummy family at any S: the kernel above with the state left at x0
// (identity dynamics) and the stage cost over the weights' term list, S and
// the terms as arguments. The noise, the softmax and pass 2 are the kernel
// above's, operation for operation. In kTailOne (models.cuh: DummyTail) the
// cost is split as in fused_cem.cu (models.cuh: dummy_lead): a prologue (a
// lane a step, t = lane, lane + 32, ...) sums the leading run of the terms
// once per (b, t) and stages it in a record with what the one term of the
// tail needs and the plan's value, and each of the K x T steps goes on from
// it. The plan's column is then read from device memory once per scenario: a
// step and pass 2 read the staged copy. kTailWhole runs dummy_cost over the
// whole list at each step and reads the plan from device memory.
template <bool kCache, int kForm>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
fused_mppi_dummy_kernel(const float* __restrict__ plan, const float* __restrict__ x0,
                        const float* __restrict__ gz, float* __restrict__ out, int T, int B,
                        int K, float stdv, float ctrl_scale, float lam, uint32_t seed,
                        int lanes, int C, int S, const int4* __restrict__ terms, int n_terms,
                        int n_lead) {
  constexpr bool kOne = kForm == bmpc::kTailOne;
  const int Z = S + 1;
  extern __shared__ float4 smem4[];  // float4: the step records' alignment
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // uniform per warp: shuffles below see full warps
  float* base = reinterpret_cast<float*>(smem4) + warp * dummy_warp_floats(kForm, kCache, T, K);
  // kTailOne's step t record: the leading run, g_t[S], x_i - g_t[i] where the
  // term is (i, S) with i < S, plan[t][b]
  float4* rec = reinterpret_cast<float4*>(base);
  float* wk = base + (kOne ? 4 * T : 0);
  float* sdk = wk + K;

  const int s = b / C, col = b % C;
  const int pid = col / lanes, l = col % lanes;
  const uint32_t i1 = (uint32_t)(s * lanes + l);
  const uint32_t i2 = (uint32_t)((8 + s) * lanes + l);
  const uint32_t seed_p = seed + (uint32_t)pid * kPidStride;
  const float* xb = x0 + b;  // x_i at xb[i * B], the whole horizon
  // kTailOne's term (i, S, w): i = S is the action's square
  const int4 one = kOne ? __ldg(terms + n_lead) : make_int4(0, 0, 0, 0);
  const float w1 = __int_as_float(one.z);
  const bool square = one.x == S;

  if (kOne) {
    for (int t = lane; t < T; t += 32) {
      const float* g = gz + t * Z;
      const float f = square ? 0.0f : xb[(size_t)one.x * B] - g[one.x];
      rec[t] = make_float4(bmpc::dummy_lead(xb, B, g, terms, n_lead), g[S], f, plan[t * B + b]);
    }
    __syncwarp();
  }

  float cmin = 1e30f;
  for (int k = lane; k < K; k += 32) {
    const uint32_t seed_c = seed_p + (uint32_t)k * kKStride;
    float acc = 0.0f;
    for (int t = 0; t < T; ++t) {
      const float sd = stdv * bmpc::interp_normal(seed_c, (uint32_t)t, i1, i2);
      if (kCache) sdk[t * K + k] = sd;
      float u, c;
      if (kOne) {
        const float4 r = rec[t];
        u = r.w + sd;
        const float za = u - r.y;
        const float zi = square ? za : r.z;
        c = bmpc::clampf(r.x + w1 * (zi * za), -1e30f, 1e30f);
      } else {
        u = plan[t * B + b] + sd;
        c = bmpc::dummy_cost(xb, B, S, u, gz + t * Z, terms, n_terms);
      }
      c = c + ctrl_scale * (u * sd);
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

  for (int t = 0; t < T; ++t) {
    float upd = 0.0f;
    for (int k = lane; k < K; k += 32) {
      const float sd = kCache ? sdk[t * K + k]
                              : stdv * bmpc::interp_normal(seed_p + (uint32_t)k * kKStride,
                                                           (uint32_t)t, i1, i2);
      upd += wk[k] * sd;
    }
    upd = warp_sum(upd);
    if (lane == 0) out[t * B + b] = (kOne ? rec[t].w : plan[t * B + b]) + upd;
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
KernelFn kernel_for(bool cache, bool generic) {
  if (generic) return cache ? fused_mppi_kernel<M, true, 0> : fused_mppi_kernel<M, false, 0>;
  constexpr uint64_t kTerms = bmpc::compiled_terms<M>();
  return cache ? fused_mppi_kernel<M, true, kTerms> : fused_mppi_kernel<M, false, kTerms>;
}

// Shared memory beyond the default 48 KB. The sweep's MPPI row asks for 52,224
// bytes; there blocks of 4 warps ran 2 % faster than blocks of 2 under 48 KB.
template <class F>
cudaError_t allow_smem(F kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

using DummyFn = void (*)(const float*, const float*, const float*, float*, int, int, int,
                         float, float, float, uint32_t, int, int, int, const int4*, int, int);

// A dummy launch's form (models.cuh: dummy_tail_form), its kernel and the
// dynamic shared bytes of a block. The cache is taken or not by K*T alone, as
// in the functors' form.
struct DummyShape {
  bool cache;
  int form;
  DummyFn kernel;
  size_t smem;
};

DummyShape dummy_shape(int T, int K, int n_terms, int n_lead) {
  const bool cache = shape_for(T, K).cache;
  const auto bytes = [&](int form) {
    return sizeof(float) * kWarpsPerBlock * dummy_warp_floats(form, cache, T, K);
  };
  const int form = bmpc::dummy_tail_form(n_terms, n_lead, bytes(bmpc::kTailOne));
  const DummyFn kernels[2][2] = {
      {fused_mppi_dummy_kernel<false, bmpc::kTailOne>,
       fused_mppi_dummy_kernel<false, bmpc::kTailWhole>},
      {fused_mppi_dummy_kernel<true, bmpc::kTailOne>,
       fused_mppi_dummy_kernel<true, bmpc::kTailWhole>}};
  return {cache, form, kernels[cache][form], bytes(form)};
}

}  // namespace

// plan/out (T, B), x0 (S, B), gz (T, S+1): float32, contiguous, on the device.
// w: host array of MAX_Z*MAX_Z upper-triangle cost weights (row stride
// MAX_Z). Returns the launch's cudaGetLastError().
extern "C" int fused_mppi_step_launch(int model_id, const float* plan,
                                      const float* x0, const float* gz,
                                      float* out, int T, int B, int K,
                                      float stdv, float ctrl_scale, float lam,
                                      uint32_t seed, int lanes, int C,
                                      const float* w, cudaStream_t stream) {
  const bmpc::QuadW q = bmpc::quad_w(w);
  const Shape sh = shape_for(T, K);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  BMPC_DISPATCH_MODEL(model_id, {
    const auto kernel = kernel_for<M>(sh.cache, bmpc::generic_cost<M>(q));
    const cudaError_t e = allow_smem(kernel, sh.smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, block, sh.smem, stream>>>(
        plan, x0, gz, out, T, B, K, stdv, ctrl_scale, lam, seed, lanes, C, q);
  });
  return (int)cudaGetLastError();
}

// The launch shape at (model, T, K, B, weights w) on the current card, into
// out[8]: threads per block, scenarios per block, blocks, shared bytes per
// block, registers per thread, resident blocks per SM, 1 where pass 2 reads
// the noise cache (0: it redraws), and 1 where the stage cost is the generic
// form (0: compiled for the model's kCostTerms). Returns a cudaError.
extern "C" int fused_mppi_launch_config(int model_id, int T, int K, int B, const float* w,
                                        int* out) {
  const Shape sh = shape_for(T, K);
  const bmpc::QuadW q = bmpc::quad_w(w);
  BMPC_DISPATCH_MODEL(model_id, {
    const bool generic = bmpc::generic_cost<M>(q);
    const auto kernel = kernel_for<M>(sh.cache, generic);
    const int threads = 32 * kWarpsPerBlock;
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e == cudaSuccess) e = allow_smem(kernel, sh.smem);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, sh.smem);
    if (e != cudaSuccess) return (int)e;
    const int vals[8] = {threads, kWarpsPerBlock, (B + kWarpsPerBlock - 1) / kWarpsPerBlock,
                         (int)sh.smem,
                         attr.numRegs, per_sm, sh.cache ? 1 : 0, generic ? 1 : 0};
    for (int i = 0; i < 8; ++i) out[i] = vals[i];
    return 0;
  });
}

// The dummy family at any S (the dummy form above): the arguments of
// fused_mppi_step_launch with S, the device array of n_terms weight terms and
// the length n_lead of their leading run (_build.dummy_terms) in place of the
// model id and the host weights.
extern "C" int fused_mppi_dummy_launch(int S, const float* plan, const float* x0,
                                       const float* gz, float* out, int T, int B, int K,
                                       float stdv, float ctrl_scale, float lam, uint32_t seed,
                                       int lanes, int C, const int4* terms, int n_terms,
                                       int n_lead, cudaStream_t stream) {
  const DummyShape sh = dummy_shape(T, K, n_terms, n_lead);
  const cudaError_t e = allow_smem(sh.kernel, sh.smem);
  if (e != cudaSuccess) return (int)e;
  sh.kernel<<<(B + kWarpsPerBlock - 1) / kWarpsPerBlock, 32 * kWarpsPerBlock, sh.smem,
              stream>>>(plan, x0, gz, out, T, B, K, stdv, ctrl_scale, lam, seed, lanes, C, S,
                        terms, n_terms, n_lead);
  return (int)cudaGetLastError();
}

// The dummy form's launch shape at (S, T, K, B, n_terms, n_lead) on the current
// card, into out[10]: threads per block, scenarios per block, blocks, shared
// bytes per block, registers per thread, resident blocks per SM, 1 where pass
// 2 reads the noise cache, the tail's form (models.cuh: DummyTail), the
// leading run a prologue sums and the terms a step adds (0 and n_terms in
// kTailWhole). Returns a cudaError.
extern "C" int fused_mppi_dummy_launch_config(int S, int T, int K, int B, int n_terms,
                                              int n_lead, int* out) {
  const DummyShape sh = dummy_shape(T, K, n_terms, n_lead);
  const int threads = 32 * kWarpsPerBlock;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, sh.kernel);
  if (e == cudaSuccess) e = allow_smem(sh.kernel, sh.smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sh.kernel, threads, sh.smem);
  if (e != cudaSuccess) return (int)e;
  const int lead = sh.form == bmpc::kTailWhole ? 0 : n_lead;
  const int vals[10] = {threads, kWarpsPerBlock, (B + kWarpsPerBlock - 1) / kWarpsPerBlock,
                        (int)sh.smem, attr.numRegs, per_sm, sh.cache ? 1 : 0, sh.form, lead,
                        n_terms - lead};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return 0;
}
