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
// Bound on the H100. Bytes: at iLQR's shape (n_alpha=10, B=1024, T=100,
// cart-pole) the function reads us, ks, Ks and xref once (B*T*(2 + 2S)
// floats, 4 MB) and writes us_hat and the costs (n_alpha*B*(T+1) floats,
// 4 MB), plus 16.5 MB of states with return_states: 2.5 us (7.4 us) at
// 3.35 TB/s, against 1.0 M rollout steps of ~75 FP32 operations, 1.2 us at
// 67 TFLOP/s. Neither is the floor: a candidate's horizon is a chain of T
// dependent steps (feedback, clip, the model's step; chip_smoke.py:
// linesearch_chain), and only 10,240 chains run side by side, fewer than
// the card's 132 SMs x 4 schedulers x 32 lanes. The time is T times that
// of one step, and with one warp to a scheduler every instruction a step
// issues, and every wait on memory in its path, adds to it.
//
// Design:
// - A block owns a group of G scenarios and up to 32 of their alphas
//   (Ab = min(n_alpha, 32), G = 32 / Ab, lowered until B / G covers the
//   SMs) and has two warps. Lane g*Ab + i of the chain warp is candidate
//   (alpha a0 + i, scenario b0 + g) and runs its horizon; the producer warp
//   moves the data. At iLQR's shape (n_alpha = 10, B = 1024) that is 342
//   blocks of 30 candidates, at SQP's (8, 1024) 256 of 32: about one chain
//   warp to a scheduler, whose step waits on nothing but its own chain.
// - The horizon's inputs are staged in shared memory in stages of 16 steps,
//   a ring of two: a scenario's us, ks, Ks and xref rows for a stage are
//   contiguous runs (16, 16, 16*S, 16*S floats), and the stage's g_z rows
//   one more. The producer copies stage n+1 with 4-byte cp.async (a run
//   starts at any 4-byte offset), consecutive lanes on consecutive floats,
//   while the chain runs stage n; one barrier a stage hands them over. The
//   Ab lanes of a scenario read the same shared words (a broadcast);
//   scenario strides are odd, so the G scenarios' words lie in different
//   banks. xref's row T is not copied.
// - A step's inputs are read from shared memory one step ahead into
//   registers; us + alpha*ks is formed there too, off the chain, in the
//   same order as the parent's sum.
// - The chain gathers its outputs in shared memory (u, and with xs_hat the
//   state before each step; two gathers, one filling while the other
//   drains), and the producer writes stage n-1's as contiguous runs of each
//   candidate's row while the chain runs stage n. The cost, the last state
//   and the terminal cost are written by the chain lanes once.
// - The step issues little beside its arithmetic: the stage cost is
//   compiled for the model's own nonzero weights (M::kCostTerms; other
//   weights take the same kernel with the generic cost, models.cuh:
//   generic_cost), and the model takes an angle's sine and cosine with one
//   sincosf (models.cuh).
// Every candidate's arithmetic is the parent's, operation for operation, so
// every output keeps the parent's bits and the plain version's. (Measured
// against it on the same inputs, slower at iLQR's shape: the chain warp
// doing its own copies with one warp a block; the producer also taking the
// stage costs from the gathered states, a stage behind the chain.)
#include <cuda_runtime.h>

#include "models.cuh"

namespace {

constexpr int kLanes = 32;         // candidates a block holds at most: the chain warp
constexpr int kThreads = 2 * kLanes;  // the chain warp, then the producer warp
constexpr int kChunk = 16;         // steps per stage
constexpr int kStages = 2;         // stages in the input ring; the gathers are two as well

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Shared-memory layout of a block of G scenarios at state size S, in
// floats. One stage of the input ring: per scenario (stride kScen, odd) us,
// ks, Ks, xref for kChunk steps; then the stage's g_z rows. Then two
// gathers of the chain's outputs, per candidate lane (odd strides): kChunk
// controls and kChunk states.
template <int S>
struct Layout {
  static constexpr int Z = S + 1;
  static constexpr int kUs = 0, kKs = kChunk, kK = 2 * kChunk, kXr = kK + kChunk * S,
                       kScen = (kXr + kChunk * S) | 1;
  static constexpr int kUStride = kChunk | 1, kXStride = (kChunk * S) | 1,
                       kGather = kLanes * (kUStride + kXStride);
  int G;
  __host__ __device__ int gz() const { return G * kScen; }
  __host__ __device__ int stage() const { return G * kScen + kChunk * Z; }
  __host__ __device__ int gather(int n) const { return kStages * stage() + (n % 2) * kGather; }
  __host__ __device__ int floats() const { return kStages * stage() + 2 * kGather; }
};

// The current card's SMs, asked once.
int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// The launch shape at (n_a, B): alphas per block, scenarios per block, as
// many scenarios as fill the chain warp while the blocks still cover every
// SM.
void shape(int n_a, int B, int& Ab, int& G) {
  Ab = n_a < kLanes ? n_a : kLanes;
  G = kLanes / Ab;
  while (G > 1 && (B + G - 1) / G < sm_count()) --G;
}

template <class M, uint64_t kTerms>
__global__ void __launch_bounds__(kThreads)
fused_linesearch_kernel(const float* __restrict__ alphas, const float* __restrict__ x0,
                        const float* __restrict__ us, const float* __restrict__ ks,
                        const float* __restrict__ Ks, const float* __restrict__ xref,
                        const float* __restrict__ gz, float* __restrict__ us_hat,
                        float* __restrict__ costs, float* __restrict__ xs_hat, int n_a,
                        int B, int T, int Ab, int G, float lo, float hi, int with_terminal,
                        bmpc::QuadW q, bmpc::QuadW q_term) {
  constexpr int S = M::S;
  constexpr int Z = S + 1;
  using L = Layout<S>;
  extern __shared__ float smem[];
  const L lay{G};
  const int nc = G * Ab;  // the block's candidates
  const bool chain = threadIdx.x < kLanes;
  const int lane = threadIdx.x % kLanes;  // the chain's candidate, or the producer's
  const int g = lane / Ab, ai = lane - g * Ab;
  const int b0 = blockIdx.x * G, a0 = blockIdx.y * Ab;
  const int b = b0 + g, a = a0 + ai;
  const bool live = lane < nc && b < B && a < n_a;
  const int nst = (T + kChunk - 1) / kChunk;

  // producer: stage n's inputs into ring slot n % kStages, a scenario's
  // runs by consecutive lanes
  auto issue = [&](int n) {
    float* st = smem + (n % kStages) * lay.stage();
    const int t0 = n * kChunk, len = min(kChunk, T - t0);
    for (int gg = 0; gg < G; ++gg) {
      const size_t bb = (size_t)min(b0 + gg, B - 1);
      float* dst = st + gg * L::kScen;
      for (int k = lane; k < len; k += kLanes) {
        cp_async4(dst + L::kUs + k, us + bb * T + t0 + k);
        cp_async4(dst + L::kKs + k, ks + bb * T + t0 + k);
      }
      for (int k = lane; k < len * S; k += kLanes) {
        cp_async4(dst + L::kK + k, Ks + (bb * T + t0) * S + k);
        cp_async4(dst + L::kXr + k, xref + (bb * (T + 1) + t0) * S + k);
      }
    }
    for (int k = lane; k < len * Z; k += kLanes) cp_async4(st + lay.gz() + k, gz + t0 * Z + k);
    cp_async_commit();
  };
  // producer: stage n's gathered outputs to their rows, a candidate's run
  // by consecutive lanes
  auto drain = [&](int n) {
    const float* gu = smem + lay.gather(n);
    const float* gx = gu + kLanes * L::kUStride;
    const int t0 = n * kChunk, len = min(kChunk, T - t0);
    for (int cand = 0, cg = 0, ca = 0; cand < nc; ++cand) {
      if (b0 + cg < B && a0 + ca < n_a) {
        const size_t row = (size_t)(a0 + ca) * B + b0 + cg;
        for (int j = lane; j < len; j += kLanes)
          us_hat[row * T + t0 + j] = gu[cand * L::kUStride + j];
        if (xs_hat != nullptr)
          for (int k = lane; k < len * S; k += kLanes)
            xs_hat[(row * (T + 1) + t0) * S + k] = gx[cand * L::kXStride + k];
      }
      if (++ca == Ab) ca = 0, ++cg;
    }
  };

  float x[S], xn[S], z[Z];
  float acc = 0.0f;
  const float alpha = alphas[min(a, n_a - 1)];
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = x0[(size_t)min(b, B - 1) * S + i];
  if (!chain && nst > 0) {
    issue(0);
    cp_async_wait_all();
  }
  for (int n = 0; n < nst; ++n) {
    // stage n has landed; the chain is done with stage n-1, whose ring slot
    // is free and whose gather is full
    __syncthreads();
    if (chain) {
      const int len = min(kChunk, T - n * kChunk);
      const float* st = smem + (n % kStages) * lay.stage();
      const float* sc = st + (lane < nc ? g : 0) * L::kScen;
      const float* sgz = st + lay.gz();
      float* gu = smem + lay.gather(n) + lane * L::kUStride;
      float* gx = smem + lay.gather(n) + kLanes * L::kUStride + lane * L::kXStride;
      // step j's inputs, read one step ahead of the chain
      float base_n = sc[L::kUs] + alpha * sc[L::kKs];
      float k_n[S], xr_n[S];
#pragma unroll
      for (int i = 0; i < S; ++i) {
        k_n[i] = sc[L::kK + i];
        xr_n[i] = sc[L::kXr + i];
      }
      for (int j = 0; j < len; ++j) {
        const float base = base_n;
        float k[S], xr[S];
#pragma unroll
        for (int i = 0; i < S; ++i) {
          k[i] = k_n[i];
          xr[i] = xr_n[i];
        }
        const int jn = min(j + 1, len - 1);
        base_n = sc[L::kUs + jn] + alpha * sc[L::kKs + jn];
#pragma unroll
        for (int i = 0; i < S; ++i) {
          k_n[i] = sc[L::kK + jn * S + i];
          xr_n[i] = sc[L::kXr + jn * S + i];
        }
        float fb = 0.0f;
#pragma unroll
        for (int i = 0; i < S; ++i) fb = fb + k[i] * (x[i] - xr[i]);
        const float u = bmpc::clampf(base + fb, lo, hi);
        gu[j] = u;
        if (xs_hat != nullptr) {
#pragma unroll
          for (int i = 0; i < S; ++i) gx[j * S + i] = x[i];
        }
        M::transform(x, u, z);
        const float c = bmpc::quad_cost<Z, kTerms>(z, sgz + j * Z, q);
        M::dynamics(x, u, xn);
#pragma unroll
        for (int i = 0; i < S; ++i) x[i] = xn[i];
        acc = acc + c;
      }
    } else {
      if (n > 0) drain(n - 1);
      if (n + 1 < nst) {
        issue(n + 1);
        cp_async_wait_all();
      }
    }
  }
  __syncthreads();  // the last stage's gather is full
  if (!chain) {
    if (nst > 0) drain(nst - 1);
    return;
  }
  if (!live) return;
  const size_t n = (size_t)a * B + b;
  if (xs_hat != nullptr) {
#pragma unroll
    for (int i = 0; i < S; ++i) xs_hat[(n * (T + 1) + T) * S + i] = x[i];
  }
  if (with_terminal) {
    M::transform(x, 0.0f, z);
    acc = acc + bmpc::quad_cost<Z>(z, gz + (T - 1) * Z, q_term);
  }
  costs[n] = acc;
}

template <class M>
auto kernel_for(bool generic) {
  constexpr uint64_t kTerms = bmpc::compiled_terms<M>();
  return generic ? fused_linesearch_kernel<M, 0> : fused_linesearch_kernel<M, kTerms>;
}

template <class M>
int launch(const float* alphas, const float* x0, const float* us, const float* ks,
           const float* Ks, const float* xref, const float* gz, float* us_hat, float* costs,
           float* xs_hat, int n_a, int B, int T, float lo, float hi, int with_terminal,
           const bmpc::QuadW& q, const bmpc::QuadW& q_term, cudaStream_t stream) {
  int Ab, G;
  shape(n_a, B, Ab, G);
  const Layout<M::S> lay{G};
  const size_t smem = sizeof(float) * lay.floats();
  const auto kernel = kernel_for<M>(bmpc::generic_cost<M>(q));
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + G - 1) / G, (n_a + Ab - 1) / Ab);
  kernel<<<grid, kThreads, smem, stream>>>(
      alphas, x0, us, ks, Ks, xref, gz, us_hat, costs, xs_hat, n_a, B, T, Ab, G, lo, hi,
      with_terminal, q, q_term);
  return (int)cudaGetLastError();
}

}  // namespace

// alphas (n_a,), x0 (B, S), us/ks (B, T), Ks (B, T, S), xref (B, T+1, S),
// gz (T, S+1); out us_hat (n_a, B, T), costs (n_a, B), xs_hat
// (n_a, B, T+1, S) or null: float32, contiguous, on the device. w, w_term:
// host arrays of MAX_Z*MAX_Z upper-triangle stage and terminal cost weights
// (row stride MAX_Z). Returns the launch's cudaGetLastError().
extern "C" int fused_linesearch_launch(int model_id, const float* alphas,
                                       const float* x0, const float* us,
                                       const float* ks, const float* Ks,
                                       const float* xref, const float* gz,
                                       float* us_hat, float* costs, float* xs_hat,
                                       int n_a, int B, int T, float lo, float hi,
                                       int with_terminal, const float* w,
                                       const float* w_term, cudaStream_t stream) {
  const bmpc::QuadW q = bmpc::quad_w(w), q_term = bmpc::quad_w(w_term);
  int rc = 0;
  BMPC_DISPATCH_MODEL(model_id,
      rc = launch<M>(alphas, x0, us, ks, Ks, xref, gz, us_hat, costs, xs_hat, n_a, B, T, lo,
                     hi, with_terminal, q, q_term, stream));
  return rc;
}

// The launch shape at (model, n_a, B, stage weights w) on the current card,
// into out[8]: threads per block, scenarios and alphas per block, blocks,
// shared bytes per block, registers per thread, resident blocks per SM, and
// 1 where the stage cost is the generic form (0: compiled for the model's
// kCostTerms). Returns a cudaError.
extern "C" int fused_linesearch_launch_config(int model_id, int n_a, int B, const float* w,
                                              int* out) {
  const bmpc::QuadW q = bmpc::quad_w(w);
  BMPC_DISPATCH_MODEL(model_id, {
    int Ab, G;
    shape(n_a, B, Ab, G);
    const Layout<M::S> lay{G};
    const int smem = (int)sizeof(float) * lay.floats();
    const bool generic = bmpc::generic_cost<M>(q);
    const auto kernel = kernel_for<M>(generic);
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return (int)e;
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    const int vals[8] = {kThreads, G, Ab, ((B + G - 1) / G) * ((n_a + Ab - 1) / Ab), smem,
                         attr.numRegs, per_sm, generic ? 1 : 0};
    for (int i = 0; i < 8; ++i) out[i] = vals[i];
    return 0;
  });
}
