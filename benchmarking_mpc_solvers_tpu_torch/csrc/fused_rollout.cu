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
//
// The dummy family past Dummy<8> (make_dummy_model(S, 1), identity
// dynamics: the state stays x0) takes one of two forms, picked on the host
// by ops/fused.py: dummy_plan. The rows form, for S up to 32 and a list of
// every state square with or without action terms (the identity's among
// them): the state in registers, the weights as kernel parameters, the
// goals staged in shared memory; a step is the float operations of its
// terms and a few loads (5.4x the list form at S = 16). The list form for
// every other list and S: the term list, the state and the goals from
// device memory at every term of every step (models.cuh: dummy_cost).
//
// The two-stage tiers' noise draw, scenario_normals_kernel, replaces no TPU
// kernel: the JAX package's batched tiers draw from per-scenario jax.random
// keys in XLA, which has no counterpart here. It draws the port's
// per-scenario stream (ops/fused_mppi.py:scenario_normals_reference, a uint32
// hash emulated in int64 by some hundred PyTorch launches over (B, K, W)):
// entry (b, k, w) of its (B, K, W) output is the normal of counters 2k,
// 2k + 1 at step w of scenario b's stream, the hash of its seed's low word,
// draw count and seed's high word. It rounds as that version does on the
// card, bit for bit: the draw functions of models.cuh, then one product by
// the scale.
// Bound on the H100: at the noise cell's shape (B*K = 655,360, W = 50) the
// 131 MB of stores take 0.039 ms at 3.35 TB/s; the 32.8 M normals' ~10 float
// ops each take 0.005 ms at 67 TFLOP/s; a normal is some hundred instructions
// of hash, libm forms and integer bookkeeping, so the rate at which the SMs
// issue them comes first (chip_smoke.py counts the loop and prints that floor).
// Design: a warp per 32 columns (b, k), whose W-long rows are one run of
// 32 * W floats in memory: each lane hashes one column's stream once, and the
// warp walks the run, lanes on neighbouring elements so that every store is
// one whole line, each lane taking its element's column base and sample index
// from the lane that hashed it (a shuffle). No shared memory.
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

// The dummy family at any S, the list form (models.cuh: dummy_cost): the
// whole term list from device memory at every step, x_i of rollout n at
// x0[i * N + n] (the state stays x0). It takes every list and every S.
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

// The rows form of the dummy (ops/fused.py: dummy_plan): a list that is
// every state square (r, r), r < S, in order, each followed or not by its
// action term (r, S), then the action's square (S, S) or not; the
// identity's is the squares alone. Its weights are a kernel parameter, so a
// term's weight is an operand of its multiplication, not a load; d past S
// is -0.0f, and with x and g padded with +0 there the row adds -0.0f * (+0
// * +0) = -0.0f, which leaves every float as it is (NaN included): the rows
// compiled past S change no bit.
constexpr int kRowMax = 32;
struct DummyRows {
  float d[kRowMax];  // (r, r)
  float a[kRowMax];  // (r, S), where bit r of acts is set
  float s;           // (S, S), where square
  uint32_t acts;
  int square;
};

// Floats of a staged step of goals in the rows form at row width ROW:
// g_t[0..ROW) (zeros past S), then g_t[S] and three pad floats.
__host__ __device__ constexpr int rows_step_floats(int row) { return row + 4; }

// The most shared bytes a block of the rows form stages goals in: 24 KB
// leaves the SM's blocks to its registers (9 blocks of 256 threads fit 227
// KB); a longer horizon is staged in chunks of steps.
constexpr int kGoalBytes = 24 * 1024;

// The steps of goals a block of the rows form at row width `row` stages at
// a time over T steps (at least 1), and its shared bytes (fused_rollout_
// dummy_launch_config reports both).
int rows_chunk(int row, int T) {
  const int fit = kGoalBytes / (int)(sizeof(float) * rows_step_floats(row));
  return T < 1 ? 1 : (T < fit ? T : fit);
}
size_t rows_bytes(int row, int T) {
  return sizeof(float) * rows_step_floats(row) * rows_chunk(row, T);
}

// The rows form at S <= ROW: one thread a rollout, its state in ROW
// registers for the whole horizon (x_r at a compiled index: no local
// memory), the goals staged in shared memory a chunk of steps at a time
// (rows_chunk) and read as float4 broadcasts, step t+1's action loaded
// while step t computes. Each step
// adds the terms in quad_cost's order with dummy_cost's roundings, c = c +
// w * (zi * zj) from 0, then the clip: the same bits. kActs compiles the
// (r, S) terms' tests (the identity's list has none).
template <int ROW, bool kActs>
__global__ void __launch_bounds__(kThreads)
fused_rollout_dummy_rows_kernel(const float* __restrict__ x0, const float* __restrict__ us,
                                const float* __restrict__ gz, float* __restrict__ out, int T,
                                int N, int S, int chunk, const DummyRows w) {
  constexpr int kStep = rows_step_floats(ROW);
  extern __shared__ float4 goal4[];
  float* goal = reinterpret_cast<float*>(goal4);
  const int Z = S + 1;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  // a thread past N runs rollout N - 1 and stores nothing: every thread
  // stages and meets the barriers
  const int nr = min(n, N - 1);
  float x[ROW];
#pragma unroll
  for (int r = 0; r < ROW; ++r) x[r] = r < S ? x0[(size_t)r * N + nr] : 0.0f;
  const float* un = us + nr;  // this rollout's action of step t + 1
  float u_next = T > 0 ? *un : 0.0f;
  float acc = 0.0f;
  for (int t0 = 0; t0 < T; t0 += chunk) {
    const int steps = min(chunk, T - t0);
    __syncthreads();  // the previous chunk's goals are read
    for (int e = threadIdx.x; e < steps * kStep; e += kThreads) {
      const int k = e % kStep;
      const float* g = gz + (size_t)(t0 + e / kStep) * Z;
      goal[e] = k < S ? g[k] : (k == ROW ? g[S] : 0.0f);
    }
    __syncthreads();
#pragma unroll 1
    for (int i = 0; i < steps; ++i) {
      const float u = u_next;
      if (t0 + i + 1 < T) {
        un += N;
        u_next = *un;
      }
      const float4* rec = goal4 + i * (kStep / 4);
      float g[kStep];
#pragma unroll
      for (int q = 0; q < kStep / 4; ++q) {
        const float4 v = rec[q];
        g[4 * q] = v.x;
        g[4 * q + 1] = v.y;
        g[4 * q + 2] = v.z;
        g[4 * q + 3] = v.w;
      }
      const float za = u - g[ROW];
      float c = 0.0f;
#pragma unroll
      for (int r = 0; r < ROW; ++r) {
        const float zr = x[r] - g[r];
        c = c + w.d[r] * (zr * zr);
        if (kActs && ((w.acts >> r) & 1u)) c = c + w.a[r] * (zr * za);
      }
      if (w.square) c = c + w.s * (za * za);
      acc = acc + bmpc::clampf(c, -1e30f, 1e30f);
    }
  }
  if (n < N) out[n] = acc;
}

using RowsFn = void (*)(const float*, const float*, const float*, float*, int, int, int, int,
                        const DummyRows);

// The rows form's instance at a row width of 12 to 32 (a multiple of 4),
// or null.
RowsFn rows_kernel(int row, bool acts) {
#define BMPC_ROWS(R)                                                                      \
  case R:                                                                                 \
    return acts ? fused_rollout_dummy_rows_kernel<R, true>                                \
                : fused_rollout_dummy_rows_kernel<R, false>;
  switch (row) {
    BMPC_ROWS(12)
    BMPC_ROWS(16)
    BMPC_ROWS(20)
    BMPC_ROWS(24)
    BMPC_ROWS(28)
    BMPC_ROWS(32)
    default:
      return nullptr;
  }
#undef BMPC_ROWS
}

template <class M>
auto kernel_for(bool generic) {
  constexpr uint64_t kTerms = bmpc::compiled_terms<M>();
  return generic ? fused_rollout_kernel<M, 0> : fused_rollout_kernel<M, kTerms>;
}

// --- the two-stage tiers' noise draw -----------------------------------------

// The counter base of scenario b's stream at step 0: the stream is the hash
// of (the seed's low word, the draw count's low word, the seed's high word),
// the words of the int64 two's complement, as the int64 masks take them.
__device__ __forceinline__ uint32_t stream_base(const long long* __restrict__ seeds,
                                                const long long* __restrict__ calls, int b) {
  const uint64_t s = (uint64_t)seeds[b];
  const uint32_t c = (uint32_t)(uint64_t)calls[b];
  const uint32_t stream =
      bmpc::fmix32((uint32_t)s * bmpc::kSeedMul + c * bmpc::kStepMul + (uint32_t)(s >> 32));
  return stream * bmpc::kSeedMul;
}

// out (N, W), N = B*K: each warp draws 32 columns, n0 = its first, whose
// 32 * W floats are one run: lane j hashes column n0 + j's stream, then the
// lanes walk the run, lane l at elements c * W + w = l, l + 32, ..., each
// taking column c's counter base and sample index from lane c. A trip moves
// an element 32 on: dc columns and dw steps, and one column more where the
// step passes W.
__global__ void __launch_bounds__(kThreads)
scenario_normals_kernel(const long long* __restrict__ seeds,
                        const long long* __restrict__ calls, float* __restrict__ out, int N,
                        int K, int W, float scale) {
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kThreads + (threadIdx.x & ~31);
  if (n0 >= N) return;  // the whole warp
  const int cols = min(32, N - n0);
  const int n = n0 + min(lane, cols - 1);
  const int b = n / K;
  const uint32_t col_base = stream_base(seeds, calls, b);
  const uint32_t col_i1 = 2u * (uint32_t)(n - b * K);
  const int dc = 32 / W, dw = 32 - dc * W;
  float* o = out + (size_t)n0 * W;
  const int end = cols * W;
  int c = lane / W, w = lane - c * W;  // element e = c * W + w
  for (int e = lane; e - lane < end; e += 32) {  // every lane takes each trip's shuffles
    const uint32_t base = __shfl_sync(0xFFFFFFFFu, col_base, c & 31) +
                          (uint32_t)w * bmpc::kStepMul;
    const uint32_t i1 = __shfl_sync(0xFFFFFFFFu, col_i1, c & 31);
    if (e < end) o[e] = scale * bmpc::normal_at(base + i1, base + i1 + 1u);
    c += dc;
    w += dw;
    if (w >= W) {
      w -= W;
      ++c;
    }
  }
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

// The dummy's list form, at any S and list (ops/fused.py: dummy_plan): the
// arguments of fused_rollout_costs_launch with S and the device array of
// n_terms weight terms (_build.dummy_terms) in place of the model id and
// the host weights.
extern "C" int fused_rollout_dummy_launch(int S, const float* x0, const float* us,
                                          const float* gz, float* out, int T, int N,
                                          const int4* terms, int n_terms,
                                          cudaStream_t stream) {
  fused_rollout_dummy_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      x0, us, gz, out, T, N, S, terms, n_terms);
  return (int)cudaGetLastError();
}

// The dummy's rows form (ops/fused.py: dummy_plan): the arguments of
// fused_rollout_dummy_launch with the plan's row width (12 to 32), whether
// the list has (r, S) terms (acts) and the host struct of the rows' weights
// (DummyRows, void here: a parameter of a type in the unnamed namespace
// would give the entry point internal linkage) in place of the term list.
extern "C" int fused_rollout_dummy_rows_launch(int row, int acts, const float* x0,
                                               const float* us, const float* gz, float* out,
                                               int T, int N, int S, const void* w,
                                               cudaStream_t stream) {
  const RowsFn kernel = rows_kernel(row, acts != 0);
  if (kernel == nullptr || S > row) return (int)cudaErrorInvalidValue;
  kernel<<<(N + kThreads - 1) / kThreads, kThreads, rows_bytes(row, T), stream>>>(
      x0, us, gz, out, T, N, S, rows_chunk(row, T), *(const DummyRows*)w);
  return (int)cudaGetLastError();
}

// The dummy form's launch shape on the current card over T steps, into
// out[7]: threads (rollouts) per block, blocks, shared bytes per block,
// registers per thread, resident blocks per SM, local (stack and spill)
// bytes per thread and the steps of goals a block stages at a time (0:
// none). form 0: the rows form at (row, acts); 1: the list form. Returns a
// cudaError.
extern "C" int fused_rollout_dummy_launch_config(int form, int row, int acts, int T, int N,
                                                 int* out) {
  const void* kernel = nullptr;
  size_t smem = 0;
  int chunk = 0;
  if (form == 0) {
    kernel = (const void*)rows_kernel(row, acts != 0);
    smem = rows_bytes(row, T);
    chunk = rows_chunk(row, T);
  } else if (form == 1) {
    kernel = (const void*)fused_rollout_dummy_kernel;
  }
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const int vals[7] = {kThreads, (N + kThreads - 1) / kThreads, (int)smem, attr.numRegs,
                       per_sm, (int)attr.localSizeBytes, chunk};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}

// seeds, calls (B,) int64 and out (N, W) float32, contiguous, on the device;
// N = B*K, every normal multiplied by scale. Returns the launch's
// cudaGetLastError().
extern "C" int scenario_normals_launch(const long long* seeds, const long long* calls,
                                       float* out, int N, int K, int W, float scale,
                                       cudaStream_t stream) {
  if (N <= 0 || K <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  scenario_normals_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      seeds, calls, out, N, K, W, scale);
  return (int)cudaGetLastError();
}

// The draw's launch shape over N columns on the current card, into out[5]:
// threads per block, blocks, registers per thread, resident blocks per SM and
// local (stack and spill) bytes per thread. Returns a cudaError.
extern "C" int scenario_normals_launch_config(int N, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, scenario_normals_kernel);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scenario_normals_kernel, kThreads,
                                                    0);
  if (e != cudaSuccess) return (int)e;
  const int vals[5] = {kThreads, (N + kThreads - 1) / kThreads, attr.numRegs, per_sm,
                       (int)attr.localSizeBytes};
  for (int i = 0; i < 5; ++i) out[i] = vals[i];
  return 0;
}
