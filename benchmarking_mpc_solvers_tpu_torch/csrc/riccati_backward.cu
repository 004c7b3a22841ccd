// Batched scalar-action Riccati backward pass for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarking_mpc_solvers_tpu/ops/riccati_pallas.py:
// riccati_backward_batch (kernel body :107). For each of B scenarios it runs
// the whole backward recursion over the horizon in one launch: the Q-terms,
// the mu-regularised gain solve (q_uu + mu*sum f_u^2, q_ux + mu*f_u^T f_x),
// the Q_uu > 0 check (check_pd: a failed step divides by 1 and goes on; ok is
// the conjunction over t), the UNregularised value recursion with V_xx
// symmetrised every step, and with c the affine residual (V_x + V_xx c).
// Each sum is taken in the reference kernel's order, starting from 0, so
// with --fmad=false the kernel rounds as the plain PyTorch version does.
//
// Bound on the H100. Bytes: at iLQR's shape (B=1024, T=100, S=4) the kernel
// reads ~46 floats per (scenario, t) (l_x, l_u, l_xx, l_uu, l_ux, f_x, f_u)
// and writes 5 (k, K): ~21 MB, 6 us at 3.35 TB/s, against ~0.6 k FP32
// operations per (scenario, t), 64 M in all, 1.0 us at 67 TFLOP/s. The
// horizon's loop-carried chain is as long: a step cannot start before the
// previous step's V_xx, and the path from one to the next runs through
// V_xx f_x, q_uu, the division for the gain and the new V_xx (23 dependent
// operations at S = 4, chip_smoke.py:riccati_chain; 100 of them in a row).
//
// Design:
// - S <= 4 (every model the port has): a group of G lanes per scenario, G
//   the power of two at or above S*S (16 at S = 4, two scenarios a warp),
//   lane a*S + b owning entry (a, b) of V_xx, of m = V_xx f_x, of q_xx and
//   of the new V_xx, and computing V_x[a] and the gains K[a], K[b]; every
//   lane computes the scalars (q_u, q_uu, the PD test, the inverse, k). The
//   row of V_xx, the columns of m and the vectors V_xx f_u and V_x + V_xx c
//   an entry needs come from their owners by __shfl_sync. Each value is
//   computed by one lane (or identically by several) in the plain version's
//   order, and shuffles move finished values, so nothing changes a bit. A
//   lane's step is then about half the instructions of a row per lane, and
//   at B = 1024 the 512 one-warp blocks put a warp on each of an SM's four
//   schedulers. Lanes S*S..G-1 compute a copy of entry (S-1, S-1) and store
//   nothing. (Measured against it on the same inputs, both slower at the
//   iLQR and SQP shapes: a row per lane, whose time a step's instruction
//   count set rather than its dependent chain; and one thread per scenario.)
// - S > 4, which no model of the port has: one thread per scenario owning
//   every entry, in blocks of 8 threads.
// - The horizon's inputs are staged in shared memory ahead of the chain: a
//   ring of two stages of C steps (C = 16 at S <= 4, else 4) for the block's
//   scenarios, walked downwards in t. A scenario's rows for a stage are one
//   contiguous run of each input (C*S*S floats of f_x, ...), copied by
//   consecutive threads with cp.async while the groups compute the other
//   stage, 16 bytes a thread where the run starts on 16 bytes (every input
//   but l_u and l_uu at S = 4, from a fresh allocation), else 4. The
//   recursion reads only shared memory and registers. A stage boundary
//   costs barriers, copies and the mu terms below, so stages are long: at
//   S = 4, 16 steps a stage ran faster than 8, and a third stage in the
//   ring did not.
// - Off the chain, once per stage: mu f_u^T f_x and mu f_u^T f_u of each of
//   its steps, spread over the group's lanes, so a step adds them to q_ux
//   and q_uu.
// - k and K are written per step by the lanes that own them; ok is written
//   once, as a bool (the type the caller returns).
// Groups past B compute on the last scenario's inputs and store nothing, so
// every lane takes part in every shuffle and barrier.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 2;  // stages in the ring

constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }
// strides of 4 modulo 32 floats: the 16-byte reads of a warp's groups fall
// in other banks, and every region starts on 16 bytes
constexpr int stride4(int n) { return (n + 27) / 32 * 32 + 4; }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int S>
struct Layout {
  static constexpr bool kEntry = S <= 4;                       // an entry per lane
  static constexpr int G = kEntry ? pow2_at_least(S * S) : 1;  // lanes per scenario
  static constexpr int kThreads = kEntry ? 32 : 8, kScen = kThreads / G;
  static constexpr int kChunk = S <= 4 ? 16 : 4;  // so every region below is whole float4s
  // one stage: per scenario kChunk steps of f_x, f_u, l_xx, l_x, l_ux, l_u, l_uu, c
  static constexpr int kFx = 0, kFu = kFx + kChunk * S * S, kLxx = kFu + kChunk * S,
                       kLx = kLxx + kChunk * S * S, kLux = kLx + kChunk * S,
                       kLu = kLux + kChunk * S, kLuu = kLu + kChunk, kC = kLuu + kChunk,
                       kScenStride = stride4(kC + kChunk * S), kStage = kScen * kScenStride;
  // per-scenario scratch: mu f_u^T f_x (S) and mu f_u^T f_u of each step of the stage
  static constexpr int kMuStep = S + 1, kGroupStride = stride4(kChunk * kMuStep),
                       kScratch = kStages * kStage;
  static constexpr int kBytes = (kScratch + kScen * kGroupStride) * (int)sizeof(float);
  static_assert(kBytes <= 48 * 1024, "the Riccati kernel's shared memory must fit the default");
};

struct Inputs {
  const float *l_x, *l_u, *l_xx, *l_uu, *l_ux, *f_x, *f_u, *c;
  int B, T;
};

// Copies the rows t0 .. t0 + kChunk - 1 of a batch-first array (rows_per_scen
// rows of PER floats per scenario) for the block's scenarios from b0 into
// dst (scenario s at dst + s * kScenStride). A scenario's rows are one
// contiguous run: consecutive threads take consecutive 16 bytes of it where
// the run starts on 16 bytes and lies in [0, T), else consecutive floats,
// with rows below 0 and scenarios past B clamped to real rows, whose copies
// nobody reads.
template <int S, int PER>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int rows_per_scen,
                                           int b0, int B, int t0) {
  using L = Layout<S>;
  constexpr int kRun = L::kChunk * PER;
  const size_t scen = (size_t)rows_per_scen * PER;
  if constexpr (PER % 4 == 0) {
    if (t0 >= 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0 && scen % 4 == 0) {
      const float* from = src + (size_t)t0 * PER;
      for (int e = threadIdx.x; e < L::kScen * (kRun / 4); e += L::kThreads) {
        const int s = e / (kRun / 4), k = 4 * (e - s * (kRun / 4));
        cp_async16(dst + s * L::kScenStride + k, from + (size_t)min(b0 + s, B - 1) * scen + k);
      }
      return;
    }
  }
  for (int e = threadIdx.x; e < kRun; e += L::kThreads) {
    const int j = e / PER;
    const int t = max(t0 + j, 0);
    const float* from = src + (size_t)t * PER + (e - j * PER);
#pragma unroll
    for (int s = 0; s < L::kScen; ++s)
      cp_async4(dst + s * L::kScenStride + e, from + (size_t)min(b0 + s, B - 1) * scen);
  }
}

// N floats from shared memory, 16 bytes at a time where N allows (the
// regions are laid out on 16 bytes).
template <int N>
__device__ __forceinline__ void load_shared(float (&out)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + i);
      out[i] = v.x;
      out[i + 1] = v.y;
      out[i + 2] = v.z;
      out[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = src[i];
  }
}

// Walks the horizon downwards for the block's scenarios, scenario g of the
// block on lanes e = 0..G-1: stages the inputs in the ring, computes each
// stage's mu terms into the scenario's scratch (value v of the stage by lane
// v mod G), then calls step(st, mus, j0, t) for t = T-1 .. 0, with st the
// scenario's stage, j0 the step's index in it and mus the step's mu terms.
template <int S, class Step>
__device__ __forceinline__ void walk_horizon(const Inputs& in, float mu_b, int g, int e,
                                             Step step) {
  using L = Layout<S>;
  constexpr int kChunk = L::kChunk;
  extern __shared__ float smem[];
  const int B = in.B, T = in.T;
  const int b0 = blockIdx.x * L::kScen;
  float* mus = smem + L::kScratch + g * L::kGroupStride;
  const int nchunks = (T + kChunk - 1) / kChunk;

  // chunk n holds steps T-1-n*kChunk down to T-(n+1)*kChunk (clamped at 0)
  auto issue = [&](int n) {
    if (n < nchunks) {
      float* st = smem + (n % kStages) * L::kStage;
      const int t0 = T - (n + 1) * kChunk;
      stage_rows<S, S * S>(st + L::kFx, in.f_x, T, b0, B, t0);
      stage_rows<S, S>(st + L::kFu, in.f_u, T, b0, B, t0);
      stage_rows<S, S * S>(st + L::kLxx, in.l_xx, T + 1, b0, B, t0);
      stage_rows<S, S>(st + L::kLx, in.l_x, T + 1, b0, B, t0);
      stage_rows<S, S>(st + L::kLux, in.l_ux, T, b0, B, t0);
      stage_rows<S, 1>(st + L::kLu, in.l_u, T, b0, B, t0);
      stage_rows<S, 1>(st + L::kLuu, in.l_uu, T, b0, B, t0);
      if (in.c != nullptr) stage_rows<S, S>(st + L::kC, in.c, T, b0, B, t0);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) issue(n);

  for (int n = 0; n < nchunks; ++n) {
    __syncthreads();  // every group is done with the stage that chunk n+1 refills
    issue(n + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();  // chunk n has landed, from every thread's copies
    const float* st = smem + (n % kStages) * L::kStage + g * L::kScenStride;
    // off the carried chain: mu * sum_i f_u[i] f_x[i][j] and mu * sum_i f_u[i]^2
    for (int v = e; v < kChunk * (S + 1); v += L::G) {
      const int jj = v / (S + 1), j = v - jj * (S + 1);
      const float* sfu = st + L::kFu + jj * S;
      const float* sfx = st + L::kFx + jj * S * S;
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < S; ++i) s = s + sfu[i] * (j < S ? sfx[i * S + j] : sfu[i]);
      mus[jj * L::kMuStep + j] = mu_b * s;
    }
    if constexpr (L::G > 1) __syncwarp();
    const int t_hi = T - 1 - n * kChunk, t_lo = max(T - (n + 1) * kChunk, 0);
    for (int t = t_hi; t >= t_lo; --t) {
      const int j0 = t - (T - (n + 1) * kChunk);  // the step's index in the stage
      step(st, mus + j0 * L::kMuStep, j0, t);
    }
  }
}

// 1 / q_uu_r for the gain solve; with check_pd a step whose q_uu_r is not
// > 0 divides by 1 and clears ok.
__device__ __forceinline__ float gain_inverse(float q_uu_r, int check_pd, bool& okb) {
  if (check_pd) {
    const bool pd = q_uu_r > 0.0f;
    okb = okb && pd;
    return 1.0f / (pd ? q_uu_r : 1.0f);
  }
  return 1.0f / q_uu_r;
}

// S <= 4: lane e = a*S + b of a scenario's group owns entry (a, b) of V_xx,
// m = V_xx f_x, q_xx and the new V_xx, and computes V_x[a], K[a] and K[b];
// rows and columns come from their owners by __shfl_sync.
template <int S>
__global__ void __launch_bounds__(32)
riccati_entry_kernel(Inputs in, const float* __restrict__ mu, float* __restrict__ ks,
                     float* __restrict__ Ks, bool* __restrict__ ok, int check_pd) {
  using L = Layout<S>;
  constexpr int G = L::G;
  constexpr unsigned kAll = 0xffffffffu;
  const int g = threadIdx.x / G, e = threadIdx.x % G;
  const int B = in.B, T = in.T;
  const int bc = min(blockIdx.x * L::kScen + g, B - 1);
  const bool live = blockIdx.x * L::kScen + g < B;
  const int ee = min(e, S * S - 1), a = ee / S, b = ee % S;
  const bool owner = e < S * S;
  const int base = g * G;  // lane (i, j) of the group is base + i * S + j
  const size_t bT = (size_t)bc * (T + 1) + T;
  float vxx_ab = in.l_xx[(bT * S + a) * S + b];
  float vx_a = in.l_x[bT * S + a];
  const float mu_b = mu[bc];
  bool okb = true;

  walk_horizon<S>(in, mu_b, g, e, [&](const float* st, const float* mus, int j0, int t) {
    const float* sfx = st + L::kFx + j0 * S * S;
    float fu[S], fxa[S], fxb[S], row[S];
    load_shared<S>(fu, st + L::kFu + j0 * S);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      fxa[i] = sfx[i * S + a];  // columns a and b of f_x
      fxb[i] = sfx[i * S + b];
      row[i] = __shfl_sync(kAll, vxx_ab, base + a * S + i);  // row a of V_xx
    }
    float m_ab = 0.0f, w_a = 0.0f, vxc_a = vx_a;
#pragma unroll
    for (int k = 0; k < S; ++k) m_ab = m_ab + row[k] * fxb[k];
#pragma unroll
    for (int k = 0; k < S; ++k) w_a = w_a + row[k] * fu[k];
    if (in.c != nullptr) {
      float cc[S];
      load_shared<S>(cc, st + L::kC + j0 * S);
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < S; ++k) s = s + row[k] * cc[k];
      vxc_a = vx_a + s;
    }
    // columns a and b of m, V_xx f_u and V_x + V_xx c from their owners
    float m_a[S], m_b[S], w[S], vxc[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      m_a[i] = __shfl_sync(kAll, m_ab, base + i * S + a);
      m_b[i] = __shfl_sync(kAll, m_ab, base + i * S + b);
      w[i] = __shfl_sync(kAll, w_a, base + i * S);
      vxc[i] = __shfl_sync(kAll, vxc_a, base + i * S);
    }
    float q_u = 0.0f, q_uu = 0.0f, s_a = 0.0f, s_b = 0.0f;
#pragma unroll
    for (int i = 0; i < S; ++i) q_u = q_u + fu[i] * vxc[i];
    q_u = st[L::kLu + j0] + q_u;
#pragma unroll
    for (int i = 0; i < S; ++i) q_uu = q_uu + fu[i] * w[i];
    q_uu = st[L::kLuu + j0] + q_uu;
#pragma unroll
    for (int i = 0; i < S; ++i) s_a = s_a + fu[i] * m_a[i];
#pragma unroll
    for (int i = 0; i < S; ++i) s_b = s_b + fu[i] * m_b[i];
    const float q_ux_a = st[L::kLux + j0 * S + a] + s_a;
    const float q_ux_b = st[L::kLux + j0 * S + b] + s_b;
    // mu enters the gain solve only
    const float inv = gain_inverse(q_uu + mus[S], check_pd, okb);
    const float k = -q_u * inv;
    const float K_a = -(q_ux_a + mus[a]) * inv;
    const float K_b = -(q_ux_b + mus[b]) * inv;
    // the UNregularised value recursion, V_xx symmetrised
    float sx = 0.0f, sxx = 0.0f;
#pragma unroll
    for (int i = 0; i < S; ++i) sx = sx + fxa[i] * vxc[i];
    const float q_x = st[L::kLx + j0 * S + a] + sx;
    vx_a = q_x + K_a * (q_uu * k + q_u) + q_ux_a * k;
#pragma unroll
    for (int i = 0; i < S; ++i) sxx = sxx + fxa[i] * m_b[i];
    const float q_xx = st[L::kLxx + j0 * S * S + a * S + b] + sxx;
    const float vnew = q_xx + K_a * q_uu * K_b + K_a * q_ux_b + q_ux_a * K_b;
    vxx_ab = 0.5f * (vnew + __shfl_sync(kAll, vnew, base + b * S + a));
    if (live && owner && b == 0) Ks[((size_t)bc * T + t) * S + a] = K_a;
    if (live && e == 0) ks[(size_t)bc * T + t] = k;
  });
  if (live && e == 0) ok[bc] = okb;
}

// S > 4: one thread per scenario, V_x and V_xx in registers, the same
// staging.
template <int S>
__global__ void __launch_bounds__(Layout<S>::kThreads)
riccati_thread_kernel(Inputs in, const float* __restrict__ mu, float* __restrict__ ks,
                      float* __restrict__ Ks, bool* __restrict__ ok, int check_pd) {
  using L = Layout<S>;
  const int g = threadIdx.x;
  const int B = in.B, T = in.T;
  const int bc = min(blockIdx.x * L::kScen + g, B - 1);
  const bool live = blockIdx.x * L::kScen + g < B;
  float vx[S], vxx[S][S];
  {
    const size_t bT = (size_t)bc * (T + 1) + T;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      vx[i] = in.l_x[bT * S + i];
#pragma unroll
      for (int k = 0; k < S; ++k) vxx[i][k] = in.l_xx[(bT * S + i) * S + k];
    }
  }
  const float mu_b = mu[bc];
  bool okb = true;

  walk_horizon<S>(in, mu_b, g, 0, [&](const float* st, const float* mus, int j0, int t) {
    const float* sfx = st + L::kFx + j0 * S * S;
    float fx[S][S], fu[S], vxc[S], w[S], m[S][S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      fu[i] = st[L::kFu + j0 * S + i];
#pragma unroll
      for (int k = 0; k < S; ++k) fx[i][k] = sfx[i * S + k];
    }
#pragma unroll
    for (int i = 0; i < S; ++i) {
      vxc[i] = vx[i];
      if (in.c != nullptr) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < S; ++k) s = s + vxx[i][k] * st[L::kC + j0 * S + k];
        vxc[i] = vx[i] + s;
      }
#pragma unroll
      for (int j = 0; j < S; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < S; ++k) s = s + vxx[i][k] * fx[k][j];
        m[i][j] = s;
      }
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < S; ++k) s = s + vxx[i][k] * fu[k];
      w[i] = s;
    }
    float q_u = 0.0f, q_uu = 0.0f, q_ux[S], K[S];
#pragma unroll
    for (int i = 0; i < S; ++i) q_u = q_u + fu[i] * vxc[i];
    q_u = st[L::kLu + j0] + q_u;
#pragma unroll
    for (int i = 0; i < S; ++i) q_uu = q_uu + fu[i] * w[i];
    q_uu = st[L::kLuu + j0] + q_uu;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < S; ++i) s = s + fu[i] * m[i][j];
      q_ux[j] = st[L::kLux + j0 * S + j] + s;
    }
    const float inv = gain_inverse(q_uu + mus[S], check_pd, okb);
    const float k = -q_u * inv;
#pragma unroll
    for (int j = 0; j < S; ++j) K[j] = -(q_ux[j] + mus[j]) * inv;
    float vnew[S][S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < S; ++i) s = s + fx[i][j] * vxc[i];
      vx[j] = (st[L::kLx + j0 * S + j] + s) + K[j] * (q_uu * k + q_u) + q_ux[j] * k;
#pragma unroll
      for (int jp = 0; jp < S; ++jp) {
        float s2 = 0.0f;
#pragma unroll
        for (int i = 0; i < S; ++i) s2 = s2 + fx[i][j] * m[i][jp];
        const float q_xx = st[L::kLxx + j0 * S * S + j * S + jp] + s2;
        vnew[j][jp] = q_xx + K[j] * q_uu * K[jp] + K[j] * q_ux[jp] + q_ux[j] * K[jp];
      }
      if (live) Ks[((size_t)bc * T + t) * S + j] = K[j];
    }
#pragma unroll
    for (int j = 0; j < S; ++j)
#pragma unroll
      for (int jp = 0; jp < S; ++jp) vxx[j][jp] = 0.5f * (vnew[j][jp] + vnew[jp][j]);
    if (live) ks[(size_t)bc * T + t] = k;
  });
  if (live) ok[bc] = okb;
}

template <class L, class Kernel>
int launch_kernel(Kernel kernel, const Inputs& in, const float* mu, float* ks, float* Ks,
                  bool* ok, int check_pd, cudaStream_t stream) {
  const dim3 grid((in.B + L::kScen - 1) / L::kScen);
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(in, mu, ks, Ks, ok, check_pd);
  return (int)cudaGetLastError();
}

template <int S>
int launch(const Inputs& in, const float* mu, float* ks, float* Ks, bool* ok, int check_pd,
           cudaStream_t stream) {
  using L = Layout<S>;
  if constexpr (L::kEntry) {
    return launch_kernel<L>(riccati_entry_kernel<S>, in, mu, ks, Ks, ok, check_pd, stream);
  } else {
    return launch_kernel<L>(riccati_thread_kernel<S>, in, mu, ks, Ks, ok, check_pd, stream);
  }
}

}  // namespace

// Batch-first float32 contiguous device arrays: l_x (B, T+1, S), l_u (B, T),
// l_xx (B, T+1, S, S), l_uu (B, T), l_ux (B, T, S), f_x (B, T, S, S),
// f_u (B, T, S), mu (B,), c (B, T, S) or null; out ks (B, T), Ks (B, T, S)
// float32 and ok (B,) bool. B, T >= 1; pointers 4-byte aligned. Returns the
// launch's cudaGetLastError().
extern "C" int riccati_backward_batch_launch(const float* l_x, const float* l_u,
                                             const float* l_xx, const float* l_uu,
                                             const float* l_ux, const float* f_x,
                                             const float* f_u, const float* mu,
                                             const float* c, float* ks, float* Ks,
                                             bool* ok, int B, int T, int S,
                                             int check_pd, cudaStream_t stream) {
  const Inputs in{l_x, l_u, l_xx, l_uu, l_ux, f_x, f_u, c, B, T};
  switch (S) {
#define BMPC_RICCATI_CASE(n) \
  case n:                    \
    return launch<n>(in, mu, ks, Ks, ok, check_pd, stream);
    BMPC_RICCATI_CASE(1)
    BMPC_RICCATI_CASE(2)
    BMPC_RICCATI_CASE(3)
    BMPC_RICCATI_CASE(4)
    BMPC_RICCATI_CASE(5)
    BMPC_RICCATI_CASE(6)
    BMPC_RICCATI_CASE(7)
    BMPC_RICCATI_CASE(8)
#undef BMPC_RICCATI_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
