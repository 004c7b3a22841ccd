// Batched Kalman filter and RTS smoother of the I2C solver for Hopper (sm_90a).
//
// Replaces the two TPU kernels of benchmarking_mpc_solvers_tpu/ops/
// i2c_pallas.py:i2c_smooth_batch: the forward filter (kernel body :121) and
// the backward smoother (kernel body :239). Over the augmented latent
// xi = (x, u) of size D with a feature observation of size Z:
//
//   filter, t = 0..T-1:  sig_y = J P J^T + R, gain L = P J^T sig_y^-1 by a
//     Z x Z Cholesky factorisation and two triangular solves per row,
//     mu_f = mu_p + L (g - (J mu_p + z0)), sig_f = sym(P - L J P), then the
//     prediction mu_n = m + F mu_f, sig_n = F sig_f F^T + Q;
//   smoother, t = T-2..0: G = sig_f F^T sig_pred^-1 by a D x D Cholesky solve,
//     mu_s = mu_f + G (mu_next - mu_pred), sig_s = sig_f + G (sig_next -
//     sig_pred) G^T, seeded with the filtered moments of t = T-1, which are
//     also the last output row.
//
// Every product, both factorisations and every triangular solve are written
// out here. Each sum is taken in the reference body's order (from 0 upwards,
// the other term added where the reference adds it), the Cholesky diagonal
// is floored at 1e-30 in a way that lets a NaN through (fmaxf would swallow
// it; the solver's failure guard needs it at the output), divisions are true
// divisions and sqrtf is the IEEE one, so with --fmad=false the kernels round
// as the plain PyTorch versions do.
//
// Bound on the H100. Per (scenario, t) the filter reads D^2 + D + ZD + Z
// floats and writes 2 (D + D^2); the smoother reads 2 (D + D^2) + D^2 and
// writes D: 246 MB and 184 MB at D = Z = 5, B = 10240, T = 50, 0.073 and
// 0.055 ms at 3.35 TB/s. Below a few thousand scenarios the horizon's
// loop-carried chain sets the bound instead: a filter step cannot start
// before the previous step's covariance, and the path between them runs
// through the Z x Z factorisation and the triangular solves (Z square roots
// and about 3Z divisions in a row, 46 dependent operations at D = Z = 3).
// The smoother's gain G does not depend on its carry, so its chain is only
// the covariance update (10 operations at D = 3).
//
// Design:
// - A group of 8 lanes per scenario, 4 scenarios per warp. Lane r < D owns
//   row r: of sig_p, P J^T, the gain and sig_f in the filter, of M = F sig_f,
//   G, G Dlt and sig_next in the smoother, and does that row's two
//   triangular solves. Rows that other lanes need go through a small
//   per-group scratch in shared memory under __syncwarp. A lane computes only
//   whole entries, each in the reference order, and shared memory moves
//   finished values, so nothing changes a bit. Lanes D..7 compute a copy of
//   row D-1 and store nothing.
// - Filter: every lane computes sig_y, its Cholesky factor, the innovation
//   and the predicted mean of its scenario redundantly (the same bits, no
//   shuffles inside the chain); P J^T and sf, with the filtered mean, are
//   shared: two __syncwarp per step.
// - Smoother: since G is off the carried chain, each stage's gains come
//   first. Lane j factors step j's sig_pred (one factorisation per lane, the
//   stage's steps in parallel), the owners solve their rows of every step of
//   the stage, back to back so that the independent solves overlap, and G
//   takes F's place in the stage. Then the carried recurrence runs over the
//   stage with one __syncwarp per step, sig_next and mu_next kept twice
//   (read one copy, write the other).
// - The horizon's inputs are staged in shared memory ahead of the chain: a
//   ring of two stages of a few time steps for the block's scenarios, whose
//   slabs are neighbours in the batch-first layout, filled by 4-byte
//   cp.async with commit/wait groups while the groups compute the other
//   stage; the smoother walks its stages downwards. g_z rides in each
//   stage (so no T bounds the shared memory); R and the carried means live
//   in the scratch, sig0 and Qproc rows in registers. TMA is not used: a
//   scenario's slab is T*D*D*4 bytes (900 at T = 25, D = 3), so slabs, row
//   strides and storage offsets are only 4-byte aligned in general, which
//   neither bulk copies nor 2-D tensor maps take.
// - Block shapes: the filter 2 warps with stages of 4 steps (18,176 bytes
//   of shared memory at D = Z = 5). The smoother 2 warps with stages of 4
//   steps where that leaves SMs idle (B = 256: 32 blocks), else 4 warps with
//   stages of 3 steps, so that at D = 5 the 20 warps per SM that B = 10240
//   asks for fit as 5 blocks of 44,224 bytes and the grid is one wave.
// - Each lane stores its row of D contiguous floats, so a group writes a
//   whole D x D block contiguously.
// - The card's IEEE division leaves its fast path for a zero dividend, and
//   these matrices hold structural zeros (F's action rows, features that
//   ignore a state); a zero's quotient is formed directly (div_rn).
// Groups past B compute on the last scenario's inputs and store nothing, so
// every thread takes part in every barrier.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kGroup = 8;   // lanes per scenario
constexpr int kStages = 2;  // stages in the ring
// Warps per block and time steps per stage. The smoother has two shapes:
// where B fills more SMs than the card has with 8 scenarios a block, 4 warps
// of 3 steps, so that at D = 5 the 20 warps per SM that B = 10240 asks for
// fit in an SM's shared memory as 5 blocks; else 2 warps of 4 steps, the
// shortest path per step, on as many SMs as the scenarios allow.
constexpr int kFilterWarps = 2, kFilterChunk = 4;
constexpr int kRtsWarps[2] = {2, 4}, kRtsChunk[2] = {4, 3};  // [wide]

// max(s, 1e-30) that keeps a NaN: the comparison is false for NaN.
__device__ __forceinline__ float floor_keep_nan(float s) { return s < 1e-30f ? 1e-30f : s; }

// a / b, correctly rounded. The card's division leaves its fast path for a
// zero dividend, and the I2C matrices hold structural zeros (the action
// rows of F, features that ignore a state). A zero's quotient is a zero
// with the sign of a times that of b, or NaN for a zero or NaN divisor.
__device__ __forceinline__ float div_rn(float a, float b) {
  if (a == 0.0f) return (b == 0.0f || isnan(b)) ? __int_as_float(0x7fffffff) : (signbit(b) ? -a : a);
  return a / b;
}

// Lower Cholesky factor of the symmetric N x N matrix A (its lower triangle
// is read), diagonal floored at 1e-30.
template <int N>
__device__ __forceinline__ void chol(const float (&A)[N][N], float (&L)[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = (i == j) ? sqrtf(floor_keep_nan(s)) : div_rn(s, L[j][j]);
    }
}

// x = (L L^T)^-1 b: forward then backward substitution.
template <int N>
__device__ __forceinline__ void chol_solve(const float (&L)[N][N], const float (&b)[N],
                                           float (&x)[N]) {
  float y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = div_rn(s, L[i][i]);
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s = s - L[k][i] * x[k];
    x[i] = div_rn(s, L[i][i]);
  }
}

// a[i] for a lane-dependent i, by selects (an indexed register array would
// go to local memory).
template <int N>
__device__ __forceinline__ float pick(const float (&a)[N], int i) {
  float v = a[0];
#pragma unroll
  for (int k = 1; k < N; ++k) v = (k == i) ? a[k] : v;
  return v;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies C time steps of a batch-first (B, T, PER) array for NS
// scenarios from b0 into dst (scenario s at dst + s * sstride, step j at
// j * PER): step j is time t0 + dir * j. Consecutive threads take
// consecutive floats of a scenario's run. Times outside [0, T) and
// scenarios past B are clamped to real rows, whose copies nobody reads.
template <int NT, int C, int NS, int PER>
__device__ __forceinline__ void stage_rows(float* dst, int sstride, const float* src, int b0,
                                           int B, int T, int t0, int dir) {
  constexpr int kRun = C * PER;
  for (int e = threadIdx.x; e < kRun; e += NT) {
    const int j = e / PER;
    const int t = min(max(t0 + dir * j, 0), T - 1);
    const float* from = src + (size_t)t * PER + (e - j * PER);
#pragma unroll
    for (int s = 0; s < NS; ++s)
      cp_async4(dst + s * sstride + e, from + (size_t)min(b0 + s, B - 1) * T * PER);
  }
}

constexpr int odd(int n) { return n | 1; }  // odd strides: a warp's 4 groups hit 4 banks

template <int D, int Z>
struct FilterLayout {
  static constexpr int kThreads = 32 * kFilterWarps, kScen = kThreads / kGroup,
                       kChunk = kFilterChunk;
  // one stage: per scenario F, m, J, z0 for kChunk steps; then g_z's rows
  static constexpr int kF = 0, kM = kChunk * D * D, kJ = kM + kChunk * D,
                       kZ0 = kJ + kChunk * Z * D, kScenStride = odd(kZ0 + kChunk * Z),
                       kGz = kScen * kScenStride, kStage = kGz + kChunk * Z;
  // per-group scratch: R, the rows of P J^T and sf, the filtered mean
  static constexpr int kR = 0, kPJ = Z * Z, kSF = kPJ + D * Z, kMF = kSF + D * D,
                       kGroupStride = odd(kMF + D), kScratch = kStages * kStage;
  static constexpr int kBytes = (kScratch + kScen * kGroupStride) * (int)sizeof(float);
  static_assert(kBytes <= 227 * 1024, "the filter's shared memory must fit one block");
};

template <int D, bool Wide>
struct RtsLayout {
  static constexpr int kThreads = 32 * kRtsWarps[Wide], kScen = kThreads / kGroup,
                       kChunk = kRtsChunk[Wide];
  // one stage: per scenario sig_f, sig_pred, F, mu_f, mu_pred for kChunk
  // steps; once a chunk's M is formed, G overwrites F
  static constexpr int kSf = 0, kSp = kChunk * D * D, kF = 2 * kChunk * D * D,
                       kMf = 3 * kChunk * D * D, kMp = kMf + kChunk * D,
                       kScenStride = odd(kMp + kChunk * D), kStage = kScen * kScenStride;
  // per-group scratch: the chunk's M and Cholesky factors (lower triangles),
  // sig_next and mu_next twice (read one, write the other)
  static constexpr int kTri = D * (D + 1) / 2;
  static constexpr int kMM = 0, kLL = kChunk * D * D, kSN = kLL + kChunk * kTri,
                       kMN = kSN + 2 * D * D, kGroupStride = odd(kMN + 2 * D),
                       kScratch = kStages * kStage;
  static constexpr int kBytes = (kScratch + kScen * kGroupStride) * (int)sizeof(float);
  static_assert(kBytes <= 227 * 1024, "the smoother's shared memory must fit one block");
};

template <int D, int Z>
__global__ void __launch_bounds__(FilterLayout<D, Z>::kThreads)
i2c_filter_kernel(const float* __restrict__ F, const float* __restrict__ m,
                  const float* __restrict__ J, const float* __restrict__ z0,
                  const float* __restrict__ R, int r_stride,
                  const float* __restrict__ mu0, const float* __restrict__ sig0,
                  const float* __restrict__ Qproc, const float* __restrict__ g_z,
                  float* __restrict__ mu_f_out, float* __restrict__ sig_f_out,
                  float* __restrict__ mu_pred_out, float* __restrict__ sig_pred_out,
                  int B, int T) {
  using L = FilterLayout<D, Z>;
  constexpr int kThreads = L::kThreads, kScen = L::kScen, kChunk = L::kChunk;
  extern __shared__ float smem[];
  const int g = threadIdx.x / kGroup, r = threadIdx.x % kGroup;
  const int b0 = blockIdx.x * kScen;
  const int bc = min(b0 + g, B - 1);
  const bool owner = r < D, live = owner && b0 + g < B;
  const int row = min(r, D - 1);
  float* sc = smem + L::kScratch + g * L::kGroupStride;
  const int nchunks = (T + kChunk - 1) / kChunk;

  auto issue = [&](int c) {
    if (c < nchunks) {
      float* st = smem + (c % kStages) * L::kStage;
      const int t0 = c * kChunk;
      stage_rows<kThreads, kChunk, kScen, D * D>(st + L::kF, L::kScenStride, F, b0, B, T, t0, 1);
      stage_rows<kThreads, kChunk, kScen, D>(st + L::kM, L::kScenStride, m, b0, B, T, t0, 1);
      stage_rows<kThreads, kChunk, kScen, Z * D>(st + L::kJ, L::kScenStride, J, b0, B, T, t0, 1);
      stage_rows<kThreads, kChunk, kScen, Z>(st + L::kZ0, L::kScenStride, z0, b0, B, T, t0, 1);
      stage_rows<kThreads, kChunk, 1, Z>(st + L::kGz, 0, g_z, 0, 1, T, t0, 1);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) issue(c);

  for (int i = r; i < Z * Z; i += kGroup) sc[L::kR + i] = R[(size_t)bc * r_stride + i];
  float mu_p[D], sig_p[D], q[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    mu_p[i] = mu0[(size_t)bc * D + i];
    sig_p[i] = sig0[row * D + i];
    q[i] = Qproc[row * D + i];
  }

  for (int c = 0; c < nchunks; ++c) {
    __syncthreads();  // every group is done with the stage that chunk c+1 refills
    issue(c + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();  // chunk c has landed, from every thread's copies
    const float* st = smem + (c % kStages) * L::kStage;
    const float* sF = st + L::kF + g * L::kScenStride;
    const float* sm = st + L::kM + g * L::kScenStride;
    const float* sJ = st + L::kJ + g * L::kScenStride;
    const float* sz0 = st + L::kZ0 + g * L::kScenStride;
    const float* sgz = st + L::kGz;
    const int n = min(kChunk, T - c * kChunk);
    for (int j = 0; j < n; ++j) {
      const size_t bt = (size_t)bc * T + c * kChunk + j;
      const float* Ft = sF + j * D * D;
      float Jt[Z][D];
#pragma unroll
      for (int a = 0; a < Z; ++a)
#pragma unroll
        for (int k = 0; k < D; ++k) Jt[a][k] = sJ[(j * Z + a) * D + k];
      // own row of P J^T
      float pj[Z];
#pragma unroll
      for (int a = 0; a < Z; ++a) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) s = s + sig_p[k] * Jt[a][k];
        pj[a] = s;
      }
      if (owner) {
#pragma unroll
        for (int a = 0; a < Z; ++a) sc[L::kPJ + r * Z + a] = pj[a];
      }
      __syncwarp();
      // sig_y = R + J P J^T (lower triangle) and its factor, in every lane
      float sig_y[Z][Z], Lc[Z][Z];
#pragma unroll
      for (int a = 0; a < Z; ++a)
#pragma unroll
        for (int cc = 0; cc <= a; ++cc) {
          float s = 0.0f;
#pragma unroll
          for (int k = 0; k < D; ++k) s = s + Jt[a][k] * sc[L::kPJ + k * Z + cc];
          sig_y[a][cc] = sc[L::kR + a * Z + cc] + s;
        }
      chol<Z>(sig_y, Lc);
      // own gain row: sig_y x = (P J^T)[row]
      float sol[Z];
      chol_solve<Z>(Lc, pj, sol);
      float innov[Z];
#pragma unroll
      for (int a = 0; a < Z; ++a) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) s = s + Jt[a][k] * mu_p[k];
        innov[a] = sgz[j * Z + a] - (s + sz0[j * Z + a]);
      }
      float mu_f;
      {
        float s = 0.0f;
#pragma unroll
        for (int a = 0; a < Z; ++a) s = s + sol[a] * innov[a];
        mu_f = pick<D>(mu_p, row) + s;
      }
      if (owner) {
#pragma unroll
        for (int jj = 0; jj < D; ++jj) {
          float s = 0.0f;
#pragma unroll
          for (int a = 0; a < Z; ++a) s = s + sol[a] * sc[L::kPJ + jj * Z + a];
          sc[L::kSF + r * D + jj] = sig_p[jj] - s;
        }
        sc[L::kMF + r] = mu_f;
      }
      __syncwarp();
      // sig_f = sym(sf), read from the group's rows; F sig_f, own row
      float fs[D];
#pragma unroll
      for (int jj = 0; jj < D; ++jj) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k)
          s = s + Ft[row * D + k] *
                      (0.5f * (sc[L::kSF + k * D + jj] + sc[L::kSF + jj * D + k]));
        fs[jj] = s;
      }
      if (live) {
        mu_f_out[bt * D + r] = mu_f;
#pragma unroll
        for (int jj = 0; jj < D; ++jj)
          sig_f_out[(bt * D + r) * D + jj] =
              0.5f * (sc[L::kSF + r * D + jj] + sc[L::kSF + jj * D + r]);
      }
      // predict: the whole mean in every lane, the own row of F sig_f F^T + Q
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) s = s + Ft[i * D + k] * sc[L::kMF + k];
        mu_p[i] = sm[j * D + i] + s;
      }
#pragma unroll
      for (int jj = 0; jj < D; ++jj) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) s = s + fs[k] * Ft[jj * D + k];
        sig_p[jj] = s + q[jj];
      }
      if (live) {
        mu_pred_out[bt * D + r] = pick<D>(mu_p, r);
#pragma unroll
        for (int jj = 0; jj < D; ++jj) sig_pred_out[(bt * D + r) * D + jj] = sig_p[jj];
      }
    }
  }
}

template <int D, bool Wide>
__global__ void __launch_bounds__(RtsLayout<D, Wide>::kThreads)
i2c_rts_kernel(const float* __restrict__ mu_f, const float* __restrict__ sig_f,
               const float* __restrict__ mu_pred, const float* __restrict__ sig_pred,
               const float* __restrict__ F, float* __restrict__ mu_s, int B, int T) {
  using L = RtsLayout<D, Wide>;
  constexpr int kThreads = L::kThreads, kScen = L::kScen, kChunk = L::kChunk;
  extern __shared__ float smem[];
  const int g = threadIdx.x / kGroup, r = threadIdx.x % kGroup;
  const int b0 = blockIdx.x * kScen;
  const int bc = min(b0 + g, B - 1);
  const bool owner = r < D, live = owner && b0 + g < B;
  const int row = min(r, D - 1);
  float* sc = smem + L::kScratch + g * L::kGroupStride;
  // chunk c holds t = T-2 - c*kChunk - j, j = 0..kChunk-1
  const int nchunks = (T - 1 + kChunk - 1) / kChunk;

  auto issue = [&](int c) {
    if (c < nchunks) {
      float* st = smem + (c % kStages) * L::kStage;
      const int hi = T - 2 - c * kChunk;
      stage_rows<kThreads, kChunk, kScen, D * D>(st + L::kSf, L::kScenStride, sig_f, b0, B, T, hi, -1);
      stage_rows<kThreads, kChunk, kScen, D * D>(st + L::kSp, L::kScenStride, sig_pred, b0, B, T, hi, -1);
      stage_rows<kThreads, kChunk, kScen, D * D>(st + L::kF, L::kScenStride, F, b0, B, T, hi, -1);
      stage_rows<kThreads, kChunk, kScen, D>(st + L::kMf, L::kScenStride, mu_f, b0, B, T, hi, -1);
      stage_rows<kThreads, kChunk, kScen, D>(st + L::kMp, L::kScenStride, mu_pred, b0, B, T, hi, -1);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) issue(c);

  // the carry starts from the filtered moments of t = T-1, the last output row
  {
    const size_t bl = (size_t)bc * T + (T - 1);
    if (owner) {
#pragma unroll
      for (int jj = 0; jj < D; ++jj) sc[L::kSN + r * D + jj] = sig_f[(bl * D + r) * D + jj];
      sc[L::kMN + r] = mu_f[bl * D + r];
    }
    if (live) mu_s[bl * D + r] = mu_f[bl * D + r];
  }

  int p = 0;  // which copy of sig_next and mu_next holds the carry
  for (int c = 0; c < nchunks; ++c) {
    __syncthreads();  // every group is done with the stage that chunk c+1 refills
    issue(c + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();  // chunk c has landed, from every thread's copies
    float* st = smem + (c % kStages) * L::kStage + g * L::kScenStride;
    const int hi = T - 2 - c * kChunk;
    const int n = min(kChunk, hi + 1);
    // The gains do not depend on the carry: form the whole chunk's first.
    // Own rows of M = F sig_f, and lane j factors step j's sig_pred.
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (owner && j < n) {
#pragma unroll
        for (int jj = 0; jj < D; ++jj) {
          float s = 0.0f;
#pragma unroll
          for (int k = 0; k < D; ++k)
            s = s + st[L::kF + j * D * D + r * D + k] * st[L::kSf + j * D * D + k * D + jj];
          sc[L::kMM + j * D * D + r * D + jj] = s;
        }
      }
    }
    {
      const int j = min(r, n - 1);
      float A[D][D], Lc[D][D];
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int jj = 0; jj <= i; ++jj) A[i][jj] = st[L::kSp + j * D * D + i * D + jj];
      chol<D>(A, Lc);
      if (r < n) {
#pragma unroll
        for (int i = 0; i < D; ++i)
#pragma unroll
          for (int jj = 0; jj <= i; ++jj) sc[L::kLL + r * L::kTri + i * (i + 1) / 2 + jj] = Lc[i][jj];
      }
    }
    __syncwarp();
    // own rows of G: sig_pred x = M[:, row], one solve per step, into F's place
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (owner && j < n) {
        float Lc[D][D], col[D], gr[D];
#pragma unroll
        for (int i = 0; i < D; ++i)
#pragma unroll
          for (int jj = 0; jj <= i; ++jj) Lc[i][jj] = sc[L::kLL + j * L::kTri + i * (i + 1) / 2 + jj];
#pragma unroll
        for (int k = 0; k < D; ++k) col[k] = sc[L::kMM + j * D * D + k * D + r];
        chol_solve<D>(Lc, col, gr);
#pragma unroll
        for (int k = 0; k < D; ++k) st[L::kF + j * D * D + r * D + k] = gr[k];
      }
    }
    __syncwarp();
    // the carried recurrence, one step at a time
    for (int j = 0; j < n; ++j) {
      const size_t bt = (size_t)bc * T + (hi - j);
      const float* Gt = st + L::kF + j * D * D;
      const float* sft = st + L::kSf + j * D * D;
      const float* spt = st + L::kSp + j * D * D;
      const float* mp = st + L::kMp + j * D;
      const float* sn = sc + L::kSN + p * D * D;
      const float* mn = sc + L::kMN + p * D;
      float gr[D];
#pragma unroll
      for (int k = 0; k < D; ++k) gr[k] = Gt[row * D + k];
      float mu_sm, gd[D];
      {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) s = s + gr[k] * (mn[k] - mp[k]);
        mu_sm = st[L::kMf + j * D + row] + s;
      }
#pragma unroll
      for (int jj = 0; jj < D; ++jj) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) s = s + gr[k] * (sn[k * D + jj] - spt[k * D + jj]);
        gd[jj] = s;
      }
      // own row of sig_next = sig_f + G Dlt G^T, into the other copy
      if (owner) {
        float* sn_out = sc + L::kSN + (1 - p) * D * D;
#pragma unroll
        for (int jj = 0; jj < D; ++jj) {
          float s = 0.0f;
#pragma unroll
          for (int k = 0; k < D; ++k) s = s + gd[k] * Gt[jj * D + k];
          sn_out[r * D + jj] = sft[r * D + jj] + s;
        }
        sc[L::kMN + (1 - p) * D + r] = mu_sm;
      }
      if (live) mu_s[bt * D + r] = mu_sm;
      p ^= 1;
      __syncwarp();
    }
  }
}

// --- the general form (D, Z up to 16), the wide form (up to 32) and the
// large form (past 32) ------------------------------------------------------
//
// Sizes past the register instances (D or Z above 6, ops/i2c_smooth.py:
// REG_DIM) take the general form (i2c_general.cuh) up to kGeneralMax, the
// wide form (i2c_wide.cuh) up to kWideMax, and the large form past it: one
// kernel pair whose D and Z are runtime arguments. A warp per scenario;
// every matrix of a step lives in a per-warp workspace, in shared memory or,
// where a block's kLargeWarps workspaces pass kMaxSharedBytes, in device
// memory; the inputs are read from device memory where a step needs them.
// Each entry of each product is one lane's sum in the reference order, the
// lanes taking the entries in turn; the Cholesky factorisation runs in place
// column by column, row i on lane i % 32, which also forms the next diagonal
// from its own row (so one __syncwarp per column); each lane solves its own
// rows. Every value is formed once, by one lane, with the operations of the
// plain version in its order, so the large form keeps the plain version's
// bits at every size. Warps past B return at once: no barrier spans warps.
#include "i2c_general.cuh"
#include "i2c_wide.cuh"

constexpr int kLargeWarps = 4;               // warps (scenarios) per block
constexpr int kMaxSharedBytes = 227 * 1024;  // a block's shared memory on sm_90

// Floats of one scenario's workspace: the filter's sig_p, mu_p, P J^T, sig_y
// (factored in place), the gain rows, the innovation, mu_f, sf (then
// F sig_f) and sig_f; the smoother's sig_next, mu_next, M, the factor of
// sig_pred, G, G Dlt and the smoothed mean.
__host__ __device__ inline int large_filter_floats(int D, int Z) {
  return 3 * D * D + 2 * D * Z + Z * Z + 2 * D + Z;
}
__host__ __device__ inline int large_rts_floats(int D) { return 5 * D * D + 2 * D; }

// Lower Cholesky factor of the n x n matrix at A (row stride n), in place:
// only the lower triangle is read and written. Ends with a __syncwarp.
__device__ __forceinline__ void chol_warp(float* A, int n, int lane) {
  if (lane == 0) A[0] = sqrtf(floor_keep_nan(A[0]));
  __syncwarp();
  for (int j = 0; j + 1 < n; ++j) {
    const float* Aj = A + j * n;
    for (int i = j + 1 + ((lane - j - 1) & 31); i < n; i += 32) {
      float* Ai = A + i * n;
      float s = Ai[j];
      for (int k = 0; k < j; ++k) s = s - Ai[k] * Aj[k];
      Ai[j] = div_rn(s, Aj[j]);
      if (i == j + 1) {  // this row's diagonal: every entry left of it is this lane's
        float d = Ai[i];
        for (int k = 0; k <= j; ++k) d = d - Ai[k] * Ai[k];
        Ai[i] = sqrtf(floor_keep_nan(d));
      }
    }
    __syncwarp();
  }
}

// x = (L L^T)^-1 b for one right-hand side, L the factor at Lc (row stride
// n), b[k] at b[k * bs]; x (contiguous) may not alias b.
__device__ __forceinline__ void chol_solve_lane(const float* Lc, int n, const float* b, int bs,
                                                float* x) {
  for (int i = 0; i < n; ++i) {
    float s = b[i * bs];
    for (int k = 0; k < i; ++k) s = s - Lc[i * n + k] * x[k];
    x[i] = div_rn(s, Lc[i * n + i]);
  }
  for (int i = n - 1; i >= 0; --i) {
    float s = x[i];
    for (int k = i + 1; k < n; ++k) s = s - Lc[k * n + i] * x[k];
    x[i] = div_rn(s, Lc[i * n + i]);
  }
}

// The warp's workspace: its slot of the block's shared memory, or of ws.
__device__ __forceinline__ float* large_workspace(float* ws, int per, int b) {
  extern __shared__ float smem[];
  return ws != nullptr ? ws + (size_t)b * per : smem + (threadIdx.x >> 5) * per;
}

__global__ void __launch_bounds__(32 * kLargeWarps)
i2c_filter_large(const float* __restrict__ F, const float* __restrict__ m,
                 const float* __restrict__ J, const float* __restrict__ z0,
                 const float* __restrict__ R, int r_stride,
                 const float* __restrict__ mu0, const float* __restrict__ sig0,
                 const float* __restrict__ Qproc, const float* __restrict__ g_z,
                 float* __restrict__ mu_f_out, float* __restrict__ sig_f_out,
                 float* __restrict__ mu_pred_out, float* __restrict__ sig_pred_out,
                 int B, int T, int D, int Z, float* ws) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kLargeWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const int DD = D * D, DZ = D * Z;
  float* P = large_workspace(ws, large_filter_floats(D, Z), b);
  float* MU = P + DD;
  float* PJ = MU + D;
  float* LY = PJ + DZ;
  float* SOL = LY + Z * Z;
  float* INN = SOL + DZ;
  float* MF = INN + Z;
  float* SF = MF + D;
  float* SG = SF + DD;
  const float* Rb = R + (size_t)b * r_stride;
  for (int e = lane; e < DD; e += 32) P[e] = sig0[e];
  for (int i = lane; i < D; i += 32) MU[i] = mu0[(size_t)b * D + i];
  __syncwarp();
  for (int t = 0; t < T; ++t) {
    const size_t bt = (size_t)b * T + t;
    const float* Ft = F + bt * DD;
    const float* Jt = J + bt * DZ;
    const float* gt = g_z + (size_t)t * Z;
    // P J^T, and the innovation g - (J mu_p + z0)
    for (int e = lane; e < DZ; e += 32) {
      const int i = e / Z, a = e - i * Z;
      float s = 0.0f;
      for (int k = 0; k < D; ++k) s = s + P[i * D + k] * Jt[a * D + k];
      PJ[e] = s;
    }
    for (int a = lane; a < Z; a += 32) {
      float s = 0.0f;
      for (int k = 0; k < D; ++k) s = s + Jt[a * D + k] * MU[k];
      INN[a] = gt[a] - (s + z0[bt * Z + a]);
    }
    __syncwarp();
    // sig_y = R + J P J^T, lower triangle, then its factor in place
    for (int e = lane; e < Z * Z; e += 32) {
      const int a = e / Z, c = e - a * Z;
      if (c > a) continue;
      float s = 0.0f;
      for (int k = 0; k < D; ++k) s = s + Jt[a * D + k] * PJ[k * Z + c];
      LY[e] = Rb[e] + s;
    }
    __syncwarp();
    chol_warp(LY, Z, lane);
    // gain rows: sig_y x = (P J^T)[i]
    for (int i = lane; i < D; i += 32) chol_solve_lane(LY, Z, PJ + i * Z, 1, SOL + i * Z);
    __syncwarp();
    // mu_f = mu_p + L innov; sf = sig_p - L (P J^T)^T
    for (int i = lane; i < D; i += 32) {
      float s = 0.0f;
      for (int a = 0; a < Z; ++a) s = s + SOL[i * Z + a] * INN[a];
      MF[i] = MU[i] + s;
    }
    for (int e = lane; e < DD; e += 32) {
      const int i = e / D, j = e - i * D;
      float s = 0.0f;
      for (int a = 0; a < Z; ++a) s = s + SOL[i * Z + a] * PJ[j * Z + a];
      SF[e] = P[e] - s;
    }
    __syncwarp();
    // sig_f = sym(sf)
    for (int e = lane; e < DD; e += 32) {
      const int i = e / D, j = e - i * D;
      const float v = 0.5f * (SF[e] + SF[j * D + i]);
      SG[e] = v;
      sig_f_out[bt * DD + e] = v;
    }
    for (int i = lane; i < D; i += 32) mu_f_out[bt * D + i] = MF[i];
    __syncwarp();
    // predict: mu_p = m + F mu_f, F sig_f into sf's place
    for (int i = lane; i < D; i += 32) {
      float s = 0.0f;
      for (int k = 0; k < D; ++k) s = s + Ft[i * D + k] * MF[k];
      const float v = m[bt * D + i] + s;
      MU[i] = v;
      mu_pred_out[bt * D + i] = v;
    }
    for (int e = lane; e < DD; e += 32) {
      const int i = e / D, j = e - i * D;
      float s = 0.0f;
      for (int k = 0; k < D; ++k) s = s + Ft[i * D + k] * SG[k * D + j];
      SF[e] = s;
    }
    __syncwarp();
    // sig_p = (F sig_f) F^T + Q
    for (int e = lane; e < DD; e += 32) {
      const int i = e / D, j = e - i * D;
      float s = 0.0f;
      for (int k = 0; k < D; ++k) s = s + SF[i * D + k] * Ft[j * D + k];
      const float v = s + Qproc[e];
      P[e] = v;
      sig_pred_out[bt * DD + e] = v;
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(32 * kLargeWarps)
i2c_rts_large(const float* __restrict__ mu_f, const float* __restrict__ sig_f,
              const float* __restrict__ mu_pred, const float* __restrict__ sig_pred,
              const float* __restrict__ F, float* __restrict__ mu_s, int B, int T, int D,
              float* ws) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kLargeWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const int DD = D * D;
  float* SN = large_workspace(ws, large_rts_floats(D), b);
  float* MN = SN + DD;
  float* M = MN + D;
  float* A = M + DD;
  float* G = A + DD;
  float* GD = G + DD;
  float* MS = GD + DD;
  // the carry starts from the filtered moments of t = T-1, the last output row
  {
    const size_t bl = (size_t)b * T + (T - 1);
    for (int e = lane; e < DD; e += 32) SN[e] = sig_f[bl * DD + e];
    for (int i = lane; i < D; i += 32) {
      MN[i] = mu_f[bl * D + i];
      mu_s[bl * D + i] = mu_f[bl * D + i];
    }
  }
  __syncwarp();
  for (int t = T - 2; t >= 0; --t) {
    const size_t bt = (size_t)b * T + t;
    const float* Ft = F + bt * DD;
    const float* sft = sig_f + bt * DD;
    const float* spt = sig_pred + bt * DD;
    const float* mpt = mu_pred + bt * D;
    // M = F sig_f, and sig_pred's lower triangle to factor
    for (int e = lane; e < DD; e += 32) {
      const int i = e / D, j = e - i * D;
      float s = 0.0f;
      for (int k = 0; k < D; ++k) s = s + Ft[i * D + k] * sft[k * D + j];
      M[e] = s;
      if (j <= i) A[e] = spt[e];
    }
    __syncwarp();
    chol_warp(A, D, lane);
    // G's rows: sig_pred x = M[:, i]
    for (int i = lane; i < D; i += 32) chol_solve_lane(A, D, M + i, D, G + i * D);
    __syncwarp();
    // the smoothed mean, and G (sig_next - sig_pred)
    for (int i = lane; i < D; i += 32) {
      float s = 0.0f;
      for (int k = 0; k < D; ++k) s = s + G[i * D + k] * (MN[k] - mpt[k]);
      MS[i] = mu_f[bt * D + i] + s;
    }
    for (int e = lane; e < DD; e += 32) {
      const int i = e / D, j = e - i * D;
      float s = 0.0f;
      for (int k = 0; k < D; ++k) s = s + G[i * D + k] * (SN[k * D + j] - spt[k * D + j]);
      GD[e] = s;
    }
    __syncwarp();
    // sig_next = sig_f + G Dlt G^T; the mean carried and stored
    for (int e = lane; e < DD; e += 32) {
      const int i = e / D, j = e - i * D;
      float s = 0.0f;
      for (int k = 0; k < D; ++k) s = s + GD[i * D + k] * G[j * D + k];
      SN[e] = sft[e] + s;
    }
    for (int i = lane; i < D; i += 32) {
      MN[i] = MS[i];
      mu_s[bt * D + i] = MS[i];
    }
    __syncwarp();
  }
}

// The large form's launch: blocks of kLargeWarps scenarios, each warp's
// workspace in shared memory, or in ws (B * per floats, non-null exactly
// where kLargeWarps * per floats pass kMaxSharedBytes).
template <typename Kernel, typename... Args>
int launch_large(Kernel kernel, int per, const float* ws, int B, cudaStream_t stream,
                 Args... args) {
  const int bytes = ws != nullptr ? 0 : kLargeWarps * per * (int)sizeof(float);
  if (bytes > kMaxSharedBytes) return (int)cudaErrorInvalidValue;  // ws was needed
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(B + kLargeWarps - 1) / kLargeWarps, 32 * kLargeWarps, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

struct FilterArgs {
  const float *F, *m, *J, *z0, *R;
  int r_stride;
  const float *mu0, *sig0, *Qproc, *g_z;
  float *mu_f, *sig_f, *mu_pred, *sig_pred;
  int B, T;
  cudaStream_t stream;
};

// A layout above the 48 KB of shared memory that a launch gets by default
// (only the smoother's wide blocks at D = 6) asks the kernel for its size.
template <typename L, typename Kernel>
int allow_shared(Kernel kernel) {
  if (L::kBytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   L::kBytes);
}

// Launches kernel on the layout's grid over B scenarios.
template <typename L, typename Kernel, typename... Args>
int launch(Kernel kernel, int B, cudaStream_t stream, Args... args) {
  if (const int err = allow_shared<L>(kernel)) return err;
  kernel<<<(B + L::kScen - 1) / L::kScen, L::kThreads, L::kBytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int D, int Z>
int launch_filter(const FilterArgs& a) {
  return launch<FilterLayout<D, Z>>(i2c_filter_kernel<D, Z>, a.B, a.stream, a.F, a.m, a.J, a.z0,
                                    a.R, a.r_stride, a.mu0, a.sig0, a.Qproc, a.g_z, a.mu_f,
                                    a.sig_f, a.mu_pred, a.sig_pred, a.B, a.T);
}

// The smoother's block shape, a build option for timing the two against
// each other (kernel_ab.py): 0 picks by B, 1 takes the narrow blocks, 2 the
// wide ones.
#ifndef I2C_RTS_SHAPE
#define I2C_RTS_SHAPE 0
#endif

// Whether the smoother takes its wide blocks for B scenarios: when blocks of
// 8 scenarios would outnumber the SMs.
inline int rts_wide(int B, bool* wide) {
  if (I2C_RTS_SHAPE != 0) {
    *wide = I2C_RTS_SHAPE == 2;
    return 0;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *wide = (B + RtsLayout<1, false>::kScen - 1) / RtsLayout<1, false>::kScen > sms;
  return (int)err;
}

template <int D>
int launch_rts(const float* mu_f, const float* sig_f, const float* mu_pred,
               const float* sig_pred, const float* F, float* mu_s, int B, int T,
               cudaStream_t stream) {
  bool wide;
  if (const int err = rts_wide(B, &wide)) return err;
  if (wide)
    return launch<RtsLayout<D, true>>(i2c_rts_kernel<D, true>, B, stream, mu_f, sig_f, mu_pred,
                                      sig_pred, F, mu_s, B, T);
  return launch<RtsLayout<D, false>>(i2c_rts_kernel<D, false>, B, stream, mu_f, sig_f, mu_pred,
                                     sig_pred, F, mu_s, B, T);
}

// fn(integral_constant<D>, integral_constant<Z>) for 1 <= D, Z <= 6
template <int D, typename Fn>
int dispatch_z(int Z, Fn&& fn) {
  using DC = std::integral_constant<int, D>;
  switch (Z) {
    case 1: return fn(DC{}, std::integral_constant<int, 1>{});
    case 2: return fn(DC{}, std::integral_constant<int, 2>{});
    case 3: return fn(DC{}, std::integral_constant<int, 3>{});
    case 4: return fn(DC{}, std::integral_constant<int, 4>{});
    case 5: return fn(DC{}, std::integral_constant<int, 5>{});
    case 6: return fn(DC{}, std::integral_constant<int, 6>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename Fn>
int dispatch(int D, int Z, Fn&& fn) {
  switch (D) {
    case 1: return dispatch_z<1>(Z, fn);
    case 2: return dispatch_z<2>(Z, fn);
    case 3: return dispatch_z<3>(Z, fn);
    case 4: return dispatch_z<4>(Z, fn);
    case 5: return dispatch_z<5>(Z, fn);
    case 6: return dispatch_z<6>(Z, fn);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the smoother's instantiation, whatever Z the dispatch carries
template <typename Fn>
int dispatch_d(int D, Fn&& fn) {
  return dispatch(D, 1, [&](auto d, auto) { return fn(d); });
}

// fn(integral_constant<N>) for the general form's row length N: 12 or 16,
// the smaller that holds n (1 <= n <= kGeneralMax)
template <typename Fn>
int dispatch_general(int n, Fn&& fn) {
  if (n <= 12) return fn(std::integral_constant<int, 12>{});
  return fn(std::integral_constant<int, 16>{});
}

// fn(integral_constant<N>) for the wide form's row length N: 20, 24, 28 or
// 32, the smallest that holds n (kGeneralMax < n <= kWideMax)
template <typename Fn>
int dispatch_wide(int n, Fn&& fn) {
  if (n <= 20) return fn(std::integral_constant<int, 20>{});
  if (n <= 24) return fn(std::integral_constant<int, 24>{});
  if (n <= 28) return fn(std::integral_constant<int, 28>{});
  return fn(std::integral_constant<int, 32>{});
}

// threads, scenarios, time steps per stage, shared bytes, registers,
// resident blocks per SM and local (stack and spill) bytes per thread of one
// kernel into out[0..6]
template <typename L, typename Kernel>
int kernel_info(Kernel kernel, int* out) {
  out[0] = L::kThreads;
  out[1] = L::kScen;
  out[2] = L::kChunk;
  out[3] = L::kBytes;
  if (const int err = allow_shared<L>(kernel)) return err;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  out[4] = attr.numRegs;
  out[6] = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[5], kernel, L::kThreads,
                                                            L::kBytes);
}

}  // namespace

// Batch-first float32 contiguous device arrays: F (B, T, D, D), m (B, T, D),
// J (B, T, Z, D), z0 (B, T, Z), R (Z, Z) with r_per_scenario == 0 or
// (B, Z, Z) otherwise, mu0 (B, D), sig0 and Qproc (D, D), g_z (T, Z); out
// mu_f, mu_pred (B, T, D), sig_f, sig_pred (B, T, D, D). 1 <= D, Z <= 6,
// B, T >= 1; pointers 4-byte aligned. Returns the launch's cudaGetLastError().
extern "C" int i2c_filter_launch(const float* F, const float* m, const float* J,
                                 const float* z0, const float* R, const float* mu0,
                                 const float* sig0, const float* Qproc, const float* g_z,
                                 float* mu_f, float* sig_f, float* mu_pred, float* sig_pred,
                                 int B, int T, int D, int Z, int r_per_scenario,
                                 cudaStream_t stream) {
  const FilterArgs a{F, m, J, z0, R, r_per_scenario ? Z * Z : 0, mu0, sig0, Qproc, g_z,
                     mu_f, sig_f, mu_pred, sig_pred, B, T, stream};
  return dispatch(D, Z, [&](auto d, auto z) {
    return launch_filter<decltype(d)::value, decltype(z)::value>(a);
  });
}

// The filter's four outputs and F as above; out mu_s (B, T, D): rows 0..T-2
// smoothed, row T-1 the filtered mean. 1 <= D <= 6, B, T >= 1.
extern "C" int i2c_rts_launch(const float* mu_f, const float* sig_f, const float* mu_pred,
                              const float* sig_pred, const float* F, float* mu_s, int B,
                              int T, int D, cudaStream_t stream) {
  return dispatch_d(D, [&](auto d) {
    return launch_rts<decltype(d)::value>(mu_f, sig_f, mu_pred, sig_pred, F, mu_s, B, T,
                                          stream);
  });
}

// The launch shape for B scenarios at (D, Z) into out[15]: the stages of
// the ring, then for the filter and the smoother each: threads and scenarios
// per block, time steps per stage, shared bytes per block, registers per
// thread, resident blocks per SM, local bytes per thread. Returns a
// cudaError.
extern "C" int i2c_launch_config(int D, int Z, int B, int* out) {
  out[0] = kStages;
  bool wide;
  if (const int err = rts_wide(B, &wide)) return err;
  return dispatch(D, Z, [&](auto d, auto z) {
    constexpr int Dv = decltype(d)::value, Zv = decltype(z)::value;
    const int err = kernel_info<FilterLayout<Dv, Zv>>(i2c_filter_kernel<Dv, Zv>, out + 1);
    if (err) return err;
    return wide ? kernel_info<RtsLayout<Dv, true>>(i2c_rts_kernel<Dv, true>, out + 8)
                : kernel_info<RtsLayout<Dv, false>>(i2c_rts_kernel<Dv, false>, out + 8);
  });
}

// The general form (D and Z up to kGeneralMax), the wide form (up to
// kWideMax) and past it the large form; the wrapper takes this entry point
// where D or Z passes 6: the arguments of i2c_filter_launch, and ws, null
// except for the large form where kLargeWarps workspaces of
// large_filter_floats(D, Z) floats pass a block's shared memory: then B
// times that many floats of device memory.
extern "C" int i2c_filter_general_launch(const float* F, const float* m, const float* J,
                                         const float* z0, const float* R, const float* mu0,
                                         const float* sig0, const float* Qproc,
                                         const float* g_z, float* mu_f, float* sig_f,
                                         float* mu_pred, float* sig_pred, int B, int T, int D,
                                         int Z, int r_per_scenario, float* ws,
                                         cudaStream_t stream) {
  if (D < 1 || Z < 1) return (int)cudaErrorInvalidValue;
  const int r_stride = r_per_scenario ? Z * Z : 0;
  if (D <= kGeneralMax && Z <= kGeneralMax)
    return dispatch_general(D > Z ? D : Z, [&](auto n) {
      constexpr int N = decltype(n)::value;
      return launch<GeneralFilterLayout<N>>(i2c_filter_general<N>, B, stream, F, m, J, z0, R,
                                            r_stride, mu0, sig0, Qproc, g_z, mu_f, sig_f,
                                            mu_pred, sig_pred, B, T, D, Z);
    });
  if (D <= kWideMax && Z <= kWideMax)
    return dispatch_wide(D > Z ? D : Z, [&](auto n) {
      constexpr int N = decltype(n)::value;
      return launch<WideFilterLayout<N>>(i2c_filter_wide<N>, B, stream, F, m, J, z0, R, r_stride,
                                         mu0, sig0, Qproc, g_z, mu_f, sig_f, mu_pred, sig_pred,
                                         B, T, D, Z);
    });
  return launch_large(i2c_filter_large, large_filter_floats(D, Z), ws, B, stream, F, m, J, z0,
                      R, r_stride, mu0, sig0, Qproc, g_z, mu_f, sig_f, mu_pred, sig_pred, B, T,
                      D, Z, ws);
}

// The smoother's general, wide and large forms, by D: the arguments of
// i2c_rts_launch and ws, null or B * large_rts_floats(D) floats by the same
// test.
extern "C" int i2c_rts_general_launch(const float* mu_f, const float* sig_f,
                                      const float* mu_pred, const float* sig_pred,
                                      const float* F, float* mu_s, int B, int T, int D,
                                      float* ws, cudaStream_t stream) {
  if (D < 1) return (int)cudaErrorInvalidValue;
  if (D <= kGeneralMax)
    return dispatch_general(D, [&](auto n) {
      constexpr int N = decltype(n)::value;
      return launch<GeneralRtsLayout<N>>(i2c_rts_general<N>, B, stream, mu_f, sig_f, mu_pred,
                                         sig_pred, F, mu_s, B, T, D);
    });
  if (D <= kWideMax)
    return dispatch_wide(D, [&](auto n) {
      constexpr int N = decltype(n)::value;
      return launch<WideRtsLayout<N>>(i2c_rts_wide<N>, B, stream, mu_f, sig_f, mu_pred,
                                      sig_pred, F, mu_s, B, T, D);
    });
  return launch_large(i2c_rts_large, large_rts_floats(D), ws, B, stream, mu_f, sig_f, mu_pred,
                      sig_pred, F, mu_s, B, T, D, ws);
}

// The launch shape at (D, Z) for B scenarios into out[15], laid out as
// i2c_launch_config's, of the filter's form at (D, Z) and the smoother's at
// D: the general form's as the register form's (a ring of two one-step
// slots), the wide form's with one slot (out[0] is 1 where the filter takes
// it); the large form's with 0 time steps per stage (nothing is staged;
// out[0] is 0 where the filter takes it) and 0 shared bytes where its
// workspace is in device memory.
extern "C" int i2c_general_launch_config(int D, int Z, int B, int* out) {
  if (D < 1 || Z < 1) return (int)cudaErrorInvalidValue;
  (void)B;
  const int n[2] = {D > Z ? D : Z, D};
  // 0: general, 1: wide, 2: large, for the filter and the smoother
  int form[2];
  for (int k = 0; k < 2; ++k) form[k] = n[k] <= kGeneralMax ? 0 : n[k] <= kWideMax ? 1 : 2;
  out[0] = form[0] == 0 ? kStages : form[0] == 1 ? 1 : 0;
  for (int k = 0; k < 2; ++k) {
    int* o = out + 1 + 7 * k;
    int err = 0;
    if (form[k] == 0)
      err = dispatch_general(n[k], [&](auto c) {
        constexpr int N = decltype(c)::value;
        return k == 0 ? kernel_info<GeneralFilterLayout<N>>(i2c_filter_general<N>, o)
                      : kernel_info<GeneralRtsLayout<N>>(i2c_rts_general<N>, o);
      });
    else if (form[k] == 1)
      err = dispatch_wide(n[k], [&](auto c) {
        constexpr int N = decltype(c)::value;
        return k == 0 ? kernel_info<WideFilterLayout<N>>(i2c_filter_wide<N>, o)
                      : kernel_info<WideRtsLayout<N>>(i2c_rts_wide<N>, o);
      });
    if (err) return err;
  }
  const int per[2] = {large_filter_floats(D, Z), large_rts_floats(D)};
  const void* kernels[2] = {(const void*)i2c_filter_large, (const void*)i2c_rts_large};
  for (int k = 0; k < 2; ++k) {
    if (form[k] != 2) continue;
    int* o = out + 1 + 7 * k;
    const int bytes = kLargeWarps * per[k] * (int)sizeof(float);
    o[0] = 32 * kLargeWarps;
    o[1] = kLargeWarps;
    o[2] = 0;
    o[3] = bytes <= kMaxSharedBytes ? bytes : 0;
    if (o[3] > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernels[k], cudaFuncAttributeMaxDynamicSharedMemorySize, o[3]);
      if (e != cudaSuccess) return (int)e;
    }
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernels[k]);
    if (e != cudaSuccess) return (int)e;
    o[4] = attr.numRegs;
    o[6] = (int)attr.localSizeBytes;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[5], kernels[k], 32 * kLargeWarps,
                                                      o[3]);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
