// Fixed-count ADMM for a batch of box-constrained QPs for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarking_mpc_solvers_tpu/ops/qp_pallas.py:
// admm_iterate (kernel body :148). For B problems
//   min 1/2 U^T H_b U + g_b^T U  s.t.  lo <= U <= hi      (n variables)
// with Minv = (H + rho I)^-1 computed outside, it runs all `iters`
// OSQP-style iterations in one launch:
//   v  = rho (z - y) - g
//   u  = Minv v                          (each row summed over j in order, from 0)
//   u' = alpha u + (1 - alpha) z
//   z+ = clip(u' + y, lo, hi),   y+ = y + u' - z+
// from z = y = 0, without an early exit, and writes the last z (always
// inside the box). Two layouts: Minv (n, n) shared by all problems, or
// (B, n, n), one per problem; lo/hi are (n,) or (B, n). Every form rounds
// each operation as the plain version does (built with --fmad=false), so
// the iterates are the plain version's bit for bit.
//
// What bounds it on the H100. At QP-MPC configuration 1's shape (B=512,
// n=20, 100 iterations) the operations the function needs (2 n^2 + 9 n a
// problem and iteration, 0.75 us at 67 TFLOP/s) and the bytes (0.1 MB,
// 0.03 us) are both far below the chain of dependent FP32 operations one
// iteration carries into the next: v (3), the first product (1), the n - 1
// adds of a row's sum in order, u' (2), + y and the clip (3), y+ (1, from
// the clip's u' + y): n + 9 operations, 29 at n = 20, 116 cycles at 4 a
// step, 5.9 us for 100 iterations at 1,980 MHz (the kernels here also add
// the first product to 0, as the plain version does). Only latency can be
// won, so each form keeps loads and barriers off that chain. The wrapper (ops/qp_admm.py:block_plan) picks the form from n:
//
// 1. Registers (n <= 64): a warp per problem (two per warp where n <= 16,
//    a half-warp each). Lane i keeps row i of Minv in registers (rows i and
//    i + 32 where n > 32: two independent chains in one lane), staged once
//    through shared memory so that the global reads coalesce, and z_i, y_i,
//    g_i and the bounds in registers. Each iteration writes v to a per-warp
//    shared vector and, after __syncwarp(), every lane reads it back as
//    16-byte broadcasts, all issued before the first add, so only the adds
//    stay on the chain. No barrier but the warp's own. Compiled for every
//    row width W that is a multiple of 4 up to 64, W = n rounded up, with
//    `#pragma unroll` over W and no branch in the iteration: the padding's
//    terms are exact zeros. Blocks of 1, 2 or 4 warps, as many as keep
//    every SM busy. Measured against forms with a branch in the sum
//    (kernel_ab.py, configuration 1's shape, NVIDIA H100 80GB HBM3 at
//    700 W; the kernel before this one 0.0405 ms): a shuffle of v per j
//    under a guard j < n, 0.0931 ms; widths 16, 32, 64 with the sum leaving
//    at the first chunk of 4 past n, 0.0234 ms; this form, 0.0126 ms.
// 2. Shared memory (64 < n, while a block holds one problem's Minv: n <= 240
//    in either layout): a block per problem, thread i owns row i; Minv waits
//    in shared memory, transposed so that the threads read consecutive
//    words; v goes through a double-buffered shared vector, one
//    __syncthreads an iteration. The sum's loads run kUnroll terms ahead of
//    its adds. The streaming form at the same n is slower (kernel_ab.py,
//    B=256, 60 iterations, NVIDIA H100 80GB HBM3 at 700 W): n=120 per
//    problem 0.0821 ms here against 0.2495 ms streamed, shared layout
//    0.0845 against 0.1931, n=240 per problem 0.3489 against 5.482. So
//    this form runs up to where a block's shared memory holds Minv.
// 3. Streaming (larger n): a block per problem, each thread owns rows r,
//    r + blockDim, ... (any n). Minv stays in device memory, transposed once
//    by the wrapper so that a warp's loads of column j coalesce, and is read
//    again every iteration (from L2 where it fits: one n x n matrix in the
//    shared layout); z, y and a double-buffered v live in device memory.
//    This form is only to be right.
#include <cuda_runtime.h>

#include <utility>

namespace {

constexpr int kMaxWarps = 4;   // warps a block of the register form, at most
constexpr int kMaxWidth = 64;  // the register form's widest row
constexpr int kUnroll = 8;    // terms of the shared-memory form's sum in flight

enum Form { kRegisters = 0, kShared = 1, kStreaming = 2 };

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ---- 1. registers -----------------------------------------------------------

template <int W>
__global__ void __launch_bounds__(kMaxWarps * 32)
admm_registers_kernel(const float* __restrict__ Minv, const float* __restrict__ g,
                      const float* __restrict__ lo, const float* __restrict__ hi,
                      float* __restrict__ z_out, float*, float*, int B, int n,
                      int per_problem, int per_bounds, float rho, float alpha,
                      float one_minus_alpha, int iters) {
  constexpr int Q = W <= 16 ? 2 : 1;  // problems a warp
  constexpr int R = W > 32 ? 2 : 1;   // rows a lane: i and i + 32
  constexpr int SEG = 32 / Q;         // lanes a problem
  constexpr int VW = 32 * R + 4;      // a warp's v: a slot a lane (and row i + 32),
                                      // then one that the lanes without a row write to
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = (blockIdx.x * (blockDim.x >> 5) + warp) * Q;
  if (b0 >= B) return;  // the whole warp
  const int nq = min(Q, B - b0);
  const int stride = n | 1;  // odd, so that lane i's reads of row i hit distinct banks
  const int mats = per_problem ? nq : 1;
  // this warp's double-buffered v (2 x VW floats), then its staging area
  float* vbuf = smem + (size_t)warp * 2 * VW;
  float* s = smem + (size_t)(blockDim.x >> 5) * 2 * VW +
             (size_t)warp * (per_problem ? Q : 1) * n * stride;

  // stage this warp's matrices (mats of them, stacked as mats*n rows) in
  // shared memory, coalesced, then take each lane's row(s) into registers.
  // A row's entries from n to W stay 0, and so do v's: those terms of the
  // sum are 0 * 0 = +0, which leaves it as it is (a sum from +0 is never -0).
  const float* src = per_problem ? Minv + (size_t)b0 * n * n : Minv;
  for (int e = lane; e < mats * n * n; e += 32) {
    const int r = e / n;
    s[r * stride + (e - r * n)] = src[e];
  }
  for (int e = lane; e < 2 * VW; e += 32) vbuf[e] = 0.0f;
  __syncwarp();

  const int q = lane / SEG;
  const int i = lane % SEG;
  const int b = b0 + q;
  const bool live0 = q < nq && i < n;
  const bool live1 = R == 2 && q < nq && i + 32 < n;
  const float* row = s + ((per_problem ? q : 0) * n + i) * stride;
  float m0[W];
  float m1[R == 2 ? W : 1];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    m0[j] = live0 && j < n ? row[j] : 0.0f;
    if constexpr (R == 2) m1[j] = live1 && j < n ? row[32 * stride + j] : 0.0f;
  }

  float g0 = 0.0f, lo0 = 0.0f, hi0 = 0.0f, g1 = 0.0f, lo1 = 0.0f, hi1 = 0.0f;
  if (live0) {
    g0 = g[(size_t)b * n + i];
    lo0 = per_bounds ? lo[(size_t)b * n + i] : lo[i];
    hi0 = per_bounds ? hi[(size_t)b * n + i] : hi[i];
  }
  if (live1) {
    g1 = g[(size_t)b * n + i + 32];
    lo1 = per_bounds ? lo[(size_t)b * n + i + 32] : lo[i + 32];
    hi1 = per_bounds ? hi[(size_t)b * n + i + 32] : hi[i + 32];
  }

  const int slot0 = live0 ? lane : VW - 4, slot1 = live1 ? lane + 32 : VW - 4;
  float z0 = 0.0f, y0 = 0.0f, z1 = 0.0f, y1 = 0.0f;
  for (int it = 0; it < iters; ++it) {
    // v to the warp's vector (row i at lane's slot, row i + 32 after it),
    // then every lane of a problem reads it back as 16-byte broadcasts, all
    // issued before the first add. Double-buffered: one __syncwarp an
    // iteration orders this write after every lane's reads of two
    // iterations ago.
    float* vb = vbuf + (it & 1) * VW;
    vb[slot0] = rho * (z0 - y0) - g0;
    if constexpr (R == 2) vb[slot1] = rho * (z1 - y1) - g1;
    __syncwarp();
    const float4* v4 = reinterpret_cast<const float4*>(vb + q * SEG);
    float4 vq[W / 4];
#pragma unroll
    for (int c = 0; c < W / 4; ++c) vq[c] = v4[c];
    float u0 = 0.0f, u1 = 0.0f;
#pragma unroll
    for (int c = 0; c < W / 4; ++c) {
      u0 = u0 + m0[4 * c] * vq[c].x;
      u0 = u0 + m0[4 * c + 1] * vq[c].y;
      u0 = u0 + m0[4 * c + 2] * vq[c].z;
      u0 = u0 + m0[4 * c + 3] * vq[c].w;
      if constexpr (R == 2) {
        u1 = u1 + m1[4 * c] * vq[c].x;
        u1 = u1 + m1[4 * c + 1] * vq[c].y;
        u1 = u1 + m1[4 * c + 2] * vq[c].z;
        u1 = u1 + m1[4 * c + 3] * vq[c].w;
      }
    }
    const float r0 = alpha * u0 + one_minus_alpha * z0;
    const float zn0 = clampf(r0 + y0, lo0, hi0);
    y0 = y0 + r0 - zn0;
    z0 = zn0;
    if constexpr (R == 2) {
      const float r1 = alpha * u1 + one_minus_alpha * z1;
      const float zn1 = clampf(r1 + y1, lo1, hi1);
      y1 = y1 + r1 - zn1;
      z1 = zn1;
    }
  }
  if (live0) z_out[(size_t)b * n + i] = z0;
  if (live1) z_out[(size_t)b * n + i + 32] = z1;
}

// ---- 2. shared memory -------------------------------------------------------

__global__ void admm_shared_kernel(const float* __restrict__ Minv, const float* __restrict__ g,
                                   const float* __restrict__ lo, const float* __restrict__ hi,
                                   float* __restrict__ z_out, float*, float*, int, int n,
                                   int per_problem, int per_bounds, float rho, float alpha,
                                   float one_minus_alpha, int iters) {
  extern __shared__ float smem[];
  float* Mt = smem;         // n x n, transposed
  float* v = smem + n * n;  // 2 x n
  const size_t b = blockIdx.x;
  const int i = threadIdx.x;  // the row; blockDim.x == n
  const float* M = Minv + (per_problem ? b * n * n : 0);
  for (int e = i; e < n * n; e += n) {
    const int row = e / n;
    Mt[(e - row * n) * n + row] = M[e];
  }
  const float gi = g[b * n + i];
  const float loi = per_bounds ? lo[b * n + i] : lo[i];
  const float hii = per_bounds ? hi[b * n + i] : hi[i];
  float z = 0.0f, y = 0.0f;
  for (int it = 0; it < iters; ++it) {
    float* vb = v + (it & 1) * n;
    vb[i] = rho * (z - y) - gi;
    __syncthreads();  // the first also publishes Mt
    float u = 0.0f;
    int j = 0;
    for (; j + kUnroll <= n; j += kUnroll) {
      float mj[kUnroll], vj[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        mj[k] = Mt[(j + k) * n + i];
        vj[k] = vb[j + k];
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) u = u + mj[k] * vj[k];
    }
    for (; j < n; ++j) u = u + Mt[j * n + i] * vb[j];
    const float u_rel = alpha * u + one_minus_alpha * z;
    const float z_new = clampf(u_rel + y, loi, hii);
    y = y + u_rel - z_new;
    z = z_new;
  }
  z_out[b * n + i] = z;
}

// ---- 3. streaming -----------------------------------------------------------

// Mt: Minv transposed, (n, n) or (B, n, n). z (the output), y: (B, n);
// v: (B, 2, n), scratch. A block per problem.
__global__ void admm_streaming_kernel(const float* __restrict__ Mt,
                                      const float* __restrict__ g,
                                      const float* __restrict__ lo,
                                      const float* __restrict__ hi, float* z, float* y,
                                      float* v, int, int n, int per_problem, int per_bounds,
                                      float rho, float alpha, float one_minus_alpha,
                                      int iters) {
  const size_t b = blockIdx.x;
  const float* M = Mt + (per_problem ? b * n * n : 0);
  const float* gb = g + b * n;
  const float* lob = lo + (per_bounds ? b * n : 0);
  const float* hib = hi + (per_bounds ? b * n : 0);
  float* zb = z + b * n;
  float* yb = y + b * n;
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    zb[r] = 0.0f;
    yb[r] = 0.0f;
  }
  for (int it = 0; it < iters; ++it) {
    // a thread reads back only its own rows of z and y; v is read by all
    // after the barrier (double-buffered, as in the shared-memory form)
    float* vb = v + (b * 2 + (it & 1)) * n;
    for (int r = threadIdx.x; r < n; r += blockDim.x) vb[r] = rho * (zb[r] - yb[r]) - gb[r];
    __syncthreads();
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      float u = 0.0f;
#pragma unroll 4
      for (int j = 0; j < n; ++j) u = u + M[(size_t)j * n + r] * vb[j];
      const float u_rel = alpha * u + one_minus_alpha * zb[r];
      const float z_new = clampf(u_rel + yb[r], lob[r], hib[r]);
      yb[r] = yb[r] + u_rel - z_new;
      zb[r] = z_new;
    }
  }
}

template <int... C>
const void* register_kernel(int width, std::integer_sequence<int, C...>) {
  const void* const table[] = {(const void*)admm_registers_kernel<4 * (C + 1)>...};
  return table[width / 4 - 1];
}

// the kernel of a form (and, for the register form, its row width)
const void* kernel_of(int form, int width) {
  if (form == kRegisters) {
    if (width < 4 || width > kMaxWidth || width % 4 != 0) return nullptr;
    return register_kernel(width, std::make_integer_sequence<int, kMaxWidth / 4>{});
  }
  if (form == kShared) return (const void*)admm_shared_kernel;
  if (form == kStreaming) return (const void*)admm_streaming_kernel;
  return nullptr;
}

}  // namespace

// Minv (n, n) or (B, n, n) (the streaming form: transposed), g (B, n),
// lo/hi (n,) or (B, n), out z (B, n): float32, contiguous, on the device.
// The launch shape is the wrapper's plan (ops/qp_admm.py:block_plan): the
// form, the register form's row width, threads and blocks, smem_bytes of
// dynamic shared memory. y (B, n) and v (B, 2, n) are the streaming form's
// scratch (null for the others); every kernel takes the same parameters.
// Returns the first CUDA error of the attribute call or the launch.
extern "C" int admm_launch(int form, int width, const float* Minv, const float* g,
                           const float* lo, const float* hi, float* z_out, float* y,
                           float* v, int B, int n, int per_problem, int per_bounds,
                           float rho, float alpha, float one_minus_alpha, int iters,
                           int threads, int blocks, int smem_bytes, cudaStream_t stream) {
  const void* kernel = kernel_of(form, width);
  if (kernel == nullptr || threads < 1 || threads > 1024 || blocks < 1 || n < 1 ||
      (form == kRegisters && (threads % 32 != 0 || threads > kMaxWarps * 32 || n > width)) ||
      (form == kShared && threads != n) ||
      (form == kStreaming && (y == nullptr || v == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  void* args[] = {&Minv, &g,          &lo,  &hi,    &z_out,           &y,    &v, &B,
                  &n,    &per_problem, &per_bounds, &rho, &alpha, &one_minus_alpha, &iters};
  const cudaError_t err = cudaLaunchKernel(kernel, dim3(blocks), dim3(threads), args,
                                           (size_t)smem_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// A form's registers per thread and resident blocks per SM at (threads,
// smem_bytes), into out[2]. Returns a cudaError.
extern "C" int admm_launch_config(int form, int width, int threads, int smem_bytes, int* out) {
  const void* kernel = kernel_of(form, width);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  if (smem_bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = per_sm;
  return 0;
}
