// Fixed-count ADMM for a batch of box-constrained QPs for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarking_mpc_solvers_tpu/ops/qp_pallas.py:
// admm_iterate (kernel body :148). For B problems
//   min 1/2 U^T H_b U + g_b^T U  s.t. lo <= U <= hi      (n variables)
// with Minv = (H + rho I)^-1 computed outside, it runs all `iters`
// OSQP-style iterations in one launch, z and y never leaving the chip:
//   u  = Minv (rho (z - y) - g)          (sum over j in order, from 0)
//   u' = alpha u + (1 - alpha) z
//   z+ = clip(u' + y, lo, hi),   y+ = y + u' - z+
// from z = y = 0, without an early exit, and writes the last z (always
// inside the box). Two layouts: Minv (n, n) shared by all problems, or
// (B, n, n), one per problem; lo/hi are (n,) or (B, n).
//
// Bound on the H100: operations, barely: at QP-MPC's shape (B=512, n=20,
// 100 iterations) 2 n^2 + 9 n operations per problem and iteration, 50 M in
// all, 0.7 us at 67 TFLOP/s, against 0.1 MB (g, z, Minv once), 0.03 us. The
// kernel is a chain of `iters` dependent matvecs and sits far from either.
// Design: a block holds P problems, thread (p, i) owns row i of problem p
// with z_i, y_i in registers. Minv waits in shared memory, transposed so
// that the threads of a problem read consecutive words: once per block in
// the shared layout, once per problem in the per-problem layout (staged
// once, reused for every iteration). The right-hand side v goes through a
// double-buffered shared vector, so an iteration costs one __syncthreads.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void admm_iterate_kernel(const float* __restrict__ Minv,
                                    const float* __restrict__ g,
                                    const float* __restrict__ lo,
                                    const float* __restrict__ hi, float* __restrict__ z_out,
                                    int B, int n, int P, int per_problem, int per_bounds,
                                    float rho, float alpha, float one_minus_alpha,
                                    int iters) {
  extern __shared__ float smem[];
  const int n_mats = per_problem ? P : 1;
  float* Mt = smem;                          // n_mats x (n x n), transposed
  float* v = smem + (size_t)n_mats * n * n;  // 2 x P x n
  const int tid = threadIdx.x;
  const int p = tid / n;
  const int i = tid % n;
  const int b0 = blockIdx.x * P;
  const int b = b0 + p;
  const bool live = p < P && b < B;

  const int nn = n * n;
  for (int idx = tid; idx < n_mats * nn; idx += blockDim.x) {
    const int m = idx / nn, e = idx % nn;
    const int row = e / n, col = e % n;
    float val = 0.0f;
    if (!per_problem) {
      val = Minv[e];
    } else if (b0 + m < B) {
      val = Minv[(size_t)(b0 + m) * nn + e];
    }
    Mt[m * nn + col * n + row] = val;
  }

  float gi = 0.0f, loi = 0.0f, hii = 0.0f;
  if (live) {
    gi = g[(size_t)b * n + i];
    loi = per_bounds ? lo[(size_t)b * n + i] : lo[i];
    hii = per_bounds ? hi[(size_t)b * n + i] : hi[i];
  }
  const float* Mp = Mt + (per_problem && live ? p * nn : 0);
  float z = 0.0f, y = 0.0f;
  for (int it = 0; it < iters; ++it) {
    float* vb = v + (it & 1) * P * n;
    if (live) vb[p * n + i] = rho * (z - y) - gi;
    __syncthreads();
    if (live) {
      float u = 0.0f;
      for (int j = 0; j < n; ++j) u = u + Mp[j * n + i] * vb[p * n + j];
      const float u_rel = alpha * u + one_minus_alpha * z;
      const float z_new = clampf(u_rel + y, loi, hii);
      y = y + u_rel - z_new;
      z = z_new;
    }
  }
  if (live) z_out[(size_t)b * n + i] = z;
}

}  // namespace

// Minv (n, n) or (B, n, n), g (B, n), lo/hi (n,) or (B, n), out z (B, n):
// float32, contiguous, on the device. P problems per block (P * n threads,
// at most 1024); smem_bytes of dynamic shared memory, reckoned by the
// caller as ((per_problem ? P : 1) * n * n + 2 * P * n) floats. Returns the
// first CUDA error of the attribute call or the launch.
extern "C" int admm_iterate_launch(const float* Minv, const float* g, const float* lo,
                                   const float* hi, float* z_out, int B, int n, int P,
                                   int per_problem, int per_bounds, float rho, float alpha,
                                   float one_minus_alpha, int iters, int smem_bytes,
                                   cudaStream_t stream) {
  if (P < 1 || P * n > 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      admm_iterate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + P - 1) / P);
  admm_iterate_kernel<<<grid, P * n, smem_bytes, stream>>>(
      Minv, g, lo, hi, z_out, B, n, P, per_problem, per_bounds, rho, alpha,
      one_minus_alpha, iters);
  return (int)cudaGetLastError();
}
