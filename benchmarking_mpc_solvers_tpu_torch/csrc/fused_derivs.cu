// Fused trajectory-derivative kernel for Hopper (sm_90a): linearize the
// dynamics and Gauss-Newton-quadratize the stage cost at every (scenario, t)
// point of a batch of trajectories in one launch.
//
// Replaces the TPU kernel benchmarking_mpc_solvers_tpu/ops/fused_derivs.py:
// fused_derivs (kernel body :86). Per point (x, u) it pushes the S+1 basis
// tangents through the model's dynamics and feature transform, one pass per
// tangent as the reference does with jax.jvp, and forms
//   A = df/dx, Bd = df/du, c = f(x, u) - sum_j A_j x_j - Bd u (in that order),
//   grad = 2 J^T W_sym (z - g),  H = 2 J^T W_sym J  (J the transform Jacobian),
//   q = grad[:S], r = grad[S], Q = H[:S, :S], M = H[S, :S], R = H[S, S],
// with the rows of W_sym contracted over their nonzero entries only, in
// index order, and a feature row whose weights are all zero left out of the
// dot products (so an overflowed, unweighted feature cannot poison them).
// The tangents come from bmpc::DualN (models.cuh): the model functors are
// templates on the scalar, so the physics is written once.
//
// Bound on the H100: bytes. Per point the function reads S+1 floats and
// writes 2S^2 + 4S + 2 (50 at S = 4): 220 B, 22.5 MB at SQP's shape
// (B=1024, T=100), 6.7 us at 3.35 TB/s; the S+1 dual passes are ~2(S+1)
// model steps per point (acrobot: ~2.5 k FP32 operations, 0.26 G in all,
// 3.9 us at 67 TFLOP/s).
// Design:
// - One thread per point pushes all S+1 basis tangents through the model in
//   one pass of bmpc::DualN<S+1> (models.cuh): the value part of a dual pass
//   does not depend on its tangent, so it is computed once (one sinf/cosf
//   and one value division per operation instead of S+1), and tangent j
//   follows the same operations as a pass carrying tangent j alone, so each
//   Jacobian column has the bits of the one-tangent passes of the kernel
//   before this one (jax.jvp's, in the reference). The
//   transform Jacobian stays in registers for the Gauss-Newton products.
//   (Measured against it, on the same inputs: S+1 lanes a point, lane j
//   pushing tangent j, and one thread pushing the tangents one after another
//   were both slower at the Gauss-Newton iLQR and SQP shapes.)
// - A block of 4 warps owns a run of 128 consecutive points, and so one
//   contiguous range of each of the eight outputs. The outputs are staged in
//   shared memory, then each range is written with contiguous 16-byte
//   stores (4-byte stores where a range does not start on 16 bytes, and for
//   a ragged tail). Where 128 points' outputs pass the default 48 KB of
//   shared memory (the dummy at S = 6 to 8: 2S^2 + 4S + 2 floats a point), a
//   block of 2 warps owns 64 points.
// - c's residual i is summed over j in the reference order, from the A and
//   Bd entries staged for the point. Every value is computed as the
//   one-thread-per-point kernel before this one computed it, so the outputs
//   keep their bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "models.cuh"

namespace {

template <int S>
struct DerivLayout {
  // floats per point of output k: A, Bd, c, Q, R, M, q, r
  __host__ __device__ static constexpr int X(int k) {
    return (k == 0 || k == 3) ? S * S : (k == 4 || k == 7) ? 1 : S;
  }
  // the points a block owns (= its threads): 128 where their staged outputs
  // fit the default 48 KB, else 64
  static constexpr int kPoints = 128 * (2 * S * S + 4 * S + 2) * 4 <= 48 * 1024 ? 128 : 64;
  // staged output k's offset; kPoints is a multiple of 4, so each range
  // starts on 16 bytes
  __host__ __device__ static constexpr int off(int k) {
    return k == 0 ? 0 : off(k - 1) + kPoints * X(k - 1);
  }
  static constexpr int kBytes = off(8) * (int)sizeof(float);
  static_assert(kBytes <= 48 * 1024, "fused_derivs' shared memory must fit the default");
};

template <class M>
__global__ void __launch_bounds__(DerivLayout<M::S>::kPoints)
fused_derivs_kernel(const float* __restrict__ xs, const float* __restrict__ us,
                    const float* __restrict__ gz, float* __restrict__ A,
                    float* __restrict__ Bd, float* __restrict__ c, float* __restrict__ Q,
                    float* __restrict__ R, float* __restrict__ Mx, float* __restrict__ q,
                    float* __restrict__ r, int B, int T, bmpc::SymW w) {
  using bmpc::DualN;
  constexpr int S = M::S;
  constexpr int Z = S + 1;
  constexpr int D = S + 1;
  constexpr int kW = bmpc::kMaxZ;
  using L = DerivLayout<S>;
  constexpr int kThreads = L::kPoints;
  extern __shared__ float smem[];
  float* sA = smem + L::off(0);
  float* sBd = smem + L::off(1);
  float* sc = smem + L::off(2);
  float* sQ = smem + L::off(3);
  float* sR = smem + L::off(4);
  float* sM = smem + L::off(5);
  float* sq = smem + L::off(6);
  float* sr = smem + L::off(7);
  const int p = threadIdx.x;  // the point's index in the block
  const size_t BT = (size_t)B * T;
  const size_t n0 = (size_t)blockIdx.x * kThreads;
  const size_t n = n0 + p;

  if (n < BT) {
    const int b = (int)(n / T);
    const int t = (int)(n % T);
    const float* xp = xs + ((size_t)b * (T + 1) + t) * S;
    float x[S];
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = xp[i];
    const float u = us[n];

    // every tangent in one pass: tangent j is Jacobian column j
    DualN<D> xd[S], xn[S], zd[Z];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      xd[i] = DualN<D>(x[i]);
      xd[i].d[i] = 1.0f;
    }
    DualN<D> ud(u);
    ud.d[S] = 1.0f;
    M::dynamics(xd, ud, xn);
    M::transform(xd, ud, zd);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      // c = f - sum_j A_j x_j - Bd u, summed over j in order
      float res = xn[i].v;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        sA[(p * S + i) * S + j] = xn[i].d[j];
        res = res - xn[i].d[j] * x[j];
      }
      sBd[p * S + i] = xn[i].d[S];
      sc[p * S + i] = res - xn[i].d[S] * u;
    }

    // Wv = W_sym (z - g); a row of W_sym without a nonzero entry is skipped
    float Wv[Z];
    bool has[Z];
#pragma unroll
    for (int i = 0; i < Z; ++i) {
      float acc = 0.0f;
      has[i] = false;
#pragma unroll
      for (int k = 0; k < Z; ++k) {
        const float wik = w.w[i * kW + k];
        if (wik != 0.0f) {
          acc = acc + wik * (zd[k].v - gz[t * Z + k]);
          has[i] = true;
        }
      }
      Wv[i] = acc;
    }
    // grad[j] = 2 sum_i Jz[j][i] Wv[i], Jz[j][i] = d z_i / d (x, u)_j
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < Z; ++i)
        if (has[i]) acc = acc + zd[i].d[j] * Wv[i];
      if (j < S) {
        sq[p * S + j] = 2.0f * acc;
      } else {
        sr[p] = 2.0f * acc;
      }
    }
    // H[j1][j2] = 2 sum_i Jz[j1][i] (W_sym Jz[j2])[i], one column j2 at a time
#pragma unroll
    for (int j2 = 0; j2 < D; ++j2) {
      float WJ[Z];
#pragma unroll
      for (int i = 0; i < Z; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < Z; ++k) {
          const float wik = w.w[i * kW + k];
          if (wik != 0.0f) acc = acc + wik * zd[k].d[j2];
        }
        WJ[i] = acc;
      }
#pragma unroll
      for (int j1 = 0; j1 < D; ++j1) {
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < Z; ++i)
          if (has[i]) acc = acc + zd[i].d[j1] * WJ[i];
        const float h = 2.0f * acc;
        if (j1 < S && j2 < S) {
          sQ[(p * S + j1) * S + j2] = h;
        } else if (j1 == S && j2 < S) {
          sM[p * S + j2] = h;
        } else if (j1 == S && j2 == S) {
          sR[p] = h;
        }
      }
    }
  }
  __syncthreads();  // the block's outputs are staged

  // each output's range of the block, contiguous in global memory
  const int np = (int)min((size_t)kThreads, BT - n0);
  float* const outs[8] = {A, Bd, c, Q, R, Mx, q, r};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float* src = smem + L::off(k);
    float* dst = outs[k] + n0 * L::X(k);
    const int count = np * L::X(k);
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      done = count & ~3;
      for (int e = threadIdx.x * 4; e < done; e += kThreads * 4)
        *reinterpret_cast<float4*>(dst + e) = *reinterpret_cast<const float4*>(src + e);
    }
    for (int e = done + threadIdx.x; e < count; e += kThreads) dst[e] = src[e];
  }
}

}  // namespace

// xs (B, T+1, S), us (B, T), gz (T, S+1); out A (B, T, S, S), Bd (B, T, S),
// c (B, T, S), Q (B, T, S, S), R (B, T), Mx (B, T, S), q (B, T, S), r (B, T):
// float32, contiguous, on the device, 4-byte aligned (an output that starts
// on 16 bytes is written 16 bytes at a time). w_sym: host array of
// MAX_Z*MAX_Z dense symmetrised stage-cost weights. Returns the launch's
// cudaGetLastError().
extern "C" int fused_derivs_launch(int model_id, const float* xs, const float* us,
                                   const float* gz, float* A, float* Bd, float* c,
                                   float* Q, float* R, float* Mx, float* q, float* r,
                                   int B, int T, const float* w_sym,
                                   cudaStream_t stream) {
  bmpc::SymW w;
  for (int i = 0; i < bmpc::kMaxZ * bmpc::kMaxZ; ++i) w.w[i] = w_sym[i];
  const size_t n = (size_t)B * T;
  BMPC_DISPATCH_MODEL(model_id, {
    using L = DerivLayout<M::S>;
    const dim3 grid((unsigned)((n + L::kPoints - 1) / L::kPoints));
    fused_derivs_kernel<M><<<grid, L::kPoints, L::kBytes, stream>>>(
        xs, us, gz, A, Bd, c, Q, R, Mx, q, r, B, T, w);
  });
  return (int)cudaGetLastError();
}
