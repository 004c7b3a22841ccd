// The two roofline kernels for Hopper (sm_90a): the rates of the operations
// the rollout kernels spend their time on.
//
// Kernel 9, roofline_op<Op>, replaces the TPU kernel of
// scripts/roofline.py:measure_pallas_op (kernel body :88-94): each element
// of x has the operation Op applied `inner` times in a row and the last
// value written to out. Op is one of the rows of the reference script: fma
// (x * 1.000001 + 1e-7), cos, sin, log(|x| + 1), div (0.731 / (x + 1)) and
// exp(-|x|). The reference runs its XLA rows as fused element-wise passes
// and its Pallas rows as this kernel; here both are this kernel, the chain
// in a register.
//
// Kernel 10, roofline_noise<Paired>, replaces the TPU kernel of
// scripts/roofline.py:measure_pallas_noise (kernel body :133-146): program
// g sums `inner` tiles of (8, 512) standard normals. The TPU kernel draws
// them from the core's hardware generator, which has no counterpart off the
// TPU; this kernel draws the stream kernels 1 and 3 consume,
// bmpc::interp_normal (models.cuh): program g, iteration i, element (s, l)
// takes the normal of ops/fused_mppi.py:interp_normals(seed + g, i, 512)
// at (s, l). The paired form adds both halves of that one Box-Muller draw,
// r * cos and r * sin of the same two uniforms (the reference's
// _std_normal_pair).
//
// Bound on the H100: both are built to be bound by the rate at which the
// SMs issue instructions; the bytes (one read and one write of each element,
// or one write) are nothing beside `inner` operations an element.
// chip_smoke.py counts the SASS instructions of the chain's loop and prints
// that floor beside each measured rate.
// Design: one thread per element, the running value in a register, the
// chain unrolled by kUnroll so that the loop's own counter and branch are a
// small share of what a trip issues (a runtime loop, never the whole chain:
// `inner` reaches 131,072). The flags are the other kernels' (_build.py:
// --fmad=false, no fast math), so the rates are those of the cosf, logf,
// sincosf and divisions the rollout kernels compile to.
#include <cuda_runtime.h>

#include "models.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr int kSublanes = 8;
constexpr int kLanes = 512;
constexpr int kTile = kSublanes * kLanes;

struct OpFma {
  __device__ static float apply(float x) { return x * 1.000001f + 1e-7f; }
};
struct OpCos {
  __device__ static float apply(float x) { return cosf(x); }
};
struct OpSin {
  __device__ static float apply(float x) { return sinf(x); }
};
struct OpLog {
  __device__ static float apply(float x) { return logf(fabsf(x) + 1.0f); }
};
struct OpDiv {
  __device__ static float apply(float x) { return 0.731f / (x + 1.0f); }
};
struct OpExp {
  __device__ static float apply(float x) { return expf(-fabsf(x)); }
};

template <class Op>
__global__ void __launch_bounds__(kThreads)
roofline_op(const float* __restrict__ x, float* __restrict__ out, long long n, int inner) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float v = x[e];
  const int whole = inner - inner % kUnroll;
#pragma unroll 1
  for (int k = 0; k < whole; k += kUnroll) {
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) v = Op::apply(v);
  }
#pragma unroll 1
  for (int k = whole; k < inner; ++k) v = Op::apply(v);
  out[e] = v;
}

template <bool Paired>
__global__ void __launch_bounds__(kThreads)
roofline_noise(const int* __restrict__ seed, float* __restrict__ out, int programs, int inner) {
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (gid >= (long long)programs * kTile) return;
  const uint32_t g = (uint32_t)(gid / kTile);
  const uint32_t e = (uint32_t)(gid % kTile);  // s * 512 + l
  const uint32_t seed_c = (uint32_t)seed[0] + g;
  float acc = 0.0f;
#pragma unroll 1
  for (int i = 0; i < inner; ++i) {
    if (Paired) {  // interp_normal's draw, both halves
      const float u1 = bmpc::u01(bmpc::mix32(seed_c, (uint32_t)i, e)) + 1e-7f;
      const float u2 = bmpc::u01(bmpc::mix32(seed_c, (uint32_t)i, e + kTile));
      const float r = sqrtf(-2.0f * logf(u1));
      float s, c;
      sincosf((2.0f * (float)bmpc::kPi) * u2, &s, &c);
      acc = acc + r * c;
      acc = acc + r * s;
    } else {
      acc = acc + bmpc::interp_normal(seed_c, (uint32_t)i, e, e + kTile);
    }
  }
  out[gid] = acc;
}

}  // namespace

// The operations of kernel 9, in ops/roofline.py:OPS's order.
#define ROOFLINE_DISPATCH_OP(op, ...)                   \
  switch (op) {                                         \
    case 0: { using Op = OpFma; __VA_ARGS__ }           \
    case 1: { using Op = OpCos; __VA_ARGS__ }           \
    case 2: { using Op = OpSin; __VA_ARGS__ }           \
    case 3: { using Op = OpLog; __VA_ARGS__ }           \
    case 4: { using Op = OpDiv; __VA_ARGS__ }           \
    case 5: { using Op = OpExp; __VA_ARGS__ }           \
    default: return (int)cudaErrorInvalidValue;         \
  }

// x, out (n,): float32, contiguous, on the device; op an index of
// ops/roofline.py:OPS. Returns the launch's cudaGetLastError().
extern "C" int roofline_op_launch(int op, const float* x, float* out, long long n, int inner,
                                  cudaStream_t stream) {
  if (n <= 0) return 0;
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  ROOFLINE_DISPATCH_OP(op,
    roofline_op<Op><<<grid, kThreads, 0, stream>>>(x, out, n, inner);
    return (int)cudaGetLastError();)
}

// seed (1,) int32 and out (programs, 8, 512) float32, contiguous, on the
// device. Returns the launch's cudaGetLastError().
extern "C" int roofline_noise_launch(int paired, const int* seed, float* out, int programs,
                                     int inner, cudaStream_t stream) {
  if (programs <= 0) return 0;
  const long long n = (long long)programs * kTile;
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  if (paired) {
    roofline_noise<true><<<grid, kThreads, 0, stream>>>(seed, out, programs, inner);
  } else {
    roofline_noise<false><<<grid, kThreads, 0, stream>>>(seed, out, programs, inner);
  }
  return (int)cudaGetLastError();
}

// The launch shape of kernel 9 at op (an index of OPS; paired >= 0 asks for
// kernel 10 instead, in that form) over n elements, on the current card,
// into out[4]: threads per block, blocks, registers per thread, resident
// blocks per SM. Returns a cudaError.
template <class K>
int shape_of(K kernel, long long n, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  const int vals[4] = {kThreads, (int)((n + kThreads - 1) / kThreads), attr.numRegs, per_sm};
  for (int i = 0; i < 4; ++i) out[i] = vals[i];
  return 0;
}

extern "C" int roofline_launch_config(int op, int paired, long long n, int* out) {
  if (paired == 1) return shape_of(roofline_noise<true>, n, out);
  if (paired == 0) return shape_of(roofline_noise<false>, n, out);
  ROOFLINE_DISPATCH_OP(op, return shape_of(roofline_op<Op>, n, out);)
}
