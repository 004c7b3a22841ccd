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
// that floor, and the floor of the busiest pipe (FP32, MUFU, conversions,
// IMAD, the rest), beside each measured rate.
// Design: the running values in registers, the chain a runtime loop (never
// the whole chain: `inner` reaches 131,072) whose body is unrolled so that
// the loop's own counter and branch are a small share of what a trip
// issues. Kernel 9 gives a thread kElems independent elements (a block
// kThreads * kElems, neighbouring threads on neighbouring elements for each
// load and store) and applies the op to each in turn, kUnroll times a trip:
// a scheduler always has an independent instruction behind a libm body's
// dependent chain or a MUFU result. Kernel 10 draws kNoiseUnroll normals (or
// pairs) a trip, its counter's (seed, element) term hoisted and its step term
// stepped by one add a draw, through the reduced libm forms of models.cuh
// that kernels 1 and 3 draw through. The flags are the
// other kernels' (_build.py: --fmad=false, no fast math), so kernel 9's
// rates are those of the cosf, logf, sincosf and divisions the rollout
// kernels compile to.
// roofline_draw_domain (a check, no TPU counterpart) writes the draw's
// radius, cosine and sine through libm and through the reduced forms for all
// 2^24 inputs, for chip_smoke.py to compare bit for bit.
#include <cuda_runtime.h>

#include "models.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 16;      // kernel 9: applications to each element a trip
constexpr int kElems = 2;        // kernel 9: elements a thread
constexpr int kNoiseUnroll = 4;  // kernel 10: draws (or pairs) a trip
constexpr int kSublanes = 8;
constexpr int kLanes = 512;
constexpr int kTile = kSublanes * kLanes;
constexpr uint32_t kDomain = 1u << 24;

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
  const long long e0 = (long long)blockIdx.x * (kThreads * kElems) + threadIdx.x;
  if (e0 >= n) return;
  float v[kElems];  // past n: zeros, applied to and not written
#pragma unroll
  for (int j = 0; j < kElems; ++j) {
    const long long e = e0 + (long long)j * kThreads;
    v[j] = e < n ? x[e] : 0.0f;
  }
  const int whole = inner - inner % kUnroll;
#pragma unroll 1
  for (int k = 0; k < whole; k += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < kElems; ++j) v[j] = Op::apply(v[j]);
    }
  }
#pragma unroll 1
  for (int k = whole; k < inner; ++k) {
#pragma unroll
    for (int j = 0; j < kElems; ++j) v[j] = Op::apply(v[j]);
  }
#pragma unroll
  for (int j = 0; j < kElems; ++j) {
    const long long e = e0 + (long long)j * kThreads;
    if (e < n) out[e] = v[j];
  }
}

// One draw of counter c (its second uniform at c + kTile) added to acc:
// interp_normal's normal, or both halves, r * cos and then r * sin.
template <bool Paired>
__device__ __forceinline__ float add_draw(uint32_t c, float acc) {
  if (!Paired) return acc + bmpc::normal_at(c, c + kTile);
  const float r = bmpc::draw_radius(bmpc::fmix32(c) >> 8);
  float s, co;
  bmpc::sincos_turn(bmpc::draw_angle(bmpc::fmix32(c + kTile) >> 8), &s, &co);
  acc = acc + r * co;
  return acc + r * s;
}

template <bool Paired>
__global__ void __launch_bounds__(kThreads)
roofline_noise(const int* __restrict__ seed, float* __restrict__ out, int programs, int inner) {
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (gid >= (long long)programs * kTile) return;
  const uint32_t g = (uint32_t)(gid / kTile);
  const uint32_t e = (uint32_t)(gid % kTile);  // s * 512 + l
  const uint32_t seed_c = (uint32_t)seed[0] + g;
  // the counter of draw i, element e: seed_c * kSeedMul + e, then kStepMul more each draw
  uint32_t c = seed_c * bmpc::kSeedMul + e;
  float acc = 0.0f;
  const int whole = inner - inner % kNoiseUnroll;
#pragma unroll 1
  for (int i = 0; i < whole; i += kNoiseUnroll) {
#pragma unroll
    for (int u = 0; u < kNoiseUnroll; ++u) {
      acc = add_draw<Paired>(c, acc);
      c += bmpc::kStepMul;
    }
  }
#pragma unroll 1
  for (int i = whole; i < inner; ++i) {
    acc = add_draw<Paired>(c, acc);
    c += bmpc::kStepMul;
  }
  out[gid] = acc;
}

// out (8, 2^24): for each k < 2^24, the radius sqrt(-2 log(k 2^-24 + 1e-7)),
// cos(2 pi k 2^-24), and sin and cos of the same angle by sincos, each first
// through libm as the draw computed it before the reduced forms (rows 0, 2,
// 4, 6) and then through models.cuh's reduced forms (rows 1, 3, 5, 7).
__global__ void __launch_bounds__(kThreads) roofline_draw_domain(float* __restrict__ out) {
  const uint32_t k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= kDomain) return;
  const float u1 = (float)k * (1.0f / 16777216.0f) + 1e-7f;
  const float a = (2.0f * (float)bmpc::kPi) * ((float)k * (1.0f / 16777216.0f));
  const float b = bmpc::draw_angle(k);
  float s, c;
  out[k] = sqrtf(-2.0f * logf(u1));
  out[kDomain + k] = bmpc::draw_radius(k);
  out[2 * kDomain + k] = cosf(a);
  out[3 * kDomain + k] = bmpc::cos_turn(b);
  sincosf(a, &s, &c);
  out[4 * kDomain + k] = s;
  out[6 * kDomain + k] = c;
  bmpc::sincos_turn(b, &s, &c);
  out[5 * kDomain + k] = s;
  out[7 * kDomain + k] = c;
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
  const dim3 grid((unsigned)((n + kThreads * kElems - 1) / (kThreads * kElems)));
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

// out (8, 2^24) float32, contiguous, on the device: roofline_draw_domain's
// rows. Returns the launch's cudaGetLastError().
extern "C" int roofline_draw_domain_launch(float* out, cudaStream_t stream) {
  roofline_draw_domain<<<kDomain / kThreads, kThreads, 0, stream>>>(out);
  return (int)cudaGetLastError();
}

// The launch shape of kernel 9 at op (an index of OPS; paired >= 0 asks for
// kernel 10 instead, in that form) over n elements, on the current card,
// into out[6]: threads per block, blocks, registers per thread, resident
// blocks per SM, elements a thread, applications (kernel 9) or draws
// (kernel 10) a loop trip. Returns a cudaError.
template <class K>
int shape_of(K kernel, long long n, int elems, int unroll, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  const long long per_block = (long long)kThreads * elems;
  const int vals[6] = {kThreads, (int)((n + per_block - 1) / per_block), attr.numRegs, per_sm,
                       elems, unroll};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return 0;
}

extern "C" int roofline_launch_config(int op, int paired, long long n, int* out) {
  if (paired == 1) return shape_of(roofline_noise<true>, n, 1, kNoiseUnroll, out);
  if (paired == 0) return shape_of(roofline_noise<false>, n, 1, kNoiseUnroll, out);
  ROOFLINE_DISPATCH_OP(op, return shape_of(roofline_op<Op>, n, kElems, kUnroll, out);)
}
