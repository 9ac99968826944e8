// Device helpers shared by the MoE router's forward (moe_router.cu) and its
// backward (moe_router_bwd.cu).  The forward takes a row's softmax from
// row_exp and, on request, writes the row's max m and sum s; the backward
// makes each probability from them with prob(), the same two operations as
// the forward's exp and quotient, so its probabilities, and the sum of the
// k selected ones, are the forward's bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace moe_router {

constexpr int WARPS = 4;      // rows per block, one warp a row
constexpr int MAX_K = 8;      // top_k
constexpr int MAX_E = 256;    // experts: 8 values a lane
constexpr unsigned FULL = 0xffffffffu;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as PyTorch's .to(bfloat16)
}

// fp32 -> unsigned with the same order (-inf lowest): flip a negative's
// bits, set a non-negative's sign bit.
__device__ __forceinline__ unsigned order_bits(float x) {
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : b | 0x80000000u;
}
__device__ __forceinline__ float from_order_bits(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? u & 0x7fffffffu : ~u);
}

// One row's softmax in fp32, by the warp that owns it: lane ``lane`` keeps
// expert j*32 + lane in slot j.  On return p[j] = exp(x - m) (0 past E), m
// holds the row's max, and the row's sum of the exponentials is returned to
// every lane; the probability is the rounded quotient p[j] / sum.  The max
// is one redux.sync on the logits' bits in unsigned order, the sum a
// shuffle tree (redux.sync adds integers only); expf is the accurate one
// (no fast math).
template <typename T, int VPL>
__device__ __forceinline__ float row_exp(const T* __restrict__ x, int E, int lane,
                                         float (&p)[VPL], float& m) {
  m = -INFINITY;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int e = j * 32 + lane;
    p[j] = e < E ? to_f32(x[e]) : -INFINITY;
    m = fmaxf(m, p[j]);
  }
  m = from_order_bits(__reduce_max_sync(FULL, order_bits(m)));
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    p[j] = j * 32 + lane < E ? expf(p[j] - m) : 0.f;
    s += p[j];
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  return s;
}

// A logit's probability from its row's max m and sum s of exponentials:
// row_exp's exponential, then its quotient, so that it is the forward's bit
// for bit.
__device__ __forceinline__ float prob(float x, float m, float s) { return expf(x - m) / s; }

}  // namespace moe_router
