// Backward of the fused MoE router (moe_router.cu) for Hopper (sm_90a): the
// gradient of the logits from the gradient of the k renormalised weights.
//
// Replaces the gradient of the TPU kernel repro/kernels/moe_router.py
// (moe_router_pallas, forward only; JAX trains through jax.nn.softmax ->
// lax.top_k -> renormalise, whose autograd this follows).  With the row's
// probabilities p = softmax(logits) in fp32, its selected experts idx_j and
// weights w_j = p[idx_j] / Z, Z = max(sum_j p[idx_j], 1e-9), and dw the
// gradient of w:
//   dp[idx_j] = (dw_j - sum_m dw_m w_m) / Z, 0 elsewhere;
//   dlogits   = p * (dp - sum_e p_e dp_e),
// written in the logits' dtype (fp32 or bf16).  The last sum is zero but
// for rounding, so an unselected logit gets that residue times p_e, as in
// JAX.  The indices take no gradient.
//
// What bounds it on this card.  Per row it reads the logits (4E bytes in
// fp32) and k weights, indices and weight gradients (12k), and writes E
// gradients: at granite-moe's training shape (T=4096, E=40, k=8) 416 B a
// row, 1.70 MB, 0.51 us at 3.35 TB/s; about 9E + 5k operations a row,
// 1.6 MFLOP, 0.02 us at 67 TFLOP/s.  Neither is what takes the time: as in
// the forward, every row is one warp's chain of dependent steps and all
// rows run at once, so the kernel lasts the launch plus one row's chain.
//
// What the design does about it: one warp owns one row, as in the forward,
// and keeps every step in registers and shuffles.
// - The row's softmax is the forward's own (row_exp in moe_router.cuh):
//   the same redux.sync max, accurate expf, shuffle-tree sum and rounded
//   quotient, so each probability is the one the forward selected on.
// - Lanes 0..k-1 hold round j's index, weight and weight gradient (one
//   coalesced load each).  Lane j reads p[idx_j] from the lane that owns
//   the expert (one shuffle a slot), and Z is summed in the forward's
//   order, round 0 first, so it is the forward's Z bit for bit.
// - sum_m dw_m w_m and sum_e p_e dp_e are shuffle trees over the k lanes;
//   then the k pairs (idx_j, dp_j) are broadcast with shuffles and each
//   lane picks out its own experts' dp.
// Every sum is taken in a fixed order and nothing is atomic: two runs give
// the same bits.
#include "moe_router.cuh"

namespace {

using namespace moe_router;

template <typename T, int VPL>
__global__ void __launch_bounds__(WARPS * 32) moe_router_bwd_kernel(
    const T* __restrict__ logits, const float* __restrict__ w, const int* __restrict__ idx,
    const float* __restrict__ dw, T* __restrict__ dlogits, int n_rows, int E, int k) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (row >= n_rows) return;   // the whole warp leaves together

  // the forward's probabilities (0 past E)
  float q[VPL];
  const float s = row_exp<T, VPL>(logits + row * E, E, lane, q);
#pragma unroll
  for (int j = 0; j < VPL; ++j) q[j] = q[j] / s;

  // lane j < k: round j's expert, its weight, the weight's gradient, and
  // its probability from the lane that owns the expert
  const bool live = lane < k;
  const long long o = row * k + lane;
  const int my_i = live ? idx[o] : 0;
  const float my_w = live ? w[o] : 0.f;
  const float my_dw = live ? dw[o] : 0.f;
  float my_p = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const float v = __shfl_sync(FULL, q[j], my_i & 31);
    if (j == (my_i >> 5)) my_p = v;
  }
  if (!live) my_p = 0.f;

  // Z in the forward's order: round 0 first
  float total = 0.f;
#pragma unroll
  for (int r = 0; r < MAX_K; ++r) {
    if (r < k) total += __shfl_sync(FULL, my_p, r);
  }
  const float z = fmaxf(total, 1e-9f);

  float c = my_dw * my_w;                    // sum_m dw_m w_m
#pragma unroll
  for (int off = 16; off; off >>= 1) c += __shfl_xor_sync(FULL, c, off);
  const float my_dp = live ? (my_dw - c) / z : 0.f;
  float pdp = my_p * my_dp;                  // sum_e p_e dp_e
#pragma unroll
  for (int off = 16; off; off >>= 1) pdp += __shfl_xor_sync(FULL, pdp, off);

  // each lane's experts: dp where selected, else 0
  float d[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) d[j] = 0.f;
#pragma unroll
  for (int r = 0; r < MAX_K; ++r) {
    if (r < k) {
      const int e = __shfl_sync(FULL, my_i, r);
      const float g = __shfl_sync(FULL, my_dp, r);
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        if (j * 32 + lane == e) d[j] = g;
      }
    }
  }
  T* out = dlogits + row * E;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int e = j * 32 + lane;
    if (e < E) out[e] = from_f32<T>(q[j] * (d[j] - pdp));
  }
}

template <typename T, int VPL>
void launch_vpl(const T* x, const float* w, const int* idx, const float* dw, T* dx, int n_rows,
                int E, int k, cudaStream_t stream) {
  const dim3 grid((n_rows + WARPS - 1) / WARPS), block(WARPS * 32);
  moe_router_bwd_kernel<T, VPL><<<grid, block, 0, stream>>>(x, w, idx, dw, dx, n_rows, E, k);
}

template <typename T>
int launch(const void* logits, const float* w, const int* idx, const float* dw, void* dlogits,
           int n_rows, int E, int k, cudaStream_t stream) {
  const T* x = static_cast<const T*>(logits);
  T* dx = static_cast<T*>(dlogits);
  switch (values_per_lane(E)) {
    case 1: launch_vpl<T, 1>(x, w, idx, dw, dx, n_rows, E, k, stream); break;
    case 2: launch_vpl<T, 2>(x, w, idx, dw, dx, n_rows, E, k, stream); break;
    case 4: launch_vpl<T, 4>(x, w, idx, dw, dx, n_rows, E, k, stream); break;
    default: launch_vpl<T, 8>(x, w, idx, dw, dx, n_rows, E, k, stream);
  }
  return cudaGetLastError();
}

}  // namespace

// logits contiguous (T,E), dtype 0 = fp32, 1 = bf16; w, idx and dw
// contiguous (T,k): the forward's fp32 weights and int32 indices and the
// fp32 gradient of the weights; dlogits (T,E) in the logits' dtype.  Takes
// 1 <= E <= 256 and 1 <= k <= min(8, E).  Returns the launch's cudaError_t
// (0 on success); the launch does not synchronise.
extern "C" int moe_router_bwd(const void* logits, const void* w, const void* idx, const void* dw,
                              void* dlogits, int dtype, int T, int E, int k, void* stream) {
  if (T <= 0 || E <= 0 || E > MAX_E || k <= 0 || k > MAX_K || k > E) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const int* ii = static_cast<const int*>(idx);
  const float* dwf = static_cast<const float*>(dw);
  switch (dtype) {
    case 0: return launch<float>(logits, wf, ii, dwf, dlogits, T, E, k, s);
    case 1: return launch<__nv_bfloat16>(logits, wf, ii, dwf, dlogits, T, E, k, s);
    default: return cudaErrorInvalidValue;
  }
}
