// Fused MoE router for Hopper (sm_90a): softmax over the experts -> top-k ->
// renormalise.
//
// Replaces the TPU kernel repro/kernels/moe_router.py (moe_router_pallas,
// body _kernel).  Same contract: logits (T,E) fp32 or bf16, computed in fp32;
// weights (T,k) fp32 and expert indices (T,k) int32.  Top-k is k rounds of
// argmax and mask: among equal probabilities the lowest index wins (as in
// lax.top_k and jnp.argmax), and the winner is set to -1 for the rounds
// after it.  The k weights are renormalised by max(their sum, 1e-9).
//
// What bounds it on this card.  Per row, about E exponentials and (k + 3) E
// compares and adds against 4E (fp32) bytes read and 8k bytes written.  At
// granite-moe's prefill shape (T=4096, E=40, k=8) that is ~0.92 MB, 0.27 us
// at 3.35 TB/s, and ~2 MFLOP, 0.03 us at 67 TFLOP/s: bytes bound it, and at
// this size the launch itself (a few us) takes longer than either.
//
// What the design does about it.  The (T,E) probabilities never go back to
// device memory, which is the TPU kernel's saving over an unfused softmax
// followed by top_k.  One warp owns one row, eight rows to a block; each lane
// keeps ceil(E/32) (rounded up to 1, 2, 4 or 8) of the row's values in
// registers.  The max and the sum are warp shuffles, and each top-k round is
// a shuffle argmax over (value, index) pairs.  Rows >= T are masked by the
// kernel, so nothing is padded; the TPU's 256-row blocks are not carried
// over.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int WARPS = 8;      // rows per block
constexpr int MAX_K = 8;      // top_k
constexpr int MAX_E = 256;    // experts: 8 values a lane
constexpr unsigned FULL = 0xffffffffu;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int VPL>
__global__ void __launch_bounds__(WARPS * 32) moe_router_kernel(
    const T* __restrict__ logits, float* __restrict__ w, int* __restrict__ idx,
    int n_rows, int E, int k) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (row >= n_rows) return;   // the whole warp leaves together
  const T* x = logits + row * E;

  // softmax in fp32: lane holds experts lane, lane + 32, ...
  float p[VPL];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int e = j * 32 + lane;
    p[j] = e < E ? to_f32(x[e]) : -INFINITY;
    m = fmaxf(m, p[j]);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    p[j] = j * 32 + lane < E ? expf(p[j] - m) : 0.f;
    s += p[j];
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    // slots past E hold -inf and never win; a masked winner holds -1
    p[j] = j * 32 + lane < E ? p[j] / s : -INFINITY;
  }

  // k rounds of argmax over (value, index), lowest index first among equals
  float wk[MAX_K];
  int ik[MAX_K];
  float total = 0.f;
#pragma unroll
  for (int r = 0; r < MAX_K; ++r) {
    if (r < k) {
      float bv = -INFINITY;
      int bi = INT_MAX;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {   // ascending index: strict > keeps the lowest
        if (p[j] > bv) { bv = p[j]; bi = j * 32 + lane; }
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) {
        const float ov = __shfl_xor_sync(FULL, bv, o);
        const int oi = __shfl_xor_sync(FULL, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
      }
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        if (j * 32 + lane == bi) p[j] = -1.f;
      }
      wk[r] = bv;
      ik[r] = bi;
      total += bv;
    }
  }
  const float denom = fmaxf(total, 1e-9f);
#pragma unroll
  for (int r = 0; r < MAX_K; ++r) {
    if (r < k && lane == r) {
      w[row * k + r] = wk[r] / denom;
      idx[row * k + r] = ik[r];
    }
  }
}

template <typename T>
int launch(const void* logits, void* w, void* idx, int n_rows, int E, int k,
           cudaStream_t stream) {
  const dim3 grid((n_rows + WARPS - 1) / WARPS), block(WARPS * 32);
  const T* x = static_cast<const T*>(logits);
  float* wo = static_cast<float*>(w);
  int* io = static_cast<int*>(idx);
  const int vpl = (E + 31) / 32;
  if (vpl <= 1) {
    moe_router_kernel<T, 1><<<grid, block, 0, stream>>>(x, wo, io, n_rows, E, k);
  } else if (vpl <= 2) {
    moe_router_kernel<T, 2><<<grid, block, 0, stream>>>(x, wo, io, n_rows, E, k);
  } else if (vpl <= 4) {
    moe_router_kernel<T, 4><<<grid, block, 0, stream>>>(x, wo, io, n_rows, E, k);
  } else {
    moe_router_kernel<T, 8><<<grid, block, 0, stream>>>(x, wo, io, n_rows, E, k);
  }
  return cudaGetLastError();
}

}  // namespace

// logits contiguous (T,E), dtype 0 = fp32, 1 = bf16; w (T,k) fp32 and idx
// (T,k) int32 contiguous.  Takes 1 <= E <= 256 and 1 <= k <= min(8, E).
// Returns the launch's cudaError_t (0 on success); the launch does not
// synchronise.
extern "C" int moe_router_fwd(const void* logits, void* w, void* idx, int dtype,
                              int T, int E, int k, void* stream) {
  if (T <= 0 || E <= 0 || E > MAX_E || k <= 0 || k > MAX_K || k > E) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(logits, w, idx, T, E, k, s);
    case 1: return launch<__nv_bfloat16>(logits, w, idx, T, E, k, s);
    default: return cudaErrorInvalidValue;
  }
}
