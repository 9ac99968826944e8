// Backward of the RG-LRU linear-recurrence scan for Hopper (sm_90a).
//
// The gradient of the TPU kernel repro/kernels/rglru_scan.py (rglru_scan_pallas;
// JAX itself differentiates its jnp scan, the kernel is forward-only).  The
// forward is h_t = a_t * h_{t-1} + b_t with h_{-1} = h0 (zeros when absent).
// Given dh, the gradient of h, the backward is the same kind of recurrence
// run from the last step to the first, with g_S = 0:
//   g_t  = dh_t + a_{t+1} * g_{t+1}
//   da_t = g_t * h_{t-1},  db_t = g_t,  dh0 = a_0 * g_0.
// a, h, dh, da, db (B,S,R) fp32; h0 and dh0 (B,R) fp32; the carry is fp32.
//
// What bounds it on this card.  Two flops per element against 20 bytes (a,
// dh and the forward's h read once, da and db written once): at the training
// shape (recurrentgemma-9b, B=8 S=512 R=4096) ~336 MB, ~100 us at 3.35 TB/s,
// against ~1 us of arithmetic.  It is bound by bytes.
//
// What the design does about it.  The forward's: one thread owns one (b, r)
// lane and keeps the carry in a register, so neighbouring threads read
// neighbouring r (coalesced rows) at every step, and the loop loads UNROLL
// steps of a, dh and h_{t-1} before it uses them.  A step reads a_t for the
// step before it, so each element of a is read once.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;     // threads per block: 128 consecutive r of one b
constexpr int UNROLL = 8;   // time steps loaded ahead

__global__ void __launch_bounds__(NT) rglru_scan_bwd_kernel(
    const float* __restrict__ a, const float* __restrict__ h0, const float* __restrict__ h,
    const float* __restrict__ dh, float* __restrict__ da, float* __restrict__ db,
    float* __restrict__ dh0, int S, int R) {
  const int r = blockIdx.x * NT + threadIdx.x;
  if (r >= R) return;
  const long long lane = (long long)blockIdx.y * S * R + r;
  const float first = h0 != nullptr ? h0[(long long)blockIdx.y * R + r] : 0.f;
  // h_{t-1}: the forward's output one step back, h0 (or 0) before step 0
  auto h_prev = [&](int t) { return t > 0 ? h[lane + (long long)(t - 1) * R] : first; };
  float g = 0.f, a_next = 0.f;    // g_{t+1} and a_{t+1}; both 0 past the last step
  int t = S;
  for (; t >= UNROLL; t -= UNROLL) {
    float av[UNROLL], dv[UNROLL], hv[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int i = t - 1 - j;
      av[j] = a[lane + (long long)i * R];
      dv[j] = dh[lane + (long long)i * R];
      hv[j] = h_prev(i);
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const long long off = lane + (long long)(t - 1 - j) * R;
      g = dv[j] + a_next * g;
      da[off] = g * hv[j];
      db[off] = g;
      a_next = av[j];
    }
  }
  for (; t > 0; --t) {
    const long long off = lane + (long long)(t - 1) * R;
    g = dh[off] + a_next * g;
    da[off] = g * h_prev(t - 1);
    db[off] = g;
    a_next = a[off];
  }
  if (dh0 != nullptr) dh0[(long long)blockIdx.y * R + r] = a_next * g;
}

}  // namespace

// a, h, dh, da, db contiguous (B,S,R) fp32; h0 contiguous (B,R) fp32 or null
// for zeros; dh0 (B,R) fp32 or null when h0 needs no gradient.  Returns the
// launch's cudaError_t (0 on success); the launch does not synchronise.
extern "C" int rglru_scan_bwd(const void* a, const void* h0, const void* h, const void* dh,
                              void* da, void* db, void* dh0, int B, int S, int R,
                              void* stream) {
  if (B <= 0 || S <= 0 || R <= 0 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((R + NT - 1) / NT, B);
  rglru_scan_bwd_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<const float*>(h), static_cast<const float*>(dh), static_cast<float*>(da),
      static_cast<float*>(db), static_cast<float*>(dh0), S, R);
  return cudaGetLastError();
}
