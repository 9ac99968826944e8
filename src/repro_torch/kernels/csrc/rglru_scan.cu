// RG-LRU linear-recurrence scan for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t.
//
// Replaces the TPU kernel repro/kernels/rglru_scan.py (rglru_scan_pallas,
// body _kernel).  Same contract: a, b (B,S,R) fp32, an optional initial
// state h0 (B,R) fp32 (absent means zeros), h (B,S,R) fp32; the carry is
// fp32.
//
// What bounds it on this card.  Two flops per element against 12 bytes (a
// and b read once, h written once): at the serving shape (recurrentgemma-9b
// prefill, B=8 S=512 R=4096) ~201 MB, ~60 us at 3.35 TB/s, against ~1 us of
// arithmetic.  It is bound by bytes.
//
// What the design does about it.  The TPU grid's sequential time axis
// becomes a loop inside each thread: one thread owns one (b, r) lane and
// keeps its carry in a register, so neighbouring threads read neighbouring r
// (coalesced 128-byte rows) at every step.  The loop loads UNROLL steps of a
// and b before it uses them, so that each thread has that many independent
// loads in flight to cover the memory latency.  B*R/128 blocks (256 at the
// serving shape) spread over the 132 SMs.  Splitting the time axis across
// blocks (a two-pass scan) is left for later work.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;     // threads per block: 128 consecutive r of one b
constexpr int UNROLL = 8;   // time steps loaded ahead

__global__ void __launch_bounds__(NT) rglru_scan_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ h0, float* __restrict__ h, int S, int R) {
  const int r = blockIdx.x * NT + threadIdx.x;
  if (r >= R) return;
  const long long lane = (long long)blockIdx.y * S * R + r;
  float carry = h0 != nullptr ? h0[(long long)blockIdx.y * R + r] : 0.f;
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      av[j] = a[lane + (long long)(t + j) * R];
      bv[j] = b[lane + (long long)(t + j) * R];
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      carry = av[j] * carry + bv[j];
      h[lane + (long long)(t + j) * R] = carry;
    }
  }
  for (; t < S; ++t) {
    carry = a[lane + (long long)t * R] * carry + b[lane + (long long)t * R];
    h[lane + (long long)t * R] = carry;
  }
}

}  // namespace

// a, b, h contiguous (B,S,R) fp32; h0 contiguous (B,R) fp32 or null for
// zeros.  Returns the launch's cudaError_t (0 on success); the launch does
// not synchronise.
extern "C" int rglru_scan_fwd(const void* a, const void* b, const void* h0, void* h,
                              int B, int S, int R, void* stream) {
  if (B <= 0 || S <= 0 || R <= 0 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((R + NT - 1) / NT, B);
  rglru_scan_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h), S, R);
  return cudaGetLastError();
}
