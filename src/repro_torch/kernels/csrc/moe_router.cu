// Fused MoE router for Hopper (sm_90a): softmax over the experts -> top-k ->
// renormalise.
//
// Replaces the TPU kernel repro/kernels/moe_router.py (moe_router_pallas,
// body _kernel).  Same contract: logits (T,E) fp32 or bf16, computed in fp32;
// weights (T,k) fp32 and expert indices (T,k) int32.  Top-k is k rounds of
// argmax and mask: among equal probabilities the lowest index wins (as in
// lax.top_k and jnp.argmax), and the winner is set to -1 for the rounds
// after it.  The k weights are renormalised by max(their sum, 1e-9).  On
// request it also writes each row's fp32 max m and sum s of exponentials
// (8 B a row), from which the backward (moe_router_bwd.cu) makes its
// probabilities; the weights and indices are the same bits either way.
//
// What bounds it on this card.  Per row, about E exponentials and (k + 3) E
// compares and adds against 4E (fp32) bytes read and 8k bytes written.  At
// granite-moe's prefill shape (T=4096, E=40, k=8) that is ~0.92 MB, 0.27 us
// at 3.35 TB/s, and ~2 MFLOP, 0.03 us at 67 TFLOP/s.  Neither is what takes
// the time: every row is one warp's chain of dependent steps, and all rows
// run at once (at most ~31 warps an SM at prefill, 2 at decode), so the
// kernel lasts the launch plus one row's chain.
//
// What the design does about it: it shortens the chain.  One warp owns one
// row; each lane keeps ceil(E/32) (rounded up to 1, 2, 4 or 8) values in
// registers, expert j*32 + lane in slot j.
// - The row's max is one redux.sync (__reduce_max_sync) on the logits'
//   bits mapped to an unsigned order, not five shuffle levels.
// - Each probability p/s (the rounded quotient, as JAX selects on it) gets
//   an unsigned key: its bits + 1 while it is live, 0 once it has won.
//   Non-negative fp32 orders as its bits, so the keys order as the
//   probabilities; a probability that underflowed to 0.0 (key 1) still
//   beats a masked winner, as in JAX, where the winner becomes -1.0.
// - Each top-k round takes the lane's best key in registers, then one
//   redux.sync for the warp's largest key and a second for the lowest
//   index holding it (a lane offers its lowest such index, or ~0u).  The
//   old design spent five levels of two shuffles and a compare-select a
//   round.  One ballot a slot in place of the second redux.sync gave the
//   same answer in more instructions and more time.
// - Every lane learns each round's winner (the reductions are warp-wide),
//   so lane r keeps round r's weight and index and lanes 0..k-1 write the
//   row's k outputs with one coalesced store each.
// The sum of the exponentials stays a shuffle tree: redux.sync adds
// integers only.  expf and the division are the accurate ones (no fast
// math): an index may differ from the plain version's only where two
// probabilities are within an ulp.  The softmax is row_exp of
// moe_router.cuh; the backward makes each probability from the m and s
// written here with prob() of the same header, so that they are these bit
// for bit.  The statistics cost one store by two lanes a row in an
// instantiation of their own; serving, which does not ask for them, runs
// one without that code.
#include "moe_router.cuh"

namespace {

using namespace moe_router;

// EXTRA: the instantiation that writes the row statistics and Z where
// their pointers are not null.
template <typename T, int VPL, bool EXTRA>
__global__ void __launch_bounds__(WARPS * 32) moe_router_kernel(
    const T* __restrict__ logits, float* __restrict__ w, int* __restrict__ idx,
    float* __restrict__ stats, float* __restrict__ zs, int n_rows, int E, int k) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (row >= n_rows) return;   // the whole warp leaves together
  const T* x = logits + row * E;

  // softmax in fp32 (moe_router.cuh); the row's max and sum on request
  float p[VPL], m;
  const float s = row_exp<T, VPL>(x, E, lane, p, m);
  if constexpr (EXTRA) {
    if (stats != nullptr && lane < 2) stats[2 * row + lane] = lane ? s : m;
  }
  // keys: a live probability's bits + 1; 0 for a slot past E or a winner
  unsigned key[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    key[j] = j * 32 + lane < E ? __float_as_uint(p[j] / s) + 1u : 0u;
  }

  // k rounds: the largest key, then the lowest index holding it
  float my_w = 0.f, total = 0.f;
  int my_i = 0;
#pragma unroll
  for (int r = 0; r < MAX_K; ++r) {
    if (r < k) {
      unsigned best = key[0];
#pragma unroll
      for (int j = 1; j < VPL; ++j) best = max(best, key[j]);
      const unsigned top = __reduce_max_sync(FULL, best);   // >= 1: r < k <= E
      unsigned mine = 0xffffffffu;   // this lane's lowest index holding top
#pragma unroll
      for (int j = VPL - 1; j >= 0; --j) {
        if (key[j] == top) mine = j * 32 + lane;
      }
      const int win = static_cast<int>(__reduce_min_sync(FULL, mine));
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        if (j * 32 + lane == win) key[j] = 0u;
      }
      const float pw = __uint_as_float(top - 1u);
      total += pw;
      if (lane == r) { my_w = pw; my_i = win; }
    }
  }
  const float z = fmaxf(total, 1e-9f);
  if (lane < k) {
    w[row * k + lane] = my_w / z;
    idx[row * k + lane] = my_i;
  }
  if constexpr (EXTRA) {
    if (zs != nullptr && lane == 0) zs[row] = z;
  }
}

template <typename T, bool EXTRA>
void launch_extra(const T* x, float* w, int* idx, float* stats, float* zs, int n_rows, int E,
                  int k, cudaStream_t stream) {
  const dim3 grid((n_rows + WARPS - 1) / WARPS), block(WARPS * 32);
  const int vpl = (E + 31) / 32;
  if (vpl <= 1) {
    moe_router_kernel<T, 1, EXTRA><<<grid, block, 0, stream>>>(x, w, idx, stats, zs, n_rows, E, k);
  } else if (vpl <= 2) {
    moe_router_kernel<T, 2, EXTRA><<<grid, block, 0, stream>>>(x, w, idx, stats, zs, n_rows, E, k);
  } else if (vpl <= 4) {
    moe_router_kernel<T, 4, EXTRA><<<grid, block, 0, stream>>>(x, w, idx, stats, zs, n_rows, E, k);
  } else {
    moe_router_kernel<T, 8, EXTRA><<<grid, block, 0, stream>>>(x, w, idx, stats, zs, n_rows, E, k);
  }
}

template <typename T>
int launch(const void* logits, float* w, int* idx, float* stats, float* zs, int n_rows, int E,
           int k, cudaStream_t stream) {
  const T* x = static_cast<const T*>(logits);
  if (stats != nullptr || zs != nullptr) {
    launch_extra<T, true>(x, w, idx, stats, zs, n_rows, E, k, stream);
  } else {
    launch_extra<T, false>(x, w, idx, stats, zs, n_rows, E, k, stream);
  }
  return cudaGetLastError();
}

}  // namespace

// logits contiguous (T,E), dtype 0 = fp32, 1 = bf16; out holds 2*T*k 32-bit
// words: the (T,k) fp32 weights, then the (T,k) int32 indices.  stats, if
// not null, receives each row's fp32 (max, sum of exponentials), (T,2); z,
// if not null, each row's Z = max(sum of the k selected, 1e-9), (T,), for
// checks.  Takes 1 <= E <= 256 and 1 <= k <= min(8, E).  Returns the
// launch's cudaError_t (0 on success); the launch does not synchronise.
extern "C" int moe_router_fwd(const void* logits, void* out, void* stats, void* z, int dtype,
                              int T, int E, int k, void* stream) {
  if (T <= 0 || E <= 0 || E > MAX_E || k <= 0 || k > MAX_K || k > E) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(out);
  int* idx = static_cast<int*>(out) + static_cast<long long>(T) * k;
  float* st = static_cast<float*>(stats);
  float* zs = static_cast<float*>(z);
  switch (dtype) {
    case 0: return launch<float>(logits, w, idx, st, zs, T, E, k, s);
    case 1: return launch<__nv_bfloat16>(logits, w, idx, st, zs, T, E, k, s);
    default: return cudaErrorInvalidValue;
  }
}
