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
// fp32), the forward's row max and sum (8) and k weights, indices and
// weight gradients (12k), and writes E gradients: at granite-moe's training
// shape (T=4096, E=40, k=8) 424 B a row, 1.74 MB, 0.52 us at 3.35 TB/s
// (the function's own bytes, without the statistics, are 416 B a row);
// about 9E + 5k operations a row, 1.6 MFLOP, 0.02 us at 67 TFLOP/s.  Neither
// is what takes the time: all rows run at once, so the kernel lasts the
// launch plus one row's chain of dependent steps.
//
// What the design does about it: it shortens that chain to the loads, one
// exponential and quotient, one round of independent shuffles and a few
// dozen operations in registers.  The first design (one warp a row)
// recomputed the row's softmax to see the forward's probabilities bit for
// bit: a redux.sync for the max, a shuffle tree for the sum, k shuffles to
// fetch p[idx_j], k more to sum Z in the forward's order, two shuffle trees
// and 2k shuffles to broadcast (idx_j, dp_j): about 40 dependent shuffles.
// - The forward writes each row's max m and sum s on request (MoERouterFn
//   asks for them; 8 B a row).  A probability is prob(x, m, s) of
//   moe_router.cuh, expf(x - m) / s: the forward's bits, with no reduction.
// - A row has G lanes, G the fewest of 4, 8, 16, 32 that hold its E experts
//   at most 8 a lane (E=40: 8 lanes of 5, four rows a warp); lane l of the
//   group owns experts j*G + l, so the group's loads of the row coalesce.
// - Lane l also owns rounds l, l + G, ...: it re-reads its round's logit
//   (the row is in L1 by then) and makes that probability.  One round of k
//   independent shuffles in the group hands every lane all k of them.
// - Every lane loads the row's k triples (idx, w, dw), 16 or 8 B a load
//   where k and the pointers allow, and sums in registers and round order
//   (round 0 first): Z, the forward's sum bit for bit; sum_m dw_m w_m; and
//   sum_j p_j dp_j.  Every lane of the group repeats these few dozen
//   operations instead of waiting for another's.
// - Each lane writes its unselected experts' p (0 - that sum), and the lane
//   owning a round its expert's p (dp - that sum); a bit mask of the
//   lane's selected slots, built from the k indices, tells the two apart.
// - Every independent load goes out before the one that depends on an
//   index and before the first quotient, whose slow path is a branch that
//   the compiler moves nothing across; the factors 1/s and 1/Z take no
//   division (reciprocal()), only the quotients that must be the forward's
//   bits do.
// No redux.sync, no reduction across lanes and nothing atomic: every sum
// runs in a fixed order, so two runs give the same bits.
#include <cstdint>

#include "moe_router.cuh"

namespace {

using namespace moe_router;

constexpr int THREADS = 128;
constexpr int SLOTS = 8;   // experts a lane at most

// Lanes a row: the fewest of 4, 8, 16 and 32 that hold E experts at most
// SLOTS a lane.
inline int lanes_per_row(int E) { return E <= 32 ? 4 : E <= 64 ? 8 : E <= 128 ? 16 : 32; }

// A row's k 32-bit words, W words a load (4, 2 or 1; k is a multiple of W
// and the row's words are 4W-byte aligned).
template <int W>
__device__ __forceinline__ void load_row(const unsigned* __restrict__ p, int k,
                                         unsigned (&v)[MAX_K]) {
#pragma unroll
  for (int r = 0; r < MAX_K; r += W) {
    if (r < k) {
      if constexpr (W == 4) {
        const uint4 q = *reinterpret_cast<const uint4*>(p + r);
        v[r] = q.x; v[r + 1] = q.y; v[r + 2] = q.z; v[r + 3] = q.w;
      } else if constexpr (W == 2) {
        const uint2 q = *reinterpret_cast<const uint2*>(p + r);
        v[r] = q.x; v[r + 1] = q.y;
      } else {
        v[r] = p[r];
      }
    }
  }
}

// 1/x for a normal x, within an ulp, with no branch: the approximate
// reciprocal and one Newton step.  For factors only; every quotient that
// must be the forward's bits is a division.
__device__ __forceinline__ float reciprocal(float x) {
  const float r = __fdividef(1.f, x);
  return fmaf(fmaf(-x, r, 1.f), r, r);
}

template <typename T, int G>
__global__ void __launch_bounds__(THREADS) moe_router_bwd_kernel(
    const T* __restrict__ logits, const float* __restrict__ stats, const float* __restrict__ w,
    const int* __restrict__ idx, const float* __restrict__ dw, T* __restrict__ dlogits,
    float* __restrict__ zs, int n_rows, int E, int k, int vec) {
  constexpr int ROUNDS = (MAX_K + G - 1) / G;   // rounds a lane owns, at most
  const int sub = threadIdx.x & (G - 1);
  const long long mine = static_cast<long long>(blockIdx.x) * (THREADS / G) + threadIdx.x / G;
  // Past the last row a group repeats the last row and stores nothing: the
  // shuffles below take the whole warp.
  const bool live = mine < n_rows;
  const long long row = live ? mine : n_rows - 1;
  const T* x = logits + row * E;
  const long long o = row * k;
  // Every independent load goes out first, the dependent one after a
  // branch (the switch on vec), which the compiler does not move it across.
  const float m = stats[2 * row], s = stats[2 * row + 1];

  // this lane's rounds r = i*G + sub (the last round's again past k): the
  // selected expert and its weight's gradient
  int my_i[ROUNDS];
  float my_g[ROUNDS];
#pragma unroll
  for (int i = 0; i < ROUNDS; ++i) {
    const long long r = o + min(i * G + sub, k - 1);
    my_i[i] = idx[r];
    my_g[i] = dw[r];
  }
  // this lane's experts e = j*G + sub: their logits
  float q[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int e = j * G + sub;
    q[j] = e < E ? to_f32(x[e]) : -INFINITY;
  }
  // the row's k (index, weight, weight gradient), every lane all of them
  unsigned ii[MAX_K] = {}, ww[MAX_K] = {}, gg[MAX_K] = {};
  const unsigned* iu = reinterpret_cast<const unsigned*>(idx) + o;
  const unsigned* wu = reinterpret_cast<const unsigned*>(w) + o;
  const unsigned* gu = reinterpret_cast<const unsigned*>(dw) + o;
  if (vec == 4) {
    load_row<4>(iu, k, ii); load_row<4>(wu, k, ww); load_row<4>(gu, k, gg);
  } else if (vec == 2) {
    load_row<2>(iu, k, ii); load_row<2>(wu, k, ww); load_row<2>(gu, k, gg);
  } else {
    load_row<1>(iu, k, ii); load_row<1>(wu, k, ww); load_row<1>(gu, k, gg);
  }
  // this lane's rounds' logits (the row is in L1 by now)
  float my_p[ROUNDS];
#pragma unroll
  for (int i = 0; i < ROUNDS; ++i) {
    my_i[i] = min(max(my_i[i], 0), E - 1);
    my_p[i] = to_f32(x[my_i[i]]);
  }

  // this lane's experts' probabilities, as factors (0 past E); its rounds'
  // probabilities, the forward's bits
  const float rs = reciprocal(s);
  float pe[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) pe[j] = expf(q[j] - m) * rs;
#pragma unroll
  for (int i = 0; i < ROUNDS; ++i) my_p[i] = prob(my_p[i], m, s);

  // every round's probability from the lane that owns the round: one
  // round of independent shuffles in the group, no reduction
  float pk[MAX_K];
#pragma unroll
  for (int r = 0; r < MAX_K; ++r) {
    pk[r] = __shfl_sync(FULL, my_p[r / G], r % G, G);
    if (r >= k) pk[r] = 0.f;
  }

  // Z in the forward's order (round 0 first), then sum_m dw_m w_m, each
  // dp_j and sum_j p_j dp_j, all in registers and round order
  float total = 0.f, c = 0.f;
#pragma unroll
  for (int r = 0; r < MAX_K; ++r) {
    if (r < k) {
      total += pk[r];
      c += __uint_as_float(gg[r]) * __uint_as_float(ww[r]);
    }
  }
  const float z = fmaxf(total, 1e-9f), rz = reciprocal(z);
  float pdp = 0.f;
#pragma unroll
  for (int r = 0; r < MAX_K; ++r) {
    if (r < k) pdp += pk[r] * ((__uint_as_float(gg[r]) - c) * rz);
  }

  // this lane's experts: p (0 - the sum) unless selected; the lane owning a
  // round writes its expert's p (dp - the sum)
  unsigned selected = 0;   // bit j: slot j is one of the k
#pragma unroll
  for (int r = 0; r < MAX_K; ++r) {
    const unsigned t = ii[r] - static_cast<unsigned>(sub);
    if (r < k && (t & (G - 1)) == 0) selected |= 1u << ((t / G) & 31);
  }
  T* out = dlogits + row * E;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const T v = from_f32<T>(pe[j] * (0.f - pdp));
    if (live && j * G + sub < E && !((selected >> j) & 1u)) out[j * G + sub] = v;
  }
#pragma unroll
  for (int i = 0; i < ROUNDS; ++i) {
    const T v = from_f32<T>(my_p[i] * ((my_g[i] - c) * rz - pdp));
    if (live && i * G + sub < k) out[my_i[i]] = v;
  }
  if (live && zs != nullptr && sub == 0) zs[row] = z;
}

template <typename T, int G>
void launch_g(const T* x, const float* st, const float* w, const int* idx, const float* dw, T* dx,
              float* zs, int n_rows, int E, int k, int vec, cudaStream_t stream) {
  constexpr int ROWS = THREADS / G;
  const dim3 grid((n_rows + ROWS - 1) / ROWS), block(THREADS);
  moe_router_bwd_kernel<T, G><<<grid, block, 0, stream>>>(x, st, w, idx, dw, dx, zs, n_rows, E,
                                                          k, vec);
}

template <typename T>
int launch(const void* logits, const float* st, const float* w, const int* idx, const float* dw,
           void* dlogits, float* zs, int n_rows, int E, int k, int vec, cudaStream_t stream) {
  const T* x = static_cast<const T*>(logits);
  T* dx = static_cast<T*>(dlogits);
  switch (lanes_per_row(E)) {
    case 4: launch_g<T, 4>(x, st, w, idx, dw, dx, zs, n_rows, E, k, vec, stream); break;
    case 8: launch_g<T, 8>(x, st, w, idx, dw, dx, zs, n_rows, E, k, vec, stream); break;
    case 16: launch_g<T, 16>(x, st, w, idx, dw, dx, zs, n_rows, E, k, vec, stream); break;
    default: launch_g<T, 32>(x, st, w, idx, dw, dx, zs, n_rows, E, k, vec, stream);
  }
  return cudaGetLastError();
}

// Words a load of a row's k indices, weights and weight gradients: 4 where
// k is a multiple of 4 and the three arrays are 16-byte aligned, 2 where
// the same holds for 2 and 8 bytes, else 1.
int vector_width(const void* a, const void* b, const void* c, int k) {
  const auto bits = reinterpret_cast<std::uintptr_t>(a) | reinterpret_cast<std::uintptr_t>(b) |
                    reinterpret_cast<std::uintptr_t>(c);
  return k % 4 == 0 && bits % 16 == 0 ? 4 : k % 2 == 0 && bits % 8 == 0 ? 2 : 1;
}

}  // namespace

// logits contiguous (T,E), dtype 0 = fp32, 1 = bf16; stats the forward's
// (T,2) fp32 row max and sum of exponentials (moe_router_fwd's stats); w,
// idx and dw contiguous (T,k): the forward's fp32 weights and int32
// indices and the fp32 gradient of the weights; dlogits (T,E) in the
// logits' dtype; z, if not null, receives each row's Z, (T,), for checks.
// Takes 1 <= E <= 256 and 1 <= k <= min(8, E); stats may not be null.
// Returns the launch's cudaError_t (0 on success); the launch does not
// synchronise.
extern "C" int moe_router_bwd(const void* logits, const void* stats, const void* w,
                              const void* idx, const void* dw, void* dlogits, void* z, int dtype,
                              int T, int E, int k, void* stream) {
  if (stats == nullptr || T <= 0 || E <= 0 || E > MAX_E || k <= 0 || k > MAX_K || k > E) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(stats);
  const float* wf = static_cast<const float*>(w);
  const int* ii = static_cast<const int*>(idx);
  const float* dwf = static_cast<const float*>(dw);
  float* zs = static_cast<float*>(z);
  const int vec = vector_width(w, idx, dw, k);
  switch (dtype) {
    case 0: return launch<float>(logits, st, wf, ii, dwf, dlogits, zs, T, E, k, vec, s);
    case 1: return launch<__nv_bfloat16>(logits, st, wf, ii, dwf, dlogits, zs, T, E, k, vec, s);
    default: return cudaErrorInvalidValue;
  }
}
