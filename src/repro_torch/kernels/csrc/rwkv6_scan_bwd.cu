// Backward of the RWKV-6 WKV chunked scan for Hopper (sm_90a), in three kernels.
//
// The gradient of the TPU kernel repro/kernels/rwkv6_scan.py (rwkv6_scan_pallas;
// JAX itself differentiates its jnp scan, the kernel is forward-only), for the
// forward of csrc/rwkv6_scan.cu.  Within a chunk of L steps, S is the state
// entering it, dS' the gradient of the state leaving it, c and ce the
// inclusive and exclusive running sums of logw, cL the chunk's total,
//   A[t,s] = sum_n r_t k_s e^{ce_t - c_s} (s < t),  A[t,t] = sum_n r_t u k_t,
//   dA[t,s] = dy_t . v_s.
// Then, every exponent <= 0 as in the forward:
//   dS    = diag(e^{cL}) dS' + (r e^{ce})^T dy            (the state entering)
//   dv_s  = sum_{t>=s} A[t,s] dy_t + (k_s e^{cL - c_s}) dS'
//   dr_t  = sum_{s<t} k_s e^{ce_t - c_s} dA[t,s] + u k_t dA[t,t] + e^{ce_t} (S dy_t)
//   dk_s  = sum_{t>s} r_t e^{ce_t - c_s} dA[t,s] + u r_s dA[s,s] + e^{cL - c_s} (dS' v_s)
//   du    = sum over b and t of r_t k_t dA[t,t]
//   dlogw_j = sum_{t>j} rho_t - sum_{s>=j} kappa_s + sigma, per channel, with
//     rho_t = r_t (dr_t - u k_t dA[t,t]), kappa_s = k_s (dk_s - u r_s dA[s,s]),
//     sigma = e^{cL} sum_m S (.) dS' + sum_s k_s e^{cL - c_s} (dS' v_s).
// rho and kappa are formed from their own terms, never by subtracting the u
// term back, and dlogw is one running sum per channel from the last row:
// acc = sigma; acc -= kappa_j; dlogw_j = acc; acc += rho_j.  A ragged last
// chunk reads r = k = v = dy = 0 and logw = 0 past S, as the forward does.
// r/k/v/dy and dr/dk/dv in fp32 or bf16; logw, u, the states, dlogw, du and
// dstate fp32; all sums fp32.
//
// The split into passes is the forward's, run backwards.  Only dS links one
// chunk to the one before it, so
// - rwkv6_scan_bwd_states_kernel, grid (b, h, column group), carries MG = 32
//   columns of dS through the chunks from the last to the first in
//   registers (8 entries a thread) and writes dS' of every chunk to a
//   workspace (B, H, n_chunks, N, N), and dS entering chunk 0 to dstate:
//   the forward's states kernel with (r e^{ce}, dy) in place of
//   (k e^{cL - c}, v);
// - rwkv6_scan_bwd_grads_kernel, grid (b, h, chunk), takes S (the forward's
//   workspace, or the initial state for chunk 0) and dS' and writes dr, dk,
//   dv, dlogw and the chunk's partial of du;
// - rwkv6_scan_bwd_du_kernel sums the partials of du over b and the chunks
//   in a fixed order, so that two runs give the same bits (no atomics), and
//   compensated, so that the long sum loses no more than a chunked scan's.
//
// What bounds the grads kernel.  At rwkv6-1.6b's training shape (B=8 S=512
// H=32 N=64 L=32, fp32) it moves 437 MB (its part of the design's 610 MB,
// 0.13 ms at 3.35 TB/s) and its products 4.7 GFLOP (14 GFLOP of TF32 as
// 3xTF32: 0.03 ms at 495 TFLOP/s), against about 0.32 ms on an H100: neither
// bytes nor the tensor cores bound it, the instructions around the products
// on the CUDA cores do, at 2 blocks (16 warps) an SM.  Its SASS holds 10,096
// instructions in fp32 (240 HMMA, 205 MUFU.EX2, 749 LDS; bf16 9,824 and 184
// HMMA), where this kernel's first version, all on the CUDA cores, held
// 12,224 (no HMMA, 526 MUFU.EX2, 2,578 LDS) and took 1.10 ms: then every
// multiply-add read its operands from shared memory, and each
// e^{ce_t - c_s} was made three times (for A, dr and dk).  The bulk now is
// the splitting of fp32 operands into TF32 pairs (5 instructions a value,
// again in each warp that reads the fragment) and the accurate expf of the
// diagonal blocks (about 8 instructions each).
//
// What the design does about it.
// - Sub-chunks of LS = 16 rows (mma's m16).  A pair (t, s) in different
//   sub-chunks factors its decay at the boundary B = 16 between them,
//   e^{ce_t - c_s} = e^{ce_t - ce_B} e^{ce_B - c_s}, both exponents <= 0, so
//   neither factor overflows and neither underflows where the product would
//   not.  With F3 = e^{ce_t - ce_B} on rows t >= B and e^{ce_B - c_s} on
//   rows s < B, the off-diagonal blocks are plain products:
//   A[t,s] = ((r F3)(k F3)^T)[t,s], dr_t += F3_t (dA (k F3))_t,
//   dk_s += F3_s (dA^T (r F3))_s.  Only the two diagonal 16 x 16 blocks keep
//   an exponential a (t, s, n), made once and used for A, dr and dk
//   (diag_block: a warp holds one channel a lane, so dr and dk sum in
//   registers and A's sum over channels is one transposing butterfly of
//   shuffles for 32 pairs).  e^{cL - c}, e^{ce} and F3 are made once an
//   entry: 15,360 + 3 x 2,048 + 64 exponentials a chunk, against
//   3 x 31,744 + 3 x 2,048 + 64 before.
// - Every product runs on the tensor cores, mma.sync m16n8k8 on TF32 with
//   fp32 sums (attention_mma.cuh): dA = dy v^T, S dy, dS' v,
//   (k e^{cL-c}) dS', A^T dy and the three off-diagonal products.  fp32
//   operands as 3xTF32 with the small terms in accumulators of their own
//   (flash_attention_bwd.cu's precision scheme); bf16 r/k/v/dy are exact in
//   TF32 (8 of its 10 mantissa bits), so their small terms are zero and are
//   not multiplied: dA is one product, S dy, dS' v and A^T dy two, and only
//   the fp32 factors (S, dS', A, dA, the rescaled k and r) are split.
//   Operands come from shared memory as fragments (ldmatrix where a row of
//   the tile runs along k); accumulators stay in registers.  dA's diagonal,
//   which du and the u terms read, is an fp32 dot product of its own.
// - Every tile is copied in by cp.async, all at once; 2 blocks an SM, with
//   tiles reused once their last reader is done (v and e^{cL - c} become
//   dk's and dr's diagonal-block parts; S and dS' the values a thread keeps
//   between its first and last products, and F3).
// Tiles have row stride N + 4 (A and dA 32 + 4): 16-byte rows, so every
// ldmatrix of a warp hits 32 distinct banks.  Head size 64 and chunks up to
// 32, the forward's limits; a chunk shorter than 32 runs as 32 rows whose
// last ones are 0 (logw 0).  The states kernel's (r e^{ce})^T dy stays on the
// CUDA cores: at 0.12 ms it is the smaller pass left.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_mma.cuh"

namespace {

constexpr int LMAX = 32;    // longest chunk taken
constexpr int N = 64;       // head size

// states kernel: G column groups of MG columns; a thread owns RS rows of one
// column, rows RS*rg .. RS*rg + RS-1, so that its reads of r' are float4.
constexpr int G = 2;
constexpr int MG = N / G;
constexpr int NT1 = 256;
constexpr int RS = N * MG / NT1;
// grads kernel: 8 warps; tiles of LMAX rows.
constexpr int NT2 = 256;
constexpr int LS = 16;            // rows of a sub-chunk
constexpr int LDT = N + 4;        // row stride of a tile of N columns
constexpr int LDA = LMAX + 4;     // of A and dA
constexpr int TILE = LMAX * LDT;
constexpr int KEEP = 24;          // values a thread keeps from its first products to its last
static_assert(LMAX == 2 * LS, "one sub-chunk boundary a chunk");

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four consecutive bf16 elements from 8 aligned bytes, widened.
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

__device__ __forceinline__ void store2(float* dst, float x0, float x1) {
  *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
}

__host__ __device__ constexpr size_t states_smem(int L) {
  // r then r'; logw then cum; cum_excl; this group's columns of dy; cum at the last row
  return sizeof(float) * (3 * L * N + L * MG + N);
}

__host__ __device__ constexpr size_t grads_smem() {
  // r, k, v (later dk's diagonal-block part), dy, logw (later c), ce and
  // e^{cL - c} (later dr's diagonal-block part), TILE each; S and dS' (N x LDT
  // each; later the values kept between the products, then F3); A and dA
  // (LMAX x LDA each); u, cL, the rows of S (.) dS', sigma's partials (2 x N),
  // du's (4 x N) and dA's diagonal
  return sizeof(float) * (7 * TILE + 2 * N * LDT + 2 * LMAX * LDA + 9 * N + LMAX);
}
static_assert(states_smem(LMAX) <= 48 * 1024, "the states kernel takes no opt-in");
static_assert(grads_smem() <= 113 * 1024, "two grads blocks an SM");
static_assert(NT2 * KEEP + TILE <= 2 * N * LDT, "the kept values and F3 fit where S and dS' were");
static_assert(4 * LMAX * N / 2 <= 2 * TILE, "bf16 rows are staged in es and fl");
static_assert((4 * (N + LMAX)) % (NT2 - N) == 0, "whole warps run the row sums");

struct Params {
  const void* r; const void* k; const void* v; const void* dy;
  const float* logw; const float* u; const float* s0;
  const float* ws;      // the forward's: state entering chunks 1 .. nc-1 (B, H, nc-1, N, N)
  const float* ds_out;  // gradient of the final state (B, H, N, N), or null for zeros
  float* dws;           // gradient of the state leaving each chunk (B, H, nc, N, N)
  float* dstate;        // gradient of the initial state (B, H, N, N)
  void* dr; void* dk; void* dv;
  float* dlogw;
  float* du_part;       // each (b, chunk)'s partial of du: (B, nc, H, N)
  float* du;            // (H, N)
  int B, S, H, L, nc;
};

// Column n's running sums over the chunk's L rows of c (row stride ld),
// summed in row order: c <- cum; e <- cum_excl; returns cum at the last row.
// The forward's, so that both see the same exponents.
__device__ __forceinline__ float running_sums(float* c, float* e, int ld, int n, int L) {
  float acc = 0.f;
  for (int t0 = 0; t0 < L; t0 += 8) {
    float w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = t0 + j < L ? c[(t0 + j) * ld + n] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (t0 + j < L) {
        acc += w[j];
        c[(t0 + j) * ld + n] = acc;
        e[(t0 + j) * ld + n] = acc - w[j];
      }
    }
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(NT1) rwkv6_scan_bwd_states_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int L = p.L;
  float* rs = smem;              // r, then r * exp(cum_excl); row stride N
  float* cs = rs + L * N;        // logw, then cum
  float* es = cs + L * N;        // cum_excl
  float* ys = es + L * N;        // this block's MG columns of dy
  float* ds = ys + L * MG;       // cum at the chunk's last row

  const int tid = threadIdx.x, m = tid % MG, rg = tid / MG;
  const int g = blockIdx.x % G, bh = blockIdx.x / G, h = bh % p.H, b = bh / p.H;
  const int col = g * MG + m;
  const long long row = (long long)p.H * N;
  const long long base = (long long)b * p.S * row + (long long)h * N;
  const T* rg_ = static_cast<const T*>(p.r);
  const T* yg = static_cast<const T*>(p.dy);

  float st[RS];                  // dS[RS*rg + j][col]
#pragma unroll
  for (int j = 0; j < RS; ++j)
    st[j] = p.ds_out ? p.ds_out[(long long)bh * N * N + (RS * rg + j) * N + col] : 0.f;

  for (int c = p.nc - 1; c >= 0; --c) {
    float* dst = p.dws + ((long long)bh * p.nc + c) * N * N;
#pragma unroll
    for (int j = 0; j < RS; ++j) dst[(RS * rg + j) * N + col] = st[j];
    const int c0 = c * L, Lc = min(L, p.S - c0);
    for (int i = tid; i < L * N; i += NT1) {
      const int t = i / N;
      const long long off = base + (long long)(c0 + t) * row + i % N;
      rs[i] = t < Lc ? to_f32(rg_[off]) : 0.f;
      cs[i] = t < Lc ? p.logw[off] : 0.f;
    }
    for (int i = tid; i < L * MG; i += NT1) {
      const int t = i / MG;
      ys[i] = t < Lc ? to_f32(yg[base + (long long)(c0 + t) * row + g * MG + i % MG]) : 0.f;
    }
    __syncthreads();
    if (tid < N) ds[tid] = running_sums(cs, es, N, tid, L);
    __syncthreads();
    for (int i = tid; i < L * N; i += NT1) rs[i] *= expf(es[i]);
    __syncthreads();

    float acc[RS];
#pragma unroll
    for (int j = 0; j < RS; ++j) acc[j] = 0.f;
    for (int t = 0; t < L; ++t) {
      const float yy = ys[t * MG + m];
#pragma unroll
      for (int q = 0; q < RS; q += 4) {
        const float4 rr = *reinterpret_cast<const float4*>(rs + t * N + RS * rg + q);
        acc[q] = fmaf(rr.x, yy, acc[q]);
        acc[q + 1] = fmaf(rr.y, yy, acc[q + 1]);
        acc[q + 2] = fmaf(rr.z, yy, acc[q + 2]);
        acc[q + 3] = fmaf(rr.w, yy, acc[q + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < RS; ++j) st[j] = expf(ds[RS * rg + j]) * st[j] + acc[j];
    __syncthreads();   // the next chunk's tiles overwrite these
  }
#pragma unroll
  for (int j = 0; j < RS; ++j) p.dstate[(long long)bh * N * N + (RS * rg + j) * N + col] = st[j];
}

// -- the grads kernel's products ----------------------------------------------------
// m16n8k8 on TF32, lane (g, t) = (lane / 4, lane % 4): A's fragment a0..a3 is
// rows g, g+8 at k = t, then at k = t+4; B's b0, b1 column g at k = t, t+4;
// the accumulator's c0..c3 rows g (columns 2t, 2t+1), then g+8.

// acc[j] = A B_j over KS k-steps of 8, for NB blocks B_j of 8 columns:
// 3xTF32 with the small terms summed in accumulators of their own and added
// at the end.  An operand exact in TF32 (XA; bit j of XB for B_j: values of
// bf16 inputs) is not split, and its zero small terms are not multiplied.
// fa(kk, a) gives A's fragment at k-step kk, fb(kk, j, b) B_j's.
template <int KS, int NB, bool XA, unsigned XB, typename FA, typename FB>
__device__ __forceinline__ void product(float (&acc)[NB][4], FA fa, FB fb) {
  float sm[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = sm[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    float a[4];
    fa(kk, a);
    uint32_t ab[4], as[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (XA) {
        ab[i] = __float_as_uint(a[i]);
        as[i] = 0u;
      } else {
        split_tf32(a[i], ab[i], as[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float bv[2];
      fb(kk, j, bv);
      const bool xb = (XB >> j) & 1u;   // known once j is unrolled
      uint32_t bb[2], bs[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (xb) {
          bb[i] = __float_as_uint(bv[i]);
          bs[i] = 0u;
        } else {
          split_tf32(bv[i], bb[i], bs[i]);
        }
      }
      if (!XA) mma_tf32(sm[j], as, bb);
      if (!xb) mma_tf32(sm[j], ab, bs);
      mma_tf32(acc[j], ab, bb);
    }
  }
#pragma unroll
  for (int j = 0; j < NB; ++j)
    if (!XA || !((XB >> j) & 1u))
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += sm[j][e];
}

// A's fragment from 16 rows of a tile whose rows run along k, by ldmatrix:
// at = tile + (row0 + (lane >> 3 & 1) * 8 + (lane & 7)) * ld + (lane >> 4) * 4 + k0.
__device__ __forceinline__ void frag_rows(float (&a)[4], const float* at) {
  uint32_t x[4];
  ldsm_x4(x, at);
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = __uint_as_float(x[i]);
}

// A's fragment from columns c0 .. c0+15 of a tile whose rows are k (A^T).
__device__ __forceinline__ void frag_cols(float (&a)[4], const float* tile, int ld, int k0,
                                          int c0, int g, int t) {
  a[0] = tile[(k0 + t) * ld + c0 + g];
  a[1] = tile[(k0 + t) * ld + c0 + g + 8];
  a[2] = tile[(k0 + t + 4) * ld + c0 + g];
  a[3] = tile[(k0 + t + 4) * ld + c0 + g + 8];
}

// Sum over the warp's lanes of v[i] for each i, lane i receiving the sum of
// v[i]: a butterfly that halves the values at each of its 5 steps (31
// shuffles for 32 sums), in a fixed order.  Step W: v[i] of a lane with bit
// W clear pairs with v[i] of the lane across, and the same for v[i + W].
template <int W>
__device__ __forceinline__ float transpose_sum(float (&v)[32], int lane) {
  const bool up = lane & W;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = up ? v[i] : v[i + W];
    const float keep = up ? v[i + W] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
  if constexpr (W > 1) return transpose_sum<W / 2>(v, lane);
  return v[0];
}

// The diagonal sub-block j (rows and columns LS*j .. LS*j + 15) for channel
// n, rows t of set Q: t = LS*j + 2i + ((i + Q) & 1), i < 8 (the two sets
// hold 60 pairs s < t each).  Each e^{ce_t - c_s} is made once and used for
// A, dr and dk.  dr of the set's rows goes to drd, dk's partial over them to
// dkv; the sums over the warp's 32 channels of A[t,s] (s <= t, 0 for s > t)
// come out 32 at a time, slot l = 8 * (s % 4) + i of batch s / 4 in lane l
// (kept); du's partial over the set's rows to du.
template <int Q>
__device__ __forceinline__ void diag_block(const float* rs, const float* ks, const float* cs,
                                           const float* es, const float* dAs, const float* dAd,
                                           float u_n, int j,
                                           int n, int lane, float* drd, float (&dkv)[LS],
                                           float (&kept)[4], float& du) {
  const int r0 = LS * j;
  float rr[8], ee[8], dr[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = r0 + 2 * i + ((i + Q) & 1);
    rr[i] = rs[t * LDT + n];
    ee[i] = es[t * LDT + n];
    dr[i] = 0.f;
  }
  du = 0.f;
#pragma unroll
  for (int bt = 0; bt < LS / 4; ++bt) {
    float v[32];
#pragma unroll
    for (int ss = 0; ss < 4; ++ss) {
      const int sl = 4 * bt + ss, s = r0 + sl;
      const float k_s = ks[s * LDT + n], c_s = cs[s * LDT + n];
      float dk = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int tl = 2 * i + ((i + Q) & 1);
        float a = 0.f;
        if (tl > sl) {
          const float e = expf(ee[i] - c_s);
          const float d = dAs[(r0 + tl) * LDA + s];
          const float ke = k_s * e;
          dr[i] = fmaf(d, ke, dr[i]);
          dk = fmaf(d, rr[i] * e, dk);
          a = rr[i] * ke;
        } else if (tl == sl) {
          a = rr[i] * u_n * k_s;
          du = fmaf(rr[i] * k_s, dAd[s], du);
        }
        v[8 * ss + i] = a;
      }
      dkv[sl] = dk;
    }
    kept[bt] = transpose_sum<16>(v, lane);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) drd[(r0 + 2 * i + ((i + Q) & 1)) * LDT + n] = dr[i];
}

template <typename T>
__global__ void __launch_bounds__(NT2, 2) rwkv6_scan_bwd_grads_kernel(const Params p) {
  constexpr bool X = sizeof(T) == 2;   // bf16 r/k/v/dy: exact in TF32
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;
  float* ks = rs + TILE;
  float* vs = ks + TILE;             // v, then dk's diagonal-block part
  float* ys = vs + TILE;             // dy
  float* cs = ys + TILE;             // logw, then c
  float* es = cs + TILE;             // ce
  float* fl = es + TILE;             // e^{cL - c}, then dr's diagonal-block part
  float* Ss = fl + TILE;             // S, N rows of LDT
  float* dSs = Ss + N * LDT;         // dS'
  float* keep = Ss;                  // then KEEP values a thread, lane-major
  float* f3 = Ss + NT2 * KEEP;       // and F3
  float* As = Ss + 2 * N * LDT;      // A, LMAX rows of LDA
  float* dAs = As + LMAX * LDA;      // dA
  float* us = dAs + LMAX * LDA;
  float* cl = us + N;                // c at the last row
  float* ssd = cl + N;               // sum_m S[n][m] dS'[n][m]
  float* sg = ssd + N;               // sigma's partials, 2 x N
  float* dg = sg + 2 * N;            // du's partials, 4 x N
  float* dAd = dg + 4 * N;           // dA[t][t] in fp32
  float* drd = fl;
  float* dkd = vs;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int c = blockIdx.x % p.nc, bh = blockIdx.x / p.nc, h = bh % p.H, b = bh / p.H;
  const int c0 = c * p.L, Lc = min(p.L, p.S - c0);
  const long long row = (long long)p.H * N;
  const long long base = (long long)b * p.S * row + (long long)h * N + (long long)c0 * row;

  // -- the tiles; rows past the chunk are 0 ---------------------------------------
  // Every tile is copied by cp.async, all in flight at once; bf16 rows land in
  // es and fl (free until the running sums) and are widened after the wait.
  {
    const T* src[4] = {static_cast<const T*>(p.r), static_cast<const T*>(p.k),
                       static_cast<const T*>(p.v), static_cast<const T*>(p.dy)};
    constexpr int EPC = 16 / static_cast<int>(sizeof(T));   // elements a copy
    for (int i = tid; i < LMAX * N / EPC; i += NT2) {
      const int t = i / (N / EPC), n = EPC * (i % (N / EPC));
      const bool in = t < Lc;
      const long long off = base + (long long)(in ? t : 0) * row + n;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        void* dst = X ? static_cast<void*>(reinterpret_cast<T*>(es) + (q * LMAX + t) * N + n)
                      : static_cast<void*>(rs + q * TILE + t * LDT + n);
        cp_async16(dst, src[q] + off, in ? 16 : 0);
      }
    }
    for (int i = tid; i < LMAX * N / 4; i += NT2) {
      const int t = i / (N / 4), n = 4 * (i % (N / 4));
      const bool in = t < Lc;
      cp_async16(cs + t * LDT + n, p.logw + base + (long long)(in ? t : 0) * row + n, in ? 16 : 0);
    }
    const float* s_in = c == 0 ? p.s0 + (long long)bh * N * N
                               : p.ws + ((long long)bh * (p.nc - 1) + c - 1) * N * N;
    const float* ds_in = p.dws + ((long long)bh * p.nc + c) * N * N;
    for (int i = tid; i < N * N / 4; i += NT2) {
      const int r = i / (N / 4), m = 4 * (i % (N / 4));
      cp_async16(Ss + r * LDT + m, s_in + r * N + m, 16);
      cp_async16(dSs + r * LDT + m, ds_in + r * N + m, 16);
    }
    cp_async_commit();
    if (tid < N) us[tid] = p.u[h * N + tid];
    cp_async_wait0();
    __syncthreads();
    if constexpr (X) {
      for (int i = tid; i < 4 * LMAX * N / 4; i += NT2) {
        const int q = i / (LMAX * N / 4), t = i / (N / 4) % LMAX, n = 4 * (i % (N / 4));
        *reinterpret_cast<float4*>(rs + q * TILE + t * LDT + n) =
            load4(reinterpret_cast<const T*>(es) + (q * LMAX + t) * N + n);
      }
      __syncthreads();
    }
  }
  if (tid < N) {
    cl[tid] = running_sums(cs, es, LDT, tid, LMAX);
  } else {
    // the other warps meanwhile: sum_m S (.) dS' of rows 0 .. N-1, then dA's
    // diagonal dy_t . v_t in fp32 (du and the u terms read it), four threads
    // a row in a fixed order
    for (int task = tid - N; task < 4 * (N + LMAX); task += NT2 - N) {
      const int nr = task >> 2, part = task & 3;
      const float* x = nr < N ? Ss + nr * LDT : ys + (nr - N) * LDT;
      const float* y = nr < N ? dSs + nr * LDT : vs + (nr - N) * LDT;
      float a = 0.f;
#pragma unroll
      for (int m = 0; m < N / 4; ++m) a = fmaf(x[4 * m + part], y[4 * m + part], a);
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      if (part == 0) (nr < N ? ssd[nr] : dAd[nr - N]) = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < LMAX * N; i += NT2) {
    const int t = i / N, n = i % N;
    fl[t * LDT + n] = expf(cl[n] - cs[t * LDT + n]);
  }
  __syncthreads();

  // -- the products with S and dS', and dA ------------------------------------------
  // Warp (mt, cg) owns rows 16 mt .. 16 mt + 15 and columns 16 cg .. 16 cg + 15
  // of each N-column result (columns 8 cg .. 8 cg + 7 of dA).
  const int mt = warp & 1, cg = warp >> 1, R0 = LS * mt, C0 = 16 * cg;
  const int arow = ((lane >> 3) & 1) * 8 + (lane & 7), acol = (lane >> 4) * 4;
  float* mine = keep + warp * KEEP * 32 + lane;
  {
    float pr[2][4], pk[2][4], pv[2][4];
    {
      // dy [v S]^T: columns 8 cg .. of dA = dy v^T (block 0), then S dy (blocks 1, 2)
      const float* ya = ys + (R0 + arow) * LDT + acol;
      float py[3][4];
      product<8, 3, X, X ? 1u : 0u>(
          py, [&](int kk, float (&a)[4]) { frag_rows(a, ya + 8 * kk); },
          [&](int kk, int j, float (&bv)[2]) {
            const float* src = j == 0 ? vs + (8 * cg + g) * LDT + 8 * kk + tq
                                      : Ss + (C0 + 8 * (j - 1) + g) * LDT + 8 * kk + tq;
            bv[0] = src[0];
            bv[1] = src[4];
          });
      float* dst = dAs + (R0 + g) * LDA + 8 * cg + 2 * tq;
      dst[0] = py[0][0];
      dst[1] = py[0][1];
      dst[8 * LDA] = py[0][2];
      dst[8 * LDA + 1] = py[0][3];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pr[j][e] = py[j + 1][e];
    }
    const float* va = vs + (R0 + arow) * LDT + acol;
    product<8, 2, X, 0u>(pk, [&](int kk, float (&a)[4]) { frag_rows(a, va + 8 * kk); },
                            [&](int kk, int j, float (&bv)[2]) {   // v dS'^T
                              const float* src = dSs + (C0 + 8 * j + g) * LDT + 8 * kk + tq;
                              bv[0] = src[0];
                              bv[1] = src[4];
                            });
    const float* ka = ks + (R0 + arow) * LDT + acol;
    const float* la = fl + (R0 + arow) * LDT + acol;
    product<8, 2, false, 0u>(pv,
                                [&](int kk, float (&a)[4]) {   // (k e^{cL - c}) dS'
                                  float x[4], y[4];
                                  frag_rows(x, ka + 8 * kk);
                                  frag_rows(y, la + 8 * kk);
#pragma unroll
                                  for (int i = 0; i < 4; ++i) a[i] = x[i] * y[i];
                                },
                                [&](int kk, int j, float (&bv)[2]) {
                                  const float* src = dSs + (8 * kk + tq) * LDT + C0 + 8 * j + g;
                                  bv[0] = src[0];
                                  bv[1] = src[4 * LDT];
                                });
    __syncthreads();   // every read of S, dS' and v is done
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = R0 + g + 8 * (e >> 1), n = C0 + 8 * j + 2 * tq + (e & 1);
        mine[(4 * j + e) * 32] = expf(es[t * LDT + n]) * pr[j][e];      // e^{ce} (S dy)
        mine[(8 + 4 * j + e) * 32] = fl[t * LDT + n] * pk[j][e];        // e^{cL - c} (dS' v)
        mine[(16 + 4 * j + e) * 32] = pv[j][e];
      }
  }
  for (int i = tid; i < LMAX * N; i += NT2) {
    const int t = i / N, n = i % N;
    f3[t * LDT + n] = t >= LS ? expf(es[t * LDT + n] - es[LS * LDT + n])
                              : expf(es[LS * LDT + n] - cs[t * LDT + n]);
  }
  As[(tid >> 4) * LDA + LS + (tid & 15)] = 0.f;   // A above the diagonal blocks
  __syncthreads();

  // -- the diagonal blocks, and A's block below them ----------------------------------
  {
    const int j = warp >> 2, q = (warp >> 1) & 1, nh = warp & 1, n = 32 * nh + lane;
    float dkv[LS], kept[4], du;
    if (q)
      diag_block<1>(rs, ks, cs, es, dAs, dAd, us[n], j, n, lane, drd, dkv, kept, du);
    else
      diag_block<0>(rs, ks, cs, es, dAs, dAd, us[n], j, n, lane, drd, dkv, kept, du);
    dg[(2 * j + q) * N + n] = du;
    const int i = lane & 7, tl = LS * j + 2 * i + ((i + q) & 1);
    if (nh == 0) {
#pragma unroll
      for (int bt = 0; bt < 4; ++bt) As[tl * LDA + LS * j + 4 * bt + (lane >> 3)] = kept[bt];
    }
    if (q == 0) {
#pragma unroll
      for (int sl = 0; sl < LS; ++sl) dkd[(LS * j + sl) * LDT + n] = dkv[sl];
    }
    if (warp < 2) {   // A[t, s] for t >= LS > s: (r F3)(k F3)^T, columns 8 warp ..
      float ao[1][4];
      const float* ra = rs + (LS + arow) * LDT + acol;
      const float* fa = f3 + (LS + arow) * LDT + acol;
      product<8, 1, false, 0u>(ao,
                                  [&](int kk, float (&a)[4]) {
                                    float x[4], y[4];
                                    frag_rows(x, ra + 8 * kk);
                                    frag_rows(y, fa + 8 * kk);
#pragma unroll
                                    for (int e = 0; e < 4; ++e) a[e] = x[e] * y[e];
                                  },
                                  [&](int kk, int, float (&bv)[2]) {
                                    const int o = (8 * warp + g) * LDT + 8 * kk + tq;
                                    bv[0] = ks[o] * f3[o];
                                    bv[1] = ks[o + 4] * f3[o + 4];
                                  });
      float* dst = As + (LS + g) * LDA + 8 * warp + 2 * tq;
      dst[0] = ao[0][0];
      dst[1] = ao[0][1];
      dst[8 * LDA] = ao[0][2];
      dst[8 * LDA + 1] = ao[0][3];
    }
    __syncthreads();
    if (nh) {
#pragma unroll
      for (int bt = 0; bt < 4; ++bt) As[tl * LDA + LS * j + 4 * bt + (lane >> 3)] += kept[bt];
    }
    if (q) {
#pragma unroll
      for (int sl = 0; sl < LS; ++sl) dkd[(LS * j + sl) * LDT + n] += dkv[sl];
    }
  }
  __syncthreads();

  // -- A^T dy, the off-diagonal parts of dr and dk, and the gradients ------------------
  {
    float dv5[2][4], off[2][4];
    product<4, 2, false, X ? 3u : 0u>(dv5,
                            [&](int kk, float (&a)[4]) { frag_cols(a, As, LDA, 8 * kk, R0, g, tq); },
                            [&](int kk, int j, float (&bv)[2]) {
                              const float* src = ys + (8 * kk + tq) * LDT + C0 + 8 * j + g;
                              bv[0] = src[0];
                              bv[1] = src[4 * LDT];
                            });
    if (mt) {   // rows t >= LS: dA[t, :LS] (k F3)
      const float* da = dAs + (LS + arow) * LDA + acol;
      product<2, 2, false, 0u>(off, [&](int kk, float (&a)[4]) { frag_rows(a, da + 8 * kk); },
                                  [&](int kk, int j, float (&bv)[2]) {
                                    const int o = (8 * kk + tq) * LDT + C0 + 8 * j + g;
                                    bv[0] = ks[o] * f3[o];
                                    bv[1] = ks[o + 4 * LDT] * f3[o + 4 * LDT];
                                  });
    } else {    // rows s < LS: dA[LS:, s]^T (r F3)
      product<2, 2, false, 0u>(off,
                                  [&](int kk, float (&a)[4]) {
                                    frag_cols(a, dAs + LS * LDA, LDA, 8 * kk, 0, g, tq);
                                  },
                                  [&](int kk, int j, float (&bv)[2]) {
                                    const int o = (LS + 8 * kk + tq) * LDT + C0 + 8 * j + g;
                                    bv[0] = rs[o] * f3[o];
                                    bv[1] = rs[o + 4 * LDT] * f3[o + 4 * LDT];
                                  });
    }
    T* drg = static_cast<T*>(p.dr);
    T* dkg = static_cast<T*>(p.dk);
    T* dvg = static_cast<T*>(p.dv);
    float sig[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = R0 + g + 8 * hf;
        const float dAtt = dAd[t];
        float o[3][2];
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int e = 2 * hf + cc, n = C0 + 8 * j + 2 * tq + cc, x = t * LDT + n;
          const float part = f3[x] * off[j][e];
          const float ir = mt ? drd[x] + part : drd[x];   // dr's and dk's sums over pairs
          const float ik = mt ? dkd[x] : dkd[x] + part;
          const float xr = mine[(4 * j + e) * 32], xk = mine[(8 + 4 * j + e) * 32];
          const float r_t = rs[x], k_t = ks[x];
          o[0][cc] = ir + us[n] * k_t * dAtt + xr;
          o[1][cc] = ik + us[n] * r_t * dAtt + xk;
          o[2][cc] = dv5[j][e] + mine[(16 + 4 * j + e) * 32];
          drd[x] = r_t * (ir + xr);   // rho
          dkd[x] = k_t * (ik + xk);   // kappa
          sig[j][cc] = fmaf(k_t, xk, sig[j][cc]);
        }
        if (t < Lc) {
          const long long og = base + (long long)t * row + C0 + 8 * j + 2 * tq;
          store2(drg + og, o[0][0], o[0][1]);
          store2(dkg + og, o[1][0], o[1][1]);
          store2(dvg + og, o[2][0], o[2][1]);
        }
      }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        float v = sig[j][cc];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) sg[mt * N + C0 + 8 * j + 2 * tq + cc] = v;
      }
  }
  __syncthreads();

  // -- dlogw: one running sum a channel from the last row; du's partial ---------------
  if (tid < N) {
    float kap[LMAX], rho[LMAX];
#pragma unroll
    for (int j = 0; j < LMAX; ++j) {
      kap[j] = dkd[j * LDT + tid];
      rho[j] = drd[j * LDT + tid];
    }
    float acc = expf(cl[tid]) * ssd[tid];
    acc += sg[tid];
    acc += sg[N + tid];
    const float du = ((dg[tid] + dg[N + tid]) + dg[2 * N + tid]) + dg[3 * N + tid];
#pragma unroll
    for (int j = LMAX - 1; j >= 0; --j) {
      acc -= kap[j];
      if (j < Lc) p.dlogw[base + (long long)j * row + tid] = acc;
      acc += rho[j];
    }
    p.du_part[(((long long)b * p.nc + c) * p.H + h) * N + tid] = du;
  }
}

// acc + err += x, the rounding error of the addition carried in err
// (Neumaier's compensated sum, in fp32).
__device__ __forceinline__ void add_compensated(float& acc, float& err, float x) {
  const float t = acc + x;
  err += fabsf(acc) >= fabsf(x) ? (acc - t) + x : (x - t) + acc;
  acc = t;
}

// du[h][n]: the B * nc partials (128 at the training shape, of both signs)
// summed in a fixed order, compensated: one plain fp32 chain left du 2.3x as
// far from float64 as the plain chunked scan's on a model's own inputs.
// DUQ threads a channel each take a contiguous quarter of the partials
// (b-major, then the chunks), then the first adds the quarters in order.
constexpr int DUQ = 4;
__global__ void __launch_bounds__(DUQ * N) rwkv6_scan_bwd_du_kernel(const Params p) {
  __shared__ float part[2][DUQ][N];
  const int h = blockIdx.x, n = threadIdx.x % N, q = threadIdx.x / N, m = p.B * p.nc;
  float acc = 0.f, err = 0.f;
  for (int i = q * m / DUQ; i < (q + 1) * m / DUQ; ++i)
    add_compensated(acc, err, p.du_part[((long long)i * p.H + h) * N + n]);
  part[0][q][n] = acc;
  part[1][q][n] = err;
  __syncthreads();
  if (q == 0) {
    acc = err = 0.f;
#pragma unroll
    for (int j = 0; j < DUQ; ++j) {
      add_compensated(acc, err, part[0][j][n]);
      err += part[1][j][n];
    }
    p.du[h * N + n] = acc + err;
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  rwkv6_scan_bwd_states_kernel<T><<<p.B * p.H * G, NT1, states_smem(p.L), stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(rwkv6_scan_bwd_grads_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(grads_smem()));
  if (err != cudaSuccess) return err;
  rwkv6_scan_bwd_grads_kernel<T><<<p.B * p.H * p.nc, NT2, grads_smem(), stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rwkv6_scan_bwd_du_kernel<<<p.H, DUQ * N, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t occupancy(int L, int* smem_bytes, int* blocks_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(rwkv6_scan_bwd_grads_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(grads_smem()));
  if (err != cudaSuccess) return err;
  smem_bytes[0] = static_cast<int>(states_smem(L));
  smem_bytes[1] = static_cast<int>(grads_smem());
  smem_bytes[2] = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, rwkv6_scan_bwd_states_kernel<T>, NT1, states_smem(L));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm + 1, rwkv6_scan_bwd_grads_kernel<T>, NT2, grads_smem());
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm + 2, rwkv6_scan_bwd_du_kernel, DUQ * N, 0);
}

}  // namespace

// dtype of r/k/v/dy and dr/dk/dv: 0 = float32, 1 = bfloat16.  Every tensor is
// contiguous and 16-byte aligned: r, k, v, logw, dy, dr, dk, dv, dlogw
// (B,S,H,N); u and du (H,N) fp32; state, ds_out and dstate (B,H,N,N) fp32,
// ds_out null for zeros; ws the forward's workspace (B,H,ceil(S/L)-1,N,N)
// fp32, unused when S <= L; dws (B,H,ceil(S/L),N,N) and du_part
// (B,ceil(S/L),H,N) fp32 scratch.  1 <= L <= 32; head_size is N = 64.
// Launches the states kernel, the grads kernel and the du kernel on the
// stream without synchronising; returns the first cudaError_t (0 on success).
extern "C" int rwkv6_scan_bwd(
    const void* r, const void* k, const void* v, const void* logw, const void* u,
    const void* state, const void* ws, const void* dy, const void* ds_out,
    void* dr, void* dk, void* dv, void* dlogw, void* du, void* dstate,
    void* dws, void* du_part,
    int dtype, int B, int S, int H, int head_size, int L, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || head_size != N || L <= 0 || L > LMAX)
    return cudaErrorInvalidValue;
  const void* vec[] = {r, k, v, logw, state, ws, dy, dr, dk, dv, dws};   // read or written by 16 B
  for (const void* q : vec)
    if (reinterpret_cast<uintptr_t>(q) % 16 != 0) return cudaErrorMisalignedAddress;
  Params p;
  p.r = r; p.k = k; p.v = v; p.dy = dy;
  p.logw = static_cast<const float*>(logw);
  p.u = static_cast<const float*>(u);
  p.s0 = static_cast<const float*>(state);
  p.ws = static_cast<const float*>(ws);
  p.ds_out = static_cast<const float*>(ds_out);
  p.dws = static_cast<float*>(dws);
  p.dstate = static_cast<float*>(dstate);
  p.dr = dr; p.dk = dk; p.dv = dv;
  p.dlogw = static_cast<float*>(dlogw);
  p.du_part = static_cast<float*>(du_part);
  p.du = static_cast<float*>(du);
  p.B = B; p.S = S; p.H = H; p.L = L; p.nc = (S + L - 1) / L;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(p, s);
    case 1: return launch<__nv_bfloat16>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a block and blocks an SM can hold, for the states
// kernel ([0]), the grads kernel ([1]) and the du kernel ([2]) at chunk L,
// as the card reports them.  Returns a cudaError_t.
extern "C" int rwkv6_scan_bwd_occupancy(int dtype, int L, int* smem_bytes, int* blocks_per_sm) {
  if (L <= 0 || L > LMAX) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return occupancy<float>(L, smem_bytes, blocks_per_sm);
    case 1: return occupancy<__nv_bfloat16>(L, smem_bytes, blocks_per_sm);
    default: return cudaErrorInvalidValue;
  }
}
