// Flash attention backward for Hopper (sm_90a), on the tensor cores.
//
// The gradient of the forward in flash_attention.cu, which replaces the TPU
// kernel src/repro/kernels/flash_attention.py:77 (flash_attention_pallas).
// That kernel is forward-only: JAX trains through the jnp attention and
// takes its gradient by autodiff.  Same contract as the forward: q
// (B,Sq,H,hd), k/v (B,Sk,K,hd) and dO (B,Sq,H,hd) read through their
// (batch, sequence, head) strides with a contiguous last axis; GQA head h
// reads kv head h / (H/K); the mask from positions (causal, window,
// k_pos < 0), optional tanh softcap, scale 1/sqrt(hd); hd 64, 80, 128 or 256;
// fp32 or bf16 in, fp32 sums, gradients in the input dtype.  With
// x = softcap(scale * q.k) and the forward's log-sum-exp L (fp32 (B,H,Sq),
// +inf for a row with every key masked):
//   P = exp(x - L) where the mask allows, else 0;  D = rowsum(dO * O);
//   dS = P * (dO.v - D) * scale * (1 - tanh^2) (the last factor only with a
//   softcap, recomputed from the raw scores);
//   dQ = dS K;  dK = sum over the H/K query heads of dS^T Q;  dV = the same
//   sum of P^T dO.
// A fully masked row has P = 0: its dQ is 0 and it adds nothing to dK, dV.
//
// What bounds it on this card.  Per allowed (query, key) pair the gradient
// needs 10*hd flops (q.k and dO.v again, and the three products), against
// one read of q, k, v, O, dO and L and one write of dq, dk, dv: operations
// bound it.  All five products run on the tensor cores (mma.sync), with the
// forward's schemes (attention_mma.cuh): fp32 as 3xTF32, 3 x the work over
// 495 TFLOP/s; bf16 with S = Q K^T and dP = dO V^T as one exact bf16
// product each and P, dS split into bf16 hi + lo against the exact bf16
// dO, Q and K.  Both kernels compute S and dP, 14*hd flops a pair in all.
// On an H100 they run at about 9x (fp32) and 21x (bf16) that bound.  The
// instructions around the products do not bound them: splitting every tile
// once in shared memory cut the dkdv kernel's instructions by 40% and its
// time by nothing, while more warps on the same keys cut its time by 40%,
// so latency within each streamed tile does.
//
// What the design does about it (FlashAttention-2's split of the backward).
// - Two kernels, no float atomics, so every gradient is the same from run to
//   run.  The dq kernel owns 64 query rows of one (b, h), 16 a warp, and
//   streams the key tiles through the forward's 2-stage cp.async ring and
//   tile skip (next_tile); it also writes D for its rows (O read once).  S,
//   dP and dS stay in the accumulator fragments and dS feeds dQ += dS K as
//   the forward's P feeds P V.  The dkdv kernel owns 64 keys of one (b, kv
//   head), 16 a warp, with K and V resident in shared memory, and streams
//   Q, dO, L and D of each query tile of each of its H/K query heads
//   through the same kind of ring, so the GQA sums of dK and dV stay in its
//   registers.  It computes the transposed products S^T = K Q^T and
//   dP^T = V dO^T, so P^T and dS^T leave the accumulator as the A operand of
//   dV += P^T dO and dK += dS^T Q without leaving registers (for TF32 in the
//   forward's permuted key order).
// - The dkdv grid is small (K * B * Sk/64 blocks: 192 at smollm's train
//   shape) and causal work is uneven: the first key block sees every query
//   tile.  So each 64-row query tile is two products of 32 rows, and each
//   has its own 4 warps: 8 warps a block, two on each 16 keys, whose sums
//   are added in a fixed order at the end.  Where a tile is one product
//   (fp32 hd 128, hd 256) a block has 4 warps.
// - Precision.  The tensor cores round each fp32 sum of an mma, so the
//   design keeps their chains short: each streamed product's share of a
//   gradient is summed apart and then added to the running sum (no chain
//   longer than 32 rows, where a key's dK and dV sum over (H/K) * Sq rows),
//   and S and dP keep their 3xTF32 small terms in accumulators of their own
//   (scores<..., SEP>), which cut the worst error of the checks against
//   the plain version on an H100 from 8.76e-6 to 3.69e-6 normwise (limit
//   1e-5).
// - hd 128 and 256: a warp's 16 rows of dQ (dK, dV) at 64 columns per
//   warp keep the accumulators at 64 (128) registers, so hd/64 warps share
//   16 rows and a block owns 32 (16) rows, each warp summing its own 64
//   columns of the gradients.  hd 80 is not a multiple of 64: one warp owns
//   its 16 rows and all 80 columns (10 accumulator n-tiles), as at hd 64,
//   and a block owns 64 rows.  At hd 256 each of the 4 computes S and dP
//   over its own 64 dims and they add the partial products through shared
//   memory in a fixed order (add_partials): fp32 5.83 -> 3.45 ms on an
//   H100 against each computing all of S and dP.  At hd 128 both compute
//   all of S and dP.
// - Occupancy.  The dkdv kernel's streamed tiles shrink with a row's bytes
//   (64 rows of up to 256 bytes, 32 of up to 512, 16 of 1 KB), which keeps
//   its shared memory near 100 KB (fp32 hd 80: 32 rows of 320 bytes, one
//   product a tile, 4 warps and 85 KB a block, 2 blocks an SM).  The dq
//   kernel streams one product's keys a
//   tile (32; 16 of 1 KB rows), which leaves room for three blocks an SM
//   where rows are 256 bytes or less (fp32 hd 64, bf16 hd 64 and 128):
//   its grid is large, so warps an SM, not the longest block, set its time.
// - Rows are padded by 16 bytes, so every fragment load of a warp hits 32
//   distinct banks; strides or pointers that are not 16-byte multiples take
//   a plain copy into the same tiles.  The mask is applied from positions
//   element by element; tiles that no row of the block may see (causal
//   future, outside the window, empty slots) are skipped after one vote.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "attention_mma.cuh"

namespace {

constexpr int STAGES = 2;        // the streamed ring
constexpr int NW = 4;            // warps a dq block, and warps a chunk in a dkdv block
constexpr int NT = 32 * NW;      // threads a dq block

template <typename T, int HD>
struct Cfg {
  // warps that share 16 rows, CW gradient columns each: 64 where hd is a
  // multiple of 64, else (hd 80) one warp with all hd
  static constexpr int DS = HD % 64 == 0 ? HD / 64 : 1;
  static constexpr int CW = HD / DS;
  static constexpr int ND = CW / 8;           // the warp's accumulator n-tiles of a gradient
  static constexpr int ROWS = 16 * NW / DS;   // rows a block owns: queries (dq), keys (dkdv)
  static constexpr int RB = static_cast<int>(sizeof(T)) * HD;   // bytes a row
  static constexpr int BS = RB <= 256 ? 64 : RB <= 512 ? 32 : 16;   // rows a streamed tile
  static constexpr int CH = BS < 32 ? BS : 32;                      // streamed rows a product
  // dkdv: each of the QS chunks of a streamed tile has its own NW warps
  static constexpr int QS = BS / CH;
  static constexpr int NTK = NT * QS;                                // threads a dkdv block
  static constexpr int EPC = 16 / static_cast<int>(sizeof(T));     // elements per 16 B
  static constexpr int LD = HD + EPC;                              // padded row stride
  // dq streams one product's keys a tile, which leaves room for three blocks
  // an SM at 256-byte rows and fewer registers a thread
  // hd 256: the 4 warps on the same rows share S and dP (add_partials), CH
  // floats a thread.  At hd 128 the buffer would cost the fp32 dq kernel its
  // second block an SM, and sharing between 2 warps gained nothing on an H100.
  static constexpr bool SHARE = DS == 4;
  static constexpr int KD = SHARE ? HD / DS : HD;   // dims of S and dP a warp sums
  static constexpr int XCH = SHARE ? CH : 0;
  static constexpr size_t SMEM_DQ = sizeof(T) * LD * (2 * ROWS + 2 * STAGES * CH) +
                                    sizeof(int) * STAGES * CH + sizeof(float) * ROWS +
                                    sizeof(float) * NT * XCH;
  static constexpr int MINB_DQ = 3 * (SMEM_DQ + 1024) <= 233472 ? 3 : 2;
  static constexpr size_t SMEM_DKDV = sizeof(T) * LD * (2 * ROWS + 2 * STAGES * BS) +
                                      (2 * sizeof(float) + sizeof(int)) * STAGES * BS +
                                      sizeof(float) * NTK * XCH;
};

struct Params {
  const void* q; const void* k; const void* v; const void* o; const void* dout;
  const float* lse;
  const int* q_pos; const int* k_pos;
  float* delta;          // (B,H,Sq): D, written by the dq kernel, read by the dkdv kernel
  void* dq; void* dk; void* dv;
  int Sq, Sk, H, K;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  int causal, has_window, window;
  float softcap, scale;
  int vec;   // every pointer and stride a multiple of 16 bytes: cp.async
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store2(float* dst, float x0, float x1) {
  *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
}

__device__ __forceinline__ bool allowed(const Params& p, int qp, int kp) {
  return kp >= 0 && (!p.causal || qp - kp >= 0) && (!p.has_window || qp - kp < p.window);
}

// One pair's P and dS from its raw score s = q.k and dp = dO.v, in place.
__device__ __forceinline__ void prob_grad(const Params& p, float& s, float& dp, bool ok,
                                          float lse, float D) {
  float x = s * p.scale, th = 0.f;
  if (p.softcap > 0.f) {
    th = tanhf(x / p.softcap);
    x = th * p.softcap;
  }
  const float pv = ok ? expf(x - lse) : 0.f;
  float ds = pv * (dp - D);
  if (p.softcap > 0.f) ds *= 1.f - th * th;
  s = pv;
  dp = ds * p.scale;
}

// Cfg::SHARE: the DS warps on the same 16 rows each computed S and dP over
// their own hd/DS dims; the partial products are added through shared
// memory (CH = 8 * NB floats a thread), in the same order in every warp,
// which then all hold the same S and dP.  Every thread of the block calls
// it: it holds a barrier.  rows: the warp has rows in range.
template <int DS, int NB>
__device__ __forceinline__ void add_partials(float (&s)[NB][4], float (&dp)[NB][4], float* xbuf,
                                             int warp, int cp, int lane, bool rows) {
  constexpr int SLOT = 2 * NB * 4 * 32;   // floats a warp, lane-major
  float* mine = xbuf + warp * SLOT + lane;
  if (rows) {
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mine[(n * 4 + e) * 32] = s[n][e];
        mine[((NB + n) * 4 + e) * 32] = dp[n][e];
      }
  }
  __syncthreads();
  if (rows) {
    const float* first = xbuf + (warp - cp) * SLOT + lane;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float a = first[(n * 4 + e) * 32], c = first[((NB + n) * 4 + e) * 32];
#pragma unroll
        for (int w = 1; w < DS; ++w) {
          a += first[w * SLOT + (n * 4 + e) * 32];
          c += first[w * SLOT + ((NB + n) * 4 + e) * 32];
        }
        s[n][e] = a;
        dp[n][e] = c;
      }
  }
}

// This thread's query of tiles j .. j + threads/BS - 1 (INT_MIN past Sq).
template <int BS>
__device__ __forceinline__ int query_pos(const Params& p, const int* qpos, int j) {
  const int c = j * BS + threadIdx.x;
  return c < p.Sq ? __ldg(qpos + c) : INT_MIN;
}

// next_tile's mirror for the dkdv kernel: the first query tile at or after j
// in which some query may see a key in [kmin, kmax] (nqb if none).  qp is
// query_pos(j); the tile's positions go to qp_dst after the first barrier.
template <int BS, int NT_>
__device__ __forceinline__ int next_query_tile(const Params& p, const int* qpos, int j, int nqb,
                                               int qp, int kmin, int kmax, int* qp_dst) {
  constexpr int R = NT_ / BS;
  const int mine = threadIdx.x / BS;
  while (j < nqb) {
    const bool seen = qp != INT_MIN && (!p.causal || qp - kmin >= 0) &&
                      (!p.has_window || qp - kmax < p.window);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (__syncthreads_or(seen && mine == r)) {
        if (mine == r) qp_dst[threadIdx.x - r * BS] = qp;
        return j + r;
      }
    }
    j += R;
    qp = query_pos<BS>(p, qpos, j);
  }
  return nqb;
}

// dq kernel: grid (H, B, query blocks), the heaviest causal blocks first.
template <typename T, int HD>
__global__ void __launch_bounds__(NT, Cfg<T, HD>::MINB_DQ)
    flash_attention_bwd_dq_kernel(const Params p) {
  using C = Cfg<T, HD>;
  constexpr int ROWS = C::ROWS, BK = C::CH, LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + ROWS * LD;
  T* Ks = dOs + ROWS * LD;                 // STAGES tiles of BK x LD
  T* Vs = Ks + STAGES * BK * LD;
  int* kp_s = reinterpret_cast<int*>(Vs + STAGES * BK * LD);
  float* D_s = reinterpret_cast<float*>(kp_s + STAGES * BK);
  float* xbuf = D_s + ROWS;                // partial S and dP (Cfg::SHARE)
  __shared__ int q_range[2];

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * ROWS;
  const int nq = min(ROWS, p.Sq - q0);
  const int kh = h / (p.H / p.K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rw = warp / C::DS, cp = warp % C::DS;   // the warp's 16 rows, its CW columns of dQ
  const int kd0 = C::SHARE ? cp * C::KD : 0;          // and its first dim of S and dP
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;
  const int* qpos = p.q_pos + (long long)b * p.Sq + q0;
  const int* kpos = p.k_pos + (long long)b * p.Sk;
  const long long row0 = ((long long)b * p.H + h) * p.Sq + q0;   // (B,H,Sq) index of row 0
  const int nkb = (p.Sk + BK - 1) / BK;
  const bool vec = p.vec != 0;

  if (threadIdx.x == 0) { q_range[0] = INT_MAX; q_range[1] = INT_MIN; }
  load_tile<T, HD, ROWS, NT, LD>(
      Qs, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss, p.q_ss, nq, vec);
  load_tile<T, HD, ROWS, NT, LD>(
      dOs, static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh + q0 * p.do_ss, p.do_ss,
      nq, vec);
  cp_async_commit();
  cp_async_wait0();
  __syncthreads();
  if (threadIdx.x < nq) {
    atomicMin(&q_range[0], qpos[threadIdx.x]);
    atomicMax(&q_range[1], qpos[threadIdx.x]);
  }
  // D = rowsum(dO * O) for the block's rows, a warp a row; written for the dkdv kernel.
  const T* og = static_cast<const T*>(p.o) + ((long long)(b * p.Sq + q0) * p.H + h) * HD;
  for (int r = warp; r < ROWS; r += NW) {
    float acc = 0.f;
    if (r < nq)
      for (int d = lane; d < HD; d += 32)
        acc = fmaf(to_f(dOs[r * LD + d]), to_f(og[(long long)r * p.H * HD + d]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      D_s[r] = acc;
      if (r < nq) p.delta[row0 + r] = acc;
    }
  }
  __syncthreads();
  const int qmin = q_range[0], qmax = q_range[1];

  // This thread's two rows, g and g+8 of its warp's 16; a row past Sq gets
  // L = +inf, so P = 0.
  const int r0 = rw * 16 + g;
  int qp[2];
  float lse[2], Dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    qp[i] = r < nq ? qpos[r] : 0;
    lse[i] = r < nq ? p.lse[row0 + r] : INFINITY;
    Dr[i] = D_s[r];
  }
  const bool warp_rows = rw * 16 < nq;   // a warp past Sq only keeps the barriers
  // ldmatrix row addresses (attention_mma.cuh): A = Q or dO, B = K or V.
  const int mi = lane >> 3;
  const T* qa = Qs + (rw * 16 + (mi & 1) * 8 + (lane & 7)) * LD + (mi >> 1) * C::EPC;
  const T* doa = qa + ROWS * LD;
  const T* ka = Ks + ((mi >> 1) * 8 + (lane & 7)) * LD + (mi & 1) * C::EPC;
  const T* va = ka + STAGES * BK * LD;

  constexpr int ND = C::ND;
  float dq[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;

  int st = 0;
  bool full = false;   // next_tile's; the mask is applied to every tile
  int j = next_tile<BK, NT>(p, kpos, 0, nkb, key_pos<BK>(p, kpos, 0), qmin, qmax, kp_s, full);
  if (j < nkb) {
    load_tile<T, HD, BK, NT, LD>(Ks, kg + j * BK * p.k_ss, p.k_ss, p.Sk - j * BK, vec);
    load_tile<T, HD, BK, NT, LD>(Vs, vg + j * BK * p.v_ss, p.v_ss, p.Sk - j * BK, vec);
  }
  cp_async_commit();
  int kp_ahead = key_pos<BK>(p, kpos, j + 1);

  while (j < nkb) {
    // Issue the next visible tile into the other stage, then wait for this one.
    const int jn = next_tile<BK, NT>(p, kpos, j + 1, nkb, kp_ahead, qmin, qmax,
                                     kp_s + (st ^ 1) * BK, full);
    if (jn < nkb) {
      load_tile<T, HD, BK, NT, LD>(Ks + (st ^ 1) * BK * LD, kg + jn * BK * p.k_ss, p.k_ss,
                                   p.Sk - jn * BK, vec);
      load_tile<T, HD, BK, NT, LD>(Vs + (st ^ 1) * BK * LD, vg + jn * BK * p.v_ss, p.v_ss,
                                   p.Sk - jn * BK, vec);
    }
    cp_async_commit();
    kp_ahead = key_pos<BK>(p, kpos, jn + 1);   // read while this tile is multiplied
    cp_async_wait1();
    __syncthreads();

    const int off = st * BK * LD;
    float s[BK / 8][4], dp[BK / 8][4];
    if (warp_rows) {
      scores<C::KD, BK, LD, true>(s, qa + kd0, ka + off + kd0);
      scores<C::KD, BK, LD, true>(dp, doa + kd0, va + off + kd0);
    }
    if constexpr (C::SHARE) add_partials<C::DS, BK / 8>(s, dp, xbuf, warp, cp, lane, warp_rows);
    if (warp_rows) {
      // This tile's share of dQ, summed apart and then added.
      float tq[ND][4];
#pragma unroll
      for (int d = 0; d < ND; ++d) tq[d][0] = tq[d][1] = tq[d][2] = tq[d][3] = 0.f;
      {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          const int2 kp2 = *reinterpret_cast<const int2*>(kp_s + st * BK + n * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            prob_grad(p, s[n][e], dp[n][e], allowed(p, qp[i], (e & 1) ? kp2.y : kp2.x),
                      lse[i], Dr[i]);
          }
        }
        accumulate<C::CW, BK, LD>(tq, dp, Ks + off + cp * C::CW, lane);   // dQ += dS K
      }
#pragma unroll
      for (int d = 0; d < ND; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[d][e] += tq[d][e];
    }
    j = jn;
    st ^= 1;
  }

  // dq is contiguous (B, Sq, H, hd).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= nq) continue;
    T* dst = static_cast<T*>(p.dq) + ((long long)(b * p.Sq + q0 + r) * p.H + h) * HD +
             cp * C::CW + 2 * t;
#pragma unroll
    for (int d = 0; d < ND; ++d) store2(dst + d * 8, dq[d][2 * i], dq[d][2 * i + 1]);
  }
}

// dkdv kernel: grid (K, B, key blocks).
template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<T, HD>::NTK, 256 / Cfg<T, HD>::NTK)
    flash_attention_bwd_dkdv_kernel(const Params p) {
  using C = Cfg<T, HD>;
  constexpr int ROWS = C::ROWS, BQ = C::BS, CH = C::CH, LD = C::LD, NT = C::NTK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + ROWS * LD;
  T* Qs = Vs + ROWS * LD;                  // STAGES tiles of BQ x LD
  T* dOs = Qs + STAGES * BQ * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + STAGES * BQ * LD);   // STAGES x BQ
  float* D_s = lse_s + STAGES * BQ;
  int* qp_s = reinterpret_cast<int*>(D_s + STAGES * BQ);
  float* xbuf = reinterpret_cast<float*>(qp_s + STAGES * BQ);   // partial S, dP (Cfg::SHARE)
  __shared__ int k_range[2];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * ROWS, nk = min(ROWS, p.Sk - k0);
  const int G = p.H / p.K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int qc = warp / NW;                                   // its chunk of each tile
  const int rw = warp % NW / C::DS, cp = warp % NW % C::DS;   // its 16 keys, its CW columns
  const int kd0 = C::SHARE ? cp * C::KD : 0;                  // its first dim of S and dP
  const int* qpos = p.q_pos + (long long)b * p.Sq;
  const int* kpos = p.k_pos + (long long)b * p.Sk + k0;
  const int nqb = (p.Sq + BQ - 1) / BQ;
  const bool vec = p.vec != 0;

  if (threadIdx.x == 0) { k_range[0] = INT_MAX; k_range[1] = INT_MIN; }
  load_tile<T, HD, ROWS, NT, LD>(
      Ks, static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh + k0 * p.k_ss, p.k_ss, nk, vec);
  load_tile<T, HD, ROWS, NT, LD>(
      Vs, static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh + k0 * p.v_ss, p.v_ss, nk, vec);
  cp_async_commit();
  __syncthreads();
  if (threadIdx.x < nk) {
    const int kp = kpos[threadIdx.x];
    if (kp >= 0) {
      atomicMin(&k_range[0], kp);
      atomicMax(&k_range[1], kp);
    }
  }
  __syncthreads();
  const int kmin = k_range[0], kmax = k_range[1];

  // This thread's two keys, g and g+8 of its warp's 16 (-1 past Sk: masked).
  const int r0 = rw * 16 + g;
  const int kp[2] = {r0 < nk ? kpos[r0] : -1, r0 + 8 < nk ? kpos[r0 + 8] : -1};
  const bool warp_rows = rw * 16 < nk;
  // ldmatrix row addresses (attention_mma.cuh): A = K or V, B = Q or dO.
  const int mi = lane >> 3;
  const T* ka = Ks + (rw * 16 + (mi & 1) * 8 + (lane & 7)) * LD + (mi >> 1) * C::EPC;
  const T* va = ka + ROWS * LD;
  const T* qb = Qs + ((mi >> 1) * 8 + (lane & 7)) * LD + (mi & 1) * C::EPC;
  const T* dob = qb + STAGES * BQ * LD;

  // Q, dO, L and D of query tile qt of head kh * G + hq into stage s; L and D
  // of rows past Sq are 0, and those columns are masked.
  auto issue = [&](int s, int qt, int hq) {
    const int h = kh * G + hq, q0 = qt * BQ, nq = min(BQ, p.Sq - q0);
    load_tile<T, HD, BQ, NT, LD>(
        Qs + s * BQ * LD, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss,
        p.q_ss, nq, vec);
    load_tile<T, HD, BQ, NT, LD>(
        dOs + s * BQ * LD,
        static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh + q0 * p.do_ss, p.do_ss, nq,
        vec);
    if (threadIdx.x < BQ) {
      const int c = threadIdx.x;
      const long long row = ((long long)b * p.H + h) * p.Sq + q0 + (c < nq ? c : 0);
      cp_async4(lse_s + s * BQ + c, p.lse + row, c < nq ? 4 : 0);
      cp_async4(D_s + s * BQ + c, p.delta + row, c < nq ? 4 : 0);
    }
  };

  constexpr int ND = C::ND;
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

  int st = 0, hq = 0;
  int qt = kmin <= kmax ? next_query_tile<BQ, NT>(p, qpos, 0, nqb, query_pos<BQ>(p, qpos, 0), kmin,
                                              kmax, qp_s)
                        : nqb;   // no key of the block is in use
  if (qt < nqb) issue(0, qt, 0);
  cp_async_commit();
  int qp_ahead = query_pos<BQ>(p, qpos, qt + 1);

  while (qt < nqb) {
    __syncthreads();   // every warp is done with the other stage
    // The next item: the next head of this query tile, else the next visible tile.
    int qn = qt, hn = hq + 1;
    if (hn == G) {
      hn = 0;
      qn = next_query_tile<BQ, NT>(p, qpos, qt + 1, nqb, qp_ahead, kmin, kmax, qp_s + (st ^ 1) * BQ);
      qp_ahead = query_pos<BQ>(p, qpos, qn + 1);
    } else if (threadIdx.x < BQ) {
      qp_s[(st ^ 1) * BQ + threadIdx.x] = qp_s[st * BQ + threadIdx.x];
    }
    if (qn < nqb) issue(st ^ 1, qn, hn);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();

    const int c = qc * CH;
    const int off = (st * BQ + c) * LD;
    float s[CH / 8][4], dp[CH / 8][4];
    if (warp_rows) {
      scores<C::KD, CH, LD, true>(s, ka + kd0, qb + off + kd0);     // S^T = K Q^T
      scores<C::KD, CH, LD, true>(dp, va + kd0, dob + off + kd0);   // dP^T = V dO^T
    }
    if constexpr (C::SHARE) add_partials<C::DS, CH / 8>(s, dp, xbuf, warp, cp, lane, warp_rows);
    if (warp_rows) {
      const int nq = min(BQ, p.Sq - qt * BQ);
      const int* qps = qp_s + st * BQ;
      const float* ls = lse_s + st * BQ;
      const float* Ds = D_s + st * BQ;
      // This chunk's share of dK and dV, summed apart and then added.
      float tk[ND][4], tv[ND][4];
#pragma unroll
      for (int d = 0; d < ND; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) tk[d][e] = tv[d][e] = 0.f;
      {
#pragma unroll
        for (int n = 0; n < CH / 8; ++n) {
          const int col = c + n * 8 + 2 * t;
          const int2 qp2 = *reinterpret_cast<const int2*>(qps + col);
          const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
          const float2 d2 = *reinterpret_cast<const float2*>(Ds + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool odd = e & 1;
            const bool ok = col + odd < nq && allowed(p, odd ? qp2.y : qp2.x, kp[e >> 1]);
            prob_grad(p, s[n][e], dp[n][e], ok, odd ? l2.y : l2.x, odd ? d2.y : d2.x);
          }
        }
        accumulate<C::CW, CH, LD>(tv, s, dOs + off + cp * C::CW, lane);   // dV += P^T dO
        accumulate<C::CW, CH, LD>(tk, dp, Qs + off + cp * C::CW, lane);   // dK += dS^T Q
      }
#pragma unroll
      for (int d = 0; d < ND; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dk[d][e] += tk[d][e];
          dv[d][e] += tv[d][e];
        }
    }
    qt = qn;
    hq = hn;
    st ^= 1;
  }
  cp_async_wait0();   // K and V of a block that no query sees

  if constexpr (C::QS > 1) {
    // The chunks' sums, added in chunk order through the ring's memory.
    static_assert(C::QS == 2, "two chunks a tile");
    constexpr int SUMS = 2 * ND * 4;   // dK's and dV's floats a lane
    static_assert(2 * STAGES * BQ * LD * sizeof(T) >= NW * SUMS * 32 * sizeof(float),
                  "the ring holds a chunk's sums");
    float* red = reinterpret_cast<float*>(Qs) + (warp % NW) * SUMS * 32 + lane;
    __syncthreads();   // the ring is read no more
    if (qc == 1) {
#pragma unroll
      for (int d = 0; d < ND; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          red[(d * 4 + e) * 32] = dk[d][e];
          red[(ND * 4 + d * 4 + e) * 32] = dv[d][e];
        }
    }
    __syncthreads();
    if (qc == 1) return;
#pragma unroll
    for (int d = 0; d < ND; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[d][e] += red[(d * 4 + e) * 32];
        dv[d][e] += red[(ND * 4 + d * 4 + e) * 32];
      }
  }

  // dk, dv are contiguous (B, Sk, K, hd); keys no query sees get 0.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= nk) continue;
    const long long off = ((long long)(b * p.Sk + k0 + r) * p.K + kh) * HD + cp * C::CW + 2 * t;
    T* dkp = static_cast<T*>(p.dk) + off;
    T* dvp = static_cast<T*>(p.dv) + off;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      store2(dkp + d * 8, dk[d][2 * i], dk[d][2 * i + 1]);
      store2(dvp + d * 8, dv[d][2 * i], dv[d][2 * i + 1]);
    }
  }
}

template <typename T, int HD>
cudaError_t set_smem() {
  using C = Cfg<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<T, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(C::SMEM_DQ));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<T, HD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(C::SMEM_DKDV));
}

template <typename T, int HD>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<T, HD>;
  // Above 48 KB, dynamic shared memory needs an opt-in, once per instantiation.
  static const cudaError_t attr = set_smem<T, HD>();
  if (attr != cudaSuccess) return attr;
  const dim3 gq(p.H, B, (p.Sq + C::ROWS - 1) / C::ROWS), gk(p.K, B, (p.Sk + C::ROWS - 1) / C::ROWS);
  if (B > 65535 || gq.z > 65535 || gk.z > 65535) return cudaErrorInvalidValue;
  flash_attention_bwd_dq_kernel<T, HD><<<gq, NT, C::SMEM_DQ, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_attention_bwd_dkdv_kernel<T, HD><<<gk, C::NTK, C::SMEM_DKDV, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const Params& p, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<T, 64>(p, B, stream);
    case 80: return launch<T, 80>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    case 256: return launch<T, 256>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int HD>
cudaError_t tiles(int* out) {
  using C = Cfg<T, HD>;
  const cudaError_t attr = set_smem<T, HD>();
  if (attr != cudaSuccess) return attr;
  const int cfg[] = {C::ROWS, C::CH, NT, static_cast<int>(C::SMEM_DQ), 0,
                     C::BS, C::NTK, static_cast<int>(C::SMEM_DKDV), 0};
  for (int i = 0; i < 9; ++i) out[i] = cfg[i];
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 4, flash_attention_bwd_dq_kernel<T, HD>, NT, C::SMEM_DQ);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 8, flash_attention_bwd_dkdv_kernel<T, HD>, C::NTK, C::SMEM_DKDV);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last axis
// of q, k, v and dout must be contiguous; out is the forward's contiguous
// (B,Sq,H,hd) output, lse its fp32 (B,H,Sq) log-sum-exp; positions are
// contiguous int32 (B,S); delta is fp32 (B,H,Sq) scratch; dq, dk and dv are
// contiguous buffers of q's dtype shaped as q, k and v.  Launches the dq
// kernel, then the dkdv kernel, on the stream; returns the first launch's
// cudaError_t that is not 0 (0 on success); does not synchronise.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const void* lse, const void* q_pos, const void* k_pos,
    void* delta, void* dq, void* dk, void* dv,
    int dtype, int B, int Sq, int Sk, int H, int K, int hd,
    int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
    int v_sb, int v_ss, int v_sh, int do_sb, int do_ss, int do_sh,
    int causal, int has_window, int window, float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = out; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.q_pos = static_cast<const int*>(q_pos);
  p.k_pos = static_cast<const int*>(k_pos);
  p.delta = static_cast<float*>(delta);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.Sq = Sq; p.Sk = Sk; p.H = H; p.K = K;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.causal = causal; p.has_window = has_window; p.window = window;
  p.softcap = softcap;
  p.scale = 1.0f / sqrtf(static_cast<float>(hd));
  const long long es = dtype == 0 ? 4 : 2;
  bool vec = true;
  for (const void* ptr : {q, k, v, dout}) vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  for (long long s : {p.q_sb, p.q_ss, p.q_sh, p.k_sb, p.k_ss, p.k_sh, p.v_sb, p.v_ss, p.v_sh,
                      p.do_sb, p.do_ss, p.do_sh})
    vec = vec && (s * es) % 16 == 0;
  p.vec = vec;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_hd<float>(p, B, hd, s);
    case 1: return dispatch_hd<__nv_bfloat16>(p, B, hd, s);
    default: return cudaErrorInvalidValue;
  }
}

// One instantiation's tiles and each kernel's footprint, as the card reports
// them: out[9] = {rows a block owns (queries in the dq kernel, keys in the
// dkdv kernel); the dq kernel's keys a streamed tile, threads, dynamic
// shared memory and blocks an SM; the dkdv kernel's query rows a streamed
// tile, threads, dynamic shared memory and blocks an SM}.  Returns a
// cudaError_t.
extern "C" int flash_attention_bwd_tiles(int dtype, int hd, int* out) {
  const bool f32 = dtype == 0;
  switch (hd) {
    case 64: return f32 ? tiles<float, 64>(out) : tiles<__nv_bfloat16, 64>(out);
    case 80: return f32 ? tiles<float, 80>(out) : tiles<__nv_bfloat16, 80>(out);
    case 128: return f32 ? tiles<float, 128>(out) : tiles<__nv_bfloat16, 128>(out);
    case 256: return f32 ? tiles<float, 256>(out) : tiles<__nv_bfloat16, 256>(out);
    default: return cudaErrorInvalidValue;
  }
}
