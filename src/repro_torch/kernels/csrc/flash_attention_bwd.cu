// Flash attention backward for Hopper (sm_90a), on the CUDA cores.
//
// The gradient of the forward in flash_attention.cu, which replaces the TPU
// kernel src/repro/kernels/flash_attention.py:77 (flash_attention_pallas).
// That kernel is forward-only: JAX trains through the jnp attention and
// takes its gradient by autodiff.  Same contract as the forward: q
// (B,Sq,H,hd), k/v (B,Sk,K,hd) and dO (B,Sq,H,hd) read through their
// (batch, sequence, head) strides with a contiguous last axis; GQA head h
// reads kv head h / (H/K); the mask from positions (causal, window,
// k_pos < 0), optional tanh softcap, scale 1/sqrt(hd); hd 64, 128 or 256;
// fp32 or bf16 in, fp32 arithmetic, gradients in the input dtype.  With
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
// bound it.  This first version runs them in fp32 on the CUDA cores (67
// TFLOP/s), not the tensor cores.
//
// What the design does about it (FlashAttention-2's split of the backward).
// - Two kernels, no float atomics, so every gradient is the same from run to
//   run.  The dq kernel owns a tile of query rows of one (b, h) and walks the
//   key tiles; it also writes D for its rows (rowsum(dO * O), O read once).
//   The dkdv kernel owns a tile of keys of one (b, kv head) and walks the
//   query tiles of each of its H/K query heads in turn, so the GQA sums of dK
//   and dV stay in its registers.  q.k and dO.v are computed by both, 4*hd
//   flops a pair more than the least work.
// - 256 threads a block as a 16 x 16 grid; each thread keeps a 4 x 4 (or
//   smaller) block of each product in registers.  Each tile's share of a
//   gradient is summed apart and then added to the running sum, so no fp32
//   chain is longer than a tile's rows or keys plus the tiles (a key's dK
//   and dV sum over (H/K) * Sq rows).  Tiles sit in shared memory
//   as fp32 rows padded by 4 floats; the q.k and dO.v products read them as
//   float4, the accumulations read P and dS as broadcasts and the other
//   operand as float4, so every load feeds 4 to 8 FMAs without bank
//   conflicts beyond the two wavefronts that 256 bytes take.
// - Tiles that no query of the block may see (causal future, outside the
//   window, empty slots) are skipped after one vote of the block; the mask
//   itself is applied element by element, as the forward does.
// - Tiles: 64 queries x 64 keys for hd 64, 32 x 32 for hd 128, 32 x 16 for
//   hd 256 (the key rows' gradients are held in registers).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int NT = 256;   // threads a block: a 16 x 16 grid (ty, tx)

template <int HD>
struct Cfg {
  static constexpr int BQ = HD == 64 ? 64 : 32;                      // query rows a tile
  static constexpr int BK = HD == 64 ? 64 : HD == 128 ? 32 : 16;     // keys a tile
  static constexpr int LD = HD + 4;                 // padded fp32 row of a Q/K/V/dO tile
  static constexpr int LP = BK % 32 == 0 ? BK + 16 : BK;   // padded row of a P/dS tile
  static constexpr int RQ = BQ / 16, RK = BK / 16;  // rows, keys a thread (strided by 16)
  static constexpr int RD = HD / 64;                // float4 dims a thread (strided by 64)
  static_assert(LP % 32 == 16, "P/dS rows of neighbouring ty must fall in other banks");
  static constexpr size_t SMEM_DQ =
      sizeof(float) * (2 * BQ * LD + 2 * BK * LD + BQ * LP + 2 * BQ) + sizeof(int) * (BQ + BK);
  static constexpr size_t SMEM_DKDV = SMEM_DQ + sizeof(float) * BQ * LP;
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
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ROWS x HD elements (row stride in elements) into a padded fp32 tile; rows
// at or past n_valid are zero.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long stride,
                                          int n_valid) {
  constexpr int LD = Cfg<HD>::LD;
  for (int c = threadIdx.x; c < ROWS * HD; c += NT) {
    const int r = c / HD, d = c % HD;
    dst[r * LD + d] = r < n_valid ? to_f(src[r * stride + d]) : 0.f;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc[i][j] = A[ty + 16i] . B[tx + 16j] over HD, both padded fp32 tiles.
template <int HD, int RA, int RB>
__device__ __forceinline__ void row_products(float (&acc)[RA][RB], const float* A,
                                             const float* Bt, int ty, int tx) {
  constexpr int LD = Cfg<HD>::LD;
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int j = 0; j < RB; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[RA], b[RB];
#pragma unroll
    for (int i = 0; i < RA; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < RB; ++j) b[j] = *reinterpret_cast<const float4*>(Bt + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = 0; j < RB; ++j) acc[i][j] = dot4(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ bool allowed(const Params& p, int qp, int kp) {
  return kp >= 0 && (!p.causal || qp - kp >= 0) && (!p.has_window || qp - kp < p.window);
}

// P and dS of the (query tile, key tile) pair from the products s = Q K^T and
// dp = dO V^T (rows ty + 16i, keys tx + 16j): into Ps (if given) and dSs.
template <int HD>
__device__ __forceinline__ void probs_and_grads(
    const Params& p, const float (&s)[Cfg<HD>::RQ][Cfg<HD>::RK],
    const float (&dp)[Cfg<HD>::RQ][Cfg<HD>::RK], const int* qpos_s, const int* kpos_s,
    const float* lse_s, const float* D_s, int nq, int nk, float* Ps, float* dSs, int ty,
    int tx) {
  using C = Cfg<HD>;
#pragma unroll
  for (int i = 0; i < C::RQ; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < C::RK; ++j) {
      const int c = tx + 16 * j;
      const bool ok = r < nq && c < nk && allowed(p, qpos_s[r], kpos_s[c]);
      float x = s[i][j] * p.scale, th = 0.f;
      if (p.softcap > 0.f) {
        th = tanhf(x / p.softcap);
        x = th * p.softcap;
      }
      const float pv = ok ? expf(x - lse_s[r]) : 0.f;
      float ds = pv * (dp[i][j] - D_s[r]);
      if (p.softcap > 0.f) ds *= 1.f - th * th;
      if (Ps != nullptr) Ps[r * C::LP + c] = pv;
      dSs[r * C::LP + c] = ds * p.scale;
    }
  }
}

// dq kernel: grid (H, B, query tiles), the heaviest causal tiles first.
template <typename T, int HD>
__global__ void __launch_bounds__(NT, 2) flash_attention_bwd_dq_kernel(const Params p) {
  using C = Cfg<HD>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LP = C::LP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;
  float* lse_s = dSs + BQ * LP;
  float* D_s = lse_s + BQ;
  int* qpos_s = reinterpret_cast<int*>(D_s + BQ);
  int* kpos_s = qpos_s + BQ;
  __shared__ int q_range[2];

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int nq = min(BQ, p.Sq - q0);
  const int kh = h / (p.H / p.K);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh + q0 * p.do_ss;
  const T* og = static_cast<const T*>(p.o) + ((long long)(b * p.Sq + q0) * p.H + h) * HD;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;
  const long long row0 = ((long long)b * p.H + h) * p.Sq + q0;   // (B,H,Sq) index of row 0

  if (threadIdx.x == 0) { q_range[0] = INT_MAX; q_range[1] = INT_MIN; }
  load_tile<T, HD, BQ>(Qs, qg, p.q_ss, nq);
  load_tile<T, HD, BQ>(dOs, dog, p.do_ss, nq);
  __syncthreads();
  if (threadIdx.x < BQ) {
    const int r = threadIdx.x;
    const int qp = r < nq ? p.q_pos[(long long)b * p.Sq + q0 + r] : 0;
    qpos_s[r] = qp;
    lse_s[r] = r < nq ? p.lse[row0 + r] : 0.f;
    if (r < nq) {
      atomicMin(&q_range[0], qp);
      atomicMax(&q_range[1], qp);
    }
  }
  // D = rowsum(dO * O) for this tile's rows, one warp a row; written for the dkdv kernel.
  for (int r = warp; r < BQ; r += NT / 32) {
    float acc = 0.f;
    if (r < nq)
      for (int d = lane; d < HD; d += 32) acc = fmaf(dOs[r * LD + d], to_f(og[(long long)r * p.H * HD + d]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      D_s[r] = acc;
      if (r < nq) p.delta[row0 + r] = acc;
    }
  }
  __syncthreads();
  const int qmin = q_range[0], qmax = q_range[1];

  float acc[C::RQ][4 * C::RD];
#pragma unroll
  for (int i = 0; i < C::RQ; ++i)
#pragma unroll
    for (int e = 0; e < 4 * C::RD; ++e) acc[i][e] = 0.f;

  const int nkb = (p.Sk + BK - 1) / BK;
  for (int kt = 0; kt < nkb; ++kt) {
    const int k0 = kt * BK, nk = min(BK, p.Sk - k0);
    bool seen = false;
    if (threadIdx.x < BK) {
      const int kp = threadIdx.x < nk ? p.k_pos[(long long)b * p.Sk + k0 + threadIdx.x] : -1;
      kpos_s[threadIdx.x] = kp;
      seen = kp >= 0 && (!p.causal || qmax - kp >= 0) && (!p.has_window || qmin - kp < p.window);
    }
    if (!__syncthreads_or(seen)) continue;   // no query of the tile sees a key of it
    load_tile<T, HD, BK>(Ks, kg + k0 * p.k_ss, p.k_ss, nk);
    load_tile<T, HD, BK>(Vs, vg + k0 * p.v_ss, p.v_ss, nk);
    __syncthreads();
    {
      float s[C::RQ][C::RK], dp[C::RQ][C::RK];
      row_products<HD, C::RQ, C::RK>(s, Qs, Ks, ty, tx);
      row_products<HD, C::RQ, C::RK>(dp, dOs, Vs, ty, tx);
      probs_and_grads<HD>(p, s, dp, qpos_s, kpos_s, lse_s, D_s, nq, nk, nullptr, dSs, ty, tx);
    }
    __syncthreads();
    // dQ[ty + 16i][4tx + 64j .. +3] += sum over the tile's keys of dS * K,
    // summed apart and then added: two short chains, not one over all keys
    float t[C::RQ][4 * C::RD];
#pragma unroll
    for (int i = 0; i < C::RQ; ++i)
#pragma unroll
      for (int e = 0; e < 4 * C::RD; ++e) t[i][e] = 0.f;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float4 kv[C::RD];
#pragma unroll
      for (int j = 0; j < C::RD; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + c * LD + 4 * tx + 64 * j);
#pragma unroll
      for (int i = 0; i < C::RQ; ++i) {
        const float g = dSs[(ty + 16 * i) * LP + c];
#pragma unroll
        for (int j = 0; j < C::RD; ++j) {
          t[i][4 * j] = fmaf(g, kv[j].x, t[i][4 * j]);
          t[i][4 * j + 1] = fmaf(g, kv[j].y, t[i][4 * j + 1]);
          t[i][4 * j + 2] = fmaf(g, kv[j].z, t[i][4 * j + 2]);
          t[i][4 * j + 3] = fmaf(g, kv[j].w, t[i][4 * j + 3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < C::RQ; ++i)
#pragma unroll
      for (int e = 0; e < 4 * C::RD; ++e) acc[i][e] += t[i][e];
    __syncthreads();
  }

  // dq is contiguous (B, Sq, H, hd).
#pragma unroll
  for (int i = 0; i < C::RQ; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    T* dst = static_cast<T*>(p.dq) + ((long long)(b * p.Sq + q0 + r) * p.H + h) * HD + 4 * tx;
#pragma unroll
    for (int j = 0; j < C::RD; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[64 * j + e] = from_f<T>(acc[i][4 * j + e]);
  }
}

// dkdv kernel: grid (K, B, key tiles).
template <typename T, int HD>
__global__ void __launch_bounds__(NT, 2) flash_attention_bwd_dkdv_kernel(const Params p) {
  using C = Cfg<HD>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LP = C::LP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;
  float* lse_s = dSs + BQ * LP;
  float* D_s = lse_s + BQ;
  int* qpos_s = reinterpret_cast<int*>(D_s + BQ);
  int* kpos_s = qpos_s + BQ;
  float* Ps = reinterpret_cast<float*>(kpos_s + BK);
  __shared__ int k_range[2];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BK, nk = min(BK, p.Sk - k0);
  const int G = p.H / p.K;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  if (threadIdx.x == 0) { k_range[0] = INT_MAX; k_range[1] = INT_MIN; }
  load_tile<T, HD, BK>(Ks, static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh + k0 * p.k_ss,
                       p.k_ss, nk);
  load_tile<T, HD, BK>(Vs, static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh + k0 * p.v_ss,
                       p.v_ss, nk);
  __syncthreads();
  if (threadIdx.x < BK) {
    const int kp = threadIdx.x < nk ? p.k_pos[(long long)b * p.Sk + k0 + threadIdx.x] : -1;
    kpos_s[threadIdx.x] = kp;
    if (kp >= 0) {
      atomicMin(&k_range[0], kp);
      atomicMax(&k_range[1], kp);
    }
  }
  __syncthreads();
  const int kmin = k_range[0], kmax = k_range[1];
  const bool any_key = kmin <= kmax;

  // dK, dV rows ty + 16i, dims 4tx + 64j .. +3
  float dk[C::RK][4 * C::RD], dv[C::RK][4 * C::RD];
#pragma unroll
  for (int i = 0; i < C::RK; ++i)
#pragma unroll
    for (int e = 0; e < 4 * C::RD; ++e) dk[i][e] = dv[i][e] = 0.f;

  const int nqb = (p.Sq + BQ - 1) / BQ;
  for (int qt = 0; qt < nqb; ++qt) {
    const int q0 = qt * BQ, nq = min(BQ, p.Sq - q0);
    bool seen = false;
    if (threadIdx.x < BQ) {
      const int qp = threadIdx.x < nq ? p.q_pos[(long long)b * p.Sq + q0 + threadIdx.x] : 0;
      qpos_s[threadIdx.x] = qp;
      seen = threadIdx.x < nq && any_key && (!p.causal || qp - kmin >= 0) &&
             (!p.has_window || qp - kmax < p.window);
    }
    if (!__syncthreads_or(seen)) continue;   // no query of the tile sees a key of this block
    for (int g = 0; g < G; ++g) {
      const int h = kh * G + g;
      const long long row0 = ((long long)b * p.H + h) * p.Sq + q0;
      load_tile<T, HD, BQ>(Qs, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss,
                           p.q_ss, nq);
      load_tile<T, HD, BQ>(dOs, static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh +
                           q0 * p.do_ss, p.do_ss, nq);
      if (threadIdx.x < BQ) {
        lse_s[threadIdx.x] = threadIdx.x < nq ? p.lse[row0 + threadIdx.x] : 0.f;
        D_s[threadIdx.x] = threadIdx.x < nq ? p.delta[row0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
      {
        float s[C::RQ][C::RK], dp[C::RQ][C::RK];
        row_products<HD, C::RQ, C::RK>(s, Qs, Ks, ty, tx);
        row_products<HD, C::RQ, C::RK>(dp, dOs, Vs, ty, tx);
        probs_and_grads<HD>(p, s, dp, qpos_s, kpos_s, lse_s, D_s, nq, nk, Ps, dSs, ty, tx);
      }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q over the tile's rows (rows past nq are 0),
      // summed apart and then added: with GQA a key's gradient sums over
      // (H/K) * Sq rows, too long for one fp32 chain
      float tk[C::RK][4 * C::RD], tv[C::RK][4 * C::RD];
#pragma unroll
      for (int i = 0; i < C::RK; ++i)
#pragma unroll
        for (int e = 0; e < 4 * C::RD; ++e) tk[i][e] = tv[i][e] = 0.f;
#pragma unroll 2
      for (int r = 0; r < nq; ++r) {
        float4 o4[C::RD], q4[C::RD];
#pragma unroll
        for (int j = 0; j < C::RD; ++j) {
          o4[j] = *reinterpret_cast<const float4*>(dOs + r * LD + 4 * tx + 64 * j);
          q4[j] = *reinterpret_cast<const float4*>(Qs + r * LD + 4 * tx + 64 * j);
        }
#pragma unroll
        for (int i = 0; i < C::RK; ++i) {
          const float pv = Ps[r * LP + ty + 16 * i], gv = dSs[r * LP + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < C::RD; ++j) {
            tv[i][4 * j] = fmaf(pv, o4[j].x, tv[i][4 * j]);
            tv[i][4 * j + 1] = fmaf(pv, o4[j].y, tv[i][4 * j + 1]);
            tv[i][4 * j + 2] = fmaf(pv, o4[j].z, tv[i][4 * j + 2]);
            tv[i][4 * j + 3] = fmaf(pv, o4[j].w, tv[i][4 * j + 3]);
            tk[i][4 * j] = fmaf(gv, q4[j].x, tk[i][4 * j]);
            tk[i][4 * j + 1] = fmaf(gv, q4[j].y, tk[i][4 * j + 1]);
            tk[i][4 * j + 2] = fmaf(gv, q4[j].z, tk[i][4 * j + 2]);
            tk[i][4 * j + 3] = fmaf(gv, q4[j].w, tk[i][4 * j + 3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < C::RK; ++i)
#pragma unroll
        for (int e = 0; e < 4 * C::RD; ++e) {
          dk[i][e] += tk[i][e];
          dv[i][e] += tv[i][e];
        }
      __syncthreads();
    }
  }

  // dk, dv are contiguous (B, Sk, K, hd); keys no query sees get 0.
#pragma unroll
  for (int i = 0; i < C::RK; ++i) {
    const int c = ty + 16 * i;
    if (c >= nk) continue;
    const long long off = ((long long)(b * p.Sk + k0 + c) * p.K + kh) * HD + 4 * tx;
    T* dkp = static_cast<T*>(p.dk) + off;
    T* dvp = static_cast<T*>(p.dv) + off;
#pragma unroll
    for (int j = 0; j < C::RD; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dkp[64 * j + e] = from_f<T>(dk[i][4 * j + e]);
        dvp[64 * j + e] = from_f<T>(dv[i][4 * j + e]);
      }
  }
}

template <typename T, int HD>
cudaError_t set_smem() {
  using C = Cfg<HD>;
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
  using C = Cfg<HD>;
  // Above 48 KB, dynamic shared memory needs an opt-in, once per instantiation.
  static const cudaError_t attr = set_smem<T, HD>();
  if (attr != cudaSuccess) return attr;
  const dim3 gq(p.H, B, (p.Sq + C::BQ - 1) / C::BQ), gk(p.K, B, (p.Sk + C::BK - 1) / C::BK);
  if (B > 65535 || gq.z > 65535 || gk.z > 65535) return cudaErrorInvalidValue;
  flash_attention_bwd_dq_kernel<T, HD><<<gq, NT, C::SMEM_DQ, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_attention_bwd_dkdv_kernel<T, HD><<<gk, NT, C::SMEM_DKDV, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const Params& p, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    case 256: return launch<T, 256>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int HD>
cudaError_t tiles(int* out) {
  using C = Cfg<HD>;
  const cudaError_t attr = set_smem<T, HD>();
  if (attr != cudaSuccess) return attr;
  out[0] = C::BQ;
  out[1] = C::BK;
  out[2] = static_cast<int>(C::SMEM_DQ);
  out[4] = static_cast<int>(C::SMEM_DKDV);
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 3, flash_attention_bwd_dq_kernel<T, HD>, NT, C::SMEM_DQ);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 5, flash_attention_bwd_dkdv_kernel<T, HD>, NT, C::SMEM_DKDV);
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_hd<float>(p, B, hd, s);
    case 1: return dispatch_hd<__nv_bfloat16>(p, B, hd, s);
    default: return cudaErrorInvalidValue;
  }
}

// One instantiation's query rows and keys a tile, then the dq kernel's and
// the dkdv kernel's dynamic shared memory and blocks an SM, as the card
// reports them: out[6] = {block_q, block_k, dq smem, dq blocks, dkdv smem,
// dkdv blocks}.  Returns a cudaError_t.
extern "C" int flash_attention_bwd_tiles(int dtype, int hd, int* out) {
  const bool f32 = dtype == 0;
  switch (hd) {
    case 64: return f32 ? tiles<float, 64>(out) : tiles<__nv_bfloat16, 64>(out);
    case 128: return f32 ? tiles<float, 128>(out) : tiles<__nv_bfloat16, 128>(out);
    case 256: return f32 ? tiles<float, 256>(out) : tiles<__nv_bfloat16, 256>(out);
    default: return cudaErrorInvalidValue;
  }
}
