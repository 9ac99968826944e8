// Flash attention forward for Hopper (sm_90a) on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:77
// (flash_attention_pallas, body _kernel).  Same contract: q (B,Sq,H,hd),
// k/v (B,Sk,K,hd) read through their strides, GQA head h reads kv head
// h / (H/K); the mask comes from position vectors (causal q_pos-k_pos >= 0,
// window q_pos-k_pos < window, k_pos < 0 is an empty ring slot); optional
// tanh softcap; scale 1/sqrt(hd); running max, sum and accumulator in fp32;
// output in q's dtype; hd 64, 80, 128 or 256; fp32 or bf16.  On request it also
// writes each row's log-sum-exp of its scaled (and capped) scores, fp32
// (B,H,Sq), +inf for a row with every key masked: the backward
// (flash_attention_bwd.cu) recomputes the probabilities from it.  The output
// is computed the same way with or without it.  One difference, on
// purpose: a row whose keys are all masked returns 0, as kernels/ref.py
// does, where the TPU kernel (masking with -1e30) returns the mean of the
// masked values.  Masked scores are -inf and a row's running max stays -inf
// until it sees an allowed key, so masked keys never add weight.
//
// What bounds it on this card.  Per (b, h) the work is 4*hd flops for every
// allowed (query, key) pair against one read of q, k, v and one write of the
// output: at the serving shapes (prompt 512, hd 64 or 256) operations bound
// it, not bytes.  The products run on the tensor cores, with fp32 accuracy:
// - fp32 inputs: the 3xTF32 split.  Each operand x is split into
//   big = tf32(x) and small = tf32(x - big), rounded as cvt.rna rounds (to
//   nearest, ties away); a product is big*big + big*small + small*big in
//   fp32 (mma.sync m16n8k8 tf32), which drops only small*small, about 2^-22
//   of it.  Three TF32 products: the bound is 3 * operations over
//   495 TFLOP/s.
// - bf16 inputs: S = Q K^T is one bf16 product with fp32 accumulation
//   (products of bf16 values are exact in fp32: the TPU kernel's function
//   after its astype(float32)); the fp32 probabilities P are split into bf16
//   hi + lo and O += P V is two products against the exact bf16 V (one bf16
//   P would round each weight by up to 2^-9).  1 + 2 products of the work's
//   half each: 1.5 * operations over 989 TFLOP/s.
// mma.sync reaches only part of that peak (wgmma reaches the rest), and each
// split costs integer and fp32 instructions beside every product, so in
// practice the instructions issued around the products bound it.
//
// What the design does about it (FlashAttention-2's split of the work).
// - A block owns 64 query rows of one (b, h) (128 for fp32 hd 256); each of
//   its 4 (8) warps owns 16 rows, and the scores, the running max and sum
//   and the output accumulator stay in the mma accumulator fragments, in
//   registers.  Row max and sum reduce over the 4 threads of a quad with
//   shuffles.
// - Q's and K's operands come by ldmatrix; P goes from the score
//   accumulator to the A operand of P V without leaving registers.  For
//   bf16 the m16n8k16 layouts line up and V comes by a transposing
//   ldmatrix.  For TF32 (m16n8k8) they do not, so the P V product runs over
//   the keys of each 8-key group in a permuted order (logical k = t <-> key
//   2t, k = t+4 <-> key 2t+1), and each thread reads V's rows in that order.
// - The split rounds with two integer operations (cvt.rna's inf/NaN guard
//   doubles that), and tiles that every query of the block sees in full
//   skip the mask.
// - K/V tiles (and the Q tile) come by 16-byte cp.async into a ring of 2
//   stages: tile j+1 is copied while tile j is multiplied.  Tiles are 64
//   keys for 128-byte rows (bf16 hd 64), 16 for fp32 hd 256, else 32: fp32
//   hd 64 then needs 52 KB and 128 registers, 4 blocks an SM; fp32 hd 256
//   needs 195 KB (128x260 Q + 2 x 2 x 16x260 K/V), one 8-warp block an SM.
//   hd 80 (hubert-xlarge: d_model 1280 over 16 heads) has rows of 320
//   bytes (fp32) and 160 (bf16): 32-key tiles, 63 KB (fp32) and 33 KB
//   (bf16) a block, and registers capped for 3 blocks an SM, as for
//   256-byte rows; its 10 k-steps of 8 (fp32) or 5 of 16 (bf16) and 10
//   output n-tiles (5 pairs for bf16's P V) need no padding to 128.
//   Rows are padded by 16 bytes, so every fragment load of a warp hits 32
//   distinct banks (at hd 80 row r of a tile starts at bank 20r mod 32 in
//   fp32, 12r mod 32 in bf16: 8 rows, 8 distinct groups of 4 banks).
//   Strides or pointers that are not 16-byte multiples take a plain copy
//   into the same tiles.
// - Key tiles that no query of the block may see (causal future, outside
//   the window, empty slots, past Sk) are skipped before their copy is
//   issued: one read of the key positions covers the next threads/keys
//   candidate tiles (2 to 16) and is made while the previous tile is
//   multiplied.
//   Ragged edges are zero-filled and masked in the kernel, nothing is
//   padded.  The heaviest causal query blocks (the last) start first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "attention_mma.cuh"

namespace {

constexpr int STAGES = 2;       // K/V ring

template <typename T, int HD>
struct Cfg {
  // fp32 hd 256 (1 KB rows): 64 query rows of Q alone take 65 KB, so only one
  // block fits an SM; there a block has 8 warps (128 rows) and 16-key tiles,
  // which doubles the SM's warps.  Elsewhere 4 warps, 64 rows.
  static constexpr bool WIDE = sizeof(T) * HD == 1024;
  static constexpr int NW = WIDE ? 8 : 4;   // warps, 16 query rows each
  static constexpr int BQ = 16 * NW;        // query rows per block
  static constexpr int NT = 32 * NW;        // threads
  // Keys per tile: 64 for 128-byte rows (bf16 hd 64), else 32, which keeps
  // fp32 hd 64 at 52 KB of shared memory and 128 registers: 4 blocks an SM;
  // 16 for the wide blocks, which fit 195 KB.
  static constexpr int BK = WIDE ? 16 : sizeof(T) * HD <= 128 ? 64 : 32;
  // Blocks an SM that ptxas must leave registers for (256-byte rows: 3, so up
  // to 168 registers a thread, which it uses for more loads in flight; hd 80
  // likewise, where shared memory alone allows 3 fp32 blocks).
  static constexpr int MINB = sizeof(T) * HD == 256 || HD == 80 ? 3 : 1;
  static constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // elements per 16 B
  static constexpr int LD = HD + EPC;                          // padded row stride
  static constexpr size_t SMEM =
      sizeof(T) * LD * (BQ + 2 * STAGES * BK) + sizeof(int) * STAGES * BK;
};

struct Params {
  const void* q; const void* k; const void* v;
  const int* q_pos; const int* k_pos;
  void* o;
  float* lse;   // (B,H,Sq) or null
  int Sq, Sk, H, K;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, has_window, window;
  float softcap, scale;
  int vec;   // every pointer and stride a multiple of 16 bytes: cp.async
};

// Scale, softcap and (with MASK) the mask from positions; mx gets the
// lane's share of each row's max.
template <bool MASK, int NB>
__device__ __forceinline__ void scale_mask(float (&s)[NB][4], float (&mx)[2], const Params& p,
                                           const int* kp, const int (&qp)[2], int t) {
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const int2 kp2 = MASK ? *reinterpret_cast<const int2*>(kp + n * 8 + 2 * t) : int2{0, 0};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = (e & 1) ? kp2.y : kp2.x, i = e >> 1;
      float x = s[n][e] * p.scale;
      if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
      if (MASK) {
        const bool ok = key >= 0 && (!p.causal || qp[i] - key >= 0) &&
                        (!p.has_window || qp[i] - key < p.window);
        x = ok ? x : -INFINITY;
      }
      s[n][e] = x;
      mx[i] = fmaxf(mx[i], x);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<T, HD>::NT, Cfg<T, HD>::MINB)
    flash_attention_fwd_kernel(const Params p) {
  using C = Cfg<T, HD>;
  constexpr int BQ = C::BQ, BK = C::BK, NT = C::NT, LD = C::LD, NB = BK / 8, ND = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BQ * LD;                 // STAGES tiles of BK x LD
  T* Vs = Ks + STAGES * BK * LD;
  int* kp_s = reinterpret_cast<int*>(Vs + STAGES * BK * LD);
  __shared__ int q_range[2];

  const int nqb = gridDim.z;
  const int q0 = (nqb - 1 - blockIdx.z) * BQ;   // the heaviest causal blocks first
  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / (p.H / p.K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;
  const int* qpos = p.q_pos + (long long)b * p.Sq + q0;
  const int* kpos = p.k_pos + (long long)b * p.Sk;
  const int nq = min(BQ, p.Sq - q0);     // valid query rows of this block
  const int nkb = (p.Sk + BK - 1) / BK;
  const bool vec = p.vec != 0;

  // The block's position range decides which key tiles it may skip.
  if (threadIdx.x == 0) { q_range[0] = INT_MAX; q_range[1] = INT_MIN; }
  __syncthreads();
  if (threadIdx.x < nq) {
    atomicMin(&q_range[0], qpos[threadIdx.x]);
    atomicMax(&q_range[1], qpos[threadIdx.x]);
  }
  __syncthreads();
  const int qmin = q_range[0], qmax = q_range[1];

  // This thread's two rows, g and g+8 of its warp's 16.
  const int r0 = warp * 16 + g;
  const int qp[2] = {r0 < nq ? qpos[r0] : 0, r0 + 8 < nq ? qpos[r0 + 8] : 0};
  const bool warp_rows = warp * 16 < nq;   // a warp past Sq only keeps the barriers
  // ldmatrix row addresses (see scores): tile mi = lane/8, row lane%8.
  const int mi = lane >> 3;
  const T* qa = Qs + (warp * 16 + (mi & 1) * 8 + (lane & 7)) * LD + (mi >> 1) * C::EPC;
  const T* ka = Ks + ((mi >> 1) * 8 + (lane & 7)) * LD + (mi & 1) * C::EPC;

  float o[ND][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int d = 0; d < ND; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;

  int st = 0;
  bool full = false, full_next = false;
  int j = next_tile<BK, NT>(p, kpos, 0, nkb, key_pos<BK>(p, kpos, 0), qmin, qmax, kp_s, full);
  if (j < nkb) {
    load_tile<T, HD, BQ, NT, LD>(Qs, qg, p.q_ss, nq, vec);
    load_tile<T, HD, BK, NT, LD>(Ks, kg + j * BK * p.k_ss, p.k_ss, p.Sk - j * BK, vec);
    load_tile<T, HD, BK, NT, LD>(Vs, vg + j * BK * p.v_ss, p.v_ss, p.Sk - j * BK, vec);
  }
  cp_async_commit();
  int kp_ahead = key_pos<BK>(p, kpos, j + 1);

  while (j < nkb) {
    // Issue the next visible tile into the other stage, then wait for this one.
    const int jn = next_tile<BK, NT>(p, kpos, j + 1, nkb, kp_ahead, qmin, qmax,
                                 kp_s + (st ^ 1) * BK, full_next);
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

    if (warp_rows) {
      float s[NB][4];
      scores<HD, BK, LD>(s, qa, ka + st * BK * LD);

      // The running max over the quad's 4 threads.
      float mx[2] = {-INFINITY, -INFINITY};
      if (full) {
        scale_mask<false>(s, mx, p, nullptr, qp, t);
      } else {
        scale_mask<true>(s, mx, p, kp_s + st * BK, qp, t);
      }
      float m_use[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        m_use[i] = m_new == -INFINITY ? 0.f : m_new;   // no key seen yet
        const float alpha = expf(m[i] - m_use[i]);      // 0 while m[i] is -inf
        m[i] = m_new;
        l[i] *= alpha;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          o[d][2 * i] *= alpha;
          o[d][2 * i + 1] *= alpha;
        }
      }
      // This thread's share of the row sums; the quad adds them at the end.
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = expf(s[n][e] - m_use[e >> 1]);      // masked: exp(-inf) = 0
          l[e >> 1] += s[n][e];
        }
      accumulate<HD, BK, LD>(o, s, Vs + st * BK * LD, lane);
    }
    j = jn;
    st ^= 1;
    full = full_next;
  }

  // Output is contiguous (B, Sq, H, hd).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = r0 + 8 * i;
    if (r >= nq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;   // 0 only for a fully masked row
    if (p.lse != nullptr && t == 0)
      p.lse[((long long)b * p.H + h) * p.Sq + q0 + r] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    T* og = static_cast<T*>(p.o) + ((long long)(b * p.Sq + q0 + r) * p.H + h) * HD + 2 * t;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const float x0 = l[i] > 0.f ? o[d][2 * i] * inv : 0.f;
      const float x1 = l[i] > 0.f ? o[d][2 * i + 1] * inv : 0.f;
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float2*>(og + d * 8) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(og + d * 8) = __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = Cfg<T, HD>::SMEM;
  // Above 48 KB, dynamic shared memory needs an opt-in, once per instantiation.
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  using C = Cfg<T, HD>;
  const dim3 grid(p.H, B, (p.Sq + C::BQ - 1) / C::BQ);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  flash_attention_fwd_kernel<T, HD><<<grid, C::NT, smem, stream>>>(p);
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
cudaError_t tiles(int* block_keys, int* smem_bytes, int* blocks_per_sm) {
  using C = Cfg<T, HD>;
  *block_keys = C::BK;
  *smem_bytes = static_cast<int>(C::SMEM);
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM));
  if (attr != cudaSuccess) return attr;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_attention_fwd_kernel<T, HD>, C::NT, C::SMEM);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last axis
// of q, k and v must be contiguous, positions are contiguous int32 (B,S) and
// the output is a contiguous (B,Sq,H,hd) buffer of q's dtype; lse is null or
// a contiguous fp32 (B,H,Sq) buffer.  Returns the launch's cudaError_t (0 on
// success); the launch does not synchronise.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v,
    const void* q_pos, const void* k_pos, void* out, void* lse,
    int dtype, int B, int Sq, int Sk, int H, int K, int hd,
    int q_sb, int q_ss, int q_sh,
    int k_sb, int k_ss, int k_sh,
    int v_sb, int v_ss, int v_sh,
    int causal, int has_window, int window, float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.q_pos = static_cast<const int*>(q_pos);
  p.k_pos = static_cast<const int*>(k_pos);
  p.o = out;
  p.lse = static_cast<float*>(lse);
  p.Sq = Sq; p.Sk = Sk; p.H = H; p.K = K;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.causal = causal; p.has_window = has_window; p.window = window;
  p.softcap = softcap;
  p.scale = 1.0f / sqrtf(static_cast<float>(hd));
  const long long es = dtype == 0 ? 4 : 2;
  bool vec = true;
  for (const void* ptr : {q, k, v}) vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  for (long long s : {p.q_sb, p.q_ss, p.q_sh, p.k_sb, p.k_ss, p.k_sh, p.v_sb, p.v_ss, p.v_sh})
    vec = vec && (s * es) % 16 == 0;
  p.vec = vec;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_hd<float>(p, B, hd, s);
    case 1: return dispatch_hd<__nv_bfloat16>(p, B, hd, s);
    default: return cudaErrorInvalidValue;
  }
}

// One instantiation's keys per tile, dynamic shared memory a block and
// blocks an SM can hold, as the card reports it.  Returns a cudaError_t.
extern "C" int flash_attention_tiles(int dtype, int hd, int* block_keys, int* smem_bytes,
                                     int* blocks_per_sm) {
  const bool f32 = dtype == 0;
  switch (hd) {
    case 64: return f32 ? tiles<float, 64>(block_keys, smem_bytes, blocks_per_sm)
                        : tiles<__nv_bfloat16, 64>(block_keys, smem_bytes, blocks_per_sm);
    case 80: return f32 ? tiles<float, 80>(block_keys, smem_bytes, blocks_per_sm)
                        : tiles<__nv_bfloat16, 80>(block_keys, smem_bytes, blocks_per_sm);
    case 128: return f32 ? tiles<float, 128>(block_keys, smem_bytes, blocks_per_sm)
                         : tiles<__nv_bfloat16, 128>(block_keys, smem_bytes, blocks_per_sm);
    case 256: return f32 ? tiles<float, 256>(block_keys, smem_bytes, blocks_per_sm)
                         : tiles<__nv_bfloat16, 256>(block_keys, smem_bytes, blocks_per_sm);
    default: return cudaErrorInvalidValue;
  }
}
