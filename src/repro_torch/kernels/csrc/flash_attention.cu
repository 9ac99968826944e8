// Flash attention forward for Hopper (sm_90a) on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:77
// (flash_attention_pallas, body _kernel).  Same contract: q (B,Sq,H,hd),
// k/v (B,Sk,K,hd) read through their strides, GQA head h reads kv head
// h / (H/K); the mask comes from position vectors (causal q_pos-k_pos >= 0,
// window q_pos-k_pos < window, k_pos < 0 is an empty ring slot); optional
// tanh softcap; scale 1/sqrt(hd); running max, sum and accumulator in fp32;
// output in q's dtype; hd 64, 128 or 256; fp32 or bf16.  On request it also
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
//   Rows are padded by 16 bytes, so every fragment load of a warp hits 32
//   distinct banks.  Strides or pointers that are not 16-byte multiples
//   take a plain copy into the same tiles.
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
  // to 168 registers a thread, which it uses for more loads in flight).
  static constexpr int MINB = sizeof(T) * HD == 256 ? 3 : 1;
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

// -- tensor-core and copy primitives ---------------------------------------------

// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero, to 10
// mantissa bits) as two integer operations: add half of the dropped ulp to
// the magnitude, clear the 13 dropped bits.  cvt.rna adds a guard for inf
// and NaN that finite inputs never need, and the split is the hot loop.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small + O(2^-22 x); x - big is exact in fp32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = rna_tf32(x);
  small = rna_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a*b in fp32 from the 3xTF32 splits of a and b (small terms first).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(d, as, bb);
  mma_tf32(d, ab, bs);
  mma_tf32(d, ab, bb);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (x0, x1) -> bf16 pairs hi and lo with x ~ hi + lo; x0 in the low half.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ldmatrix: four 8x8 tiles of 16-bit elements (8x4 of 32-bit ones), lane i
// giving the address of row i%8 of tile i/8; lane (g, t) receives row g,
// elements 2t and 2t+1 (32-bit element t) of each tile.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
// The same with each tile transposed: lane (g, t) receives column g, rows 2t and 2t+1.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// rows x HD elements from src (row stride in elements) into a padded tile;
// rows at or past n_valid are zero-filled (src_bytes 0: nothing is read).
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride,
                                          int n_valid, bool vec) {
  using C = Cfg<T, HD>;
  constexpr int CPR = HD / C::EPC;   // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * CPR; c += C::NT) {
    const int r = c / CPR, col = (c % CPR) * C::EPC;
    const bool in = r < n_valid;
    const T* s = src + (in ? r : 0) * stride + col;
    T* d = dst + r * C::LD + col;
    if (vec) {
      cp_async16(d, s, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < C::EPC; ++e) d[e] = in ? s[e] : zero<T>();
    }
  }
}

// -- the two products of one warp on one key tile ---------------------------------
// A warp's 16 rows: lane (g = lane/4, t = lane%4) holds rows g and g+8 of
// every m16n8 accumulator, columns 2t and 2t+1 of its 8.  Q's A operand and
// K's B operand come by ldmatrix: Q's four tiles are (rows 0-7 | 8-15) x
// (the first | second 16 bytes of a k-step), K's are (keys 8n..8n+7 |
// 8n+8..8n+15) x (first | second 16 bytes), so one ldmatrix feeds two
// n-tiles.  qa and ka are this lane's row addresses.

// s[n] = Q K^T for keys 8n..8n+7 of the tile (3xTF32, k-steps of 8 dims).
template <int HD, int BK>
__device__ __forceinline__ void scores(float (&s)[BK / 8][4], const float* qa, const float* ka) {
  constexpr int LD = Cfg<float, HD>::LD;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < HD / 8; ++kk) {
    uint32_t qv[4], ab[4], as[4];
    ldsm_x4(qv, qa + kk * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(qv[i]), ab[i], as[i]);
#pragma unroll
    for (int n = 0; n < BK / 8; n += 2) {
      uint32_t kv[4], bb[2][2], bs[2][2];
      ldsm_x4(kv, ka + n * 8 * LD + kk * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_tf32(__uint_as_float(kv[i]), bb[i >> 1][i & 1], bs[i >> 1][i & 1]);
      mma_3xtf32(s[n], ab, as, bb[0], bs[0]);
      mma_3xtf32(s[n + 1], ab, as, bb[1], bs[1]);
    }
  }
}

// The same for bf16 (one product, k-steps of 16 dims).
template <int HD, int BK>
__device__ __forceinline__ void scores(float (&s)[BK / 8][4], const __nv_bfloat16* qa,
                                       const __nv_bfloat16* ka) {
  constexpr int LD = Cfg<__nv_bfloat16, HD>::LD;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, qa + kk * 16);
#pragma unroll
    for (int n = 0; n < BK / 8; n += 2) {
      uint32_t kv[4];
      ldsm_x4(kv, ka + n * 8 * LD + kk * 16);
      const uint32_t b0[2] = {kv[0], kv[1]}, b1[2] = {kv[2], kv[3]};
      mma_bf16(s[n], a, b0);
      mma_bf16(s[n + 1], a, b1);
    }
  }
}

// o[d] += P V for output dims 8d..8d+7; p holds the tile's probabilities.
template <int HD, int BK>
__device__ __forceinline__ void accumulate(float (&o)[HD / 8][4], const float (&p)[BK / 8][4],
                                           const float* Vt, int lane) {
  constexpr int LD = Cfg<float, HD>::LD;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    // Logical k = t is key 8n+2t, k = t+4 is key 8n+2t+1: the accumulator's
    // (c0, c2, c1, c3) are the A operand's (a0, a1, a2, a3).
    uint32_t pb[4], ps[4];
    split_tf32(p[n][0], pb[0], ps[0]);
    split_tf32(p[n][2], pb[1], ps[1]);
    split_tf32(p[n][1], pb[2], ps[2]);
    split_tf32(p[n][3], pb[3], ps[3]);
    const float* v = Vt + (n * 8 + 2 * t) * LD + g;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      uint32_t bb[2], bs[2];
      split_tf32(v[d * 8], bb[0], bs[0]);
      split_tf32(v[LD + d * 8], bb[1], bs[1]);
      mma_3xtf32(o[d], pb, ps, bb, bs);
    }
  }
}

// For bf16, V's B operand comes by a transposing ldmatrix: tiles (keys
// 16j..16j+7 | 16j+8..16j+15) x (dims 8d..8d+7 | 8d+8..8d+15).
template <int HD, int BK>
__device__ __forceinline__ void accumulate(float (&o)[HD / 8][4], const float (&p)[BK / 8][4],
                                           const __nv_bfloat16* Vt, int lane) {
  constexpr int LD = Cfg<__nv_bfloat16, HD>::LD;
  const int mi = lane >> 3;
  const __nv_bfloat16* va = Vt + ((mi & 1) * 8 + (lane & 7)) * LD + (mi >> 1) * 8;
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    // Accumulators 2j and 2j+1 (keys 16j..16j+15) are m16n8k16's A operand.
    uint32_t hi[4], lo[4];
    split_bf16(p[2 * j][0], p[2 * j][1], hi[0], lo[0]);
    split_bf16(p[2 * j][2], p[2 * j][3], hi[1], lo[1]);
    split_bf16(p[2 * j + 1][0], p[2 * j + 1][1], hi[2], lo[2]);
    split_bf16(p[2 * j + 1][2], p[2 * j + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int d = 0; d < HD / 8; d += 2) {
      uint32_t vv[4];
      ldsm_x4_t(vv, va + j * 16 * LD + d * 8);
      const uint32_t b0[2] = {vv[0], vv[1]}, b1[2] = {vv[2], vv[3]};
      mma_bf16(o[d], lo, b0);
      mma_bf16(o[d + 1], lo, b1);
      mma_bf16(o[d], hi, b0);
      mma_bf16(o[d + 1], hi, b1);
    }
  }
}

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

// This thread's key of tiles j .. j + (threads/BK) - 1 (-1 past Sk).
template <int BK>
__device__ __forceinline__ int key_pos(const Params& p, const int* kpos, int j) {
  const int c = j * BK + threadIdx.x;
  return c < p.Sk ? __ldg(kpos + c) : -1;
}

// The first key tile at or after j that some query of the block may see
// (nkb if none).  kp is key_pos(j): one read covers NT/BK candidate tiles,
// and the caller reads the first one ahead of time.  full: every query of
// the block sees every key of the tile (no mask needed).  The tile's
// positions go to kp_dst after the first barrier, so the stage's last reader
// is done with it.
template <int BK, int NT>
__device__ __forceinline__ int next_tile(const Params& p, const int* kpos, int j, int nkb,
                                         int kp, int qmin, int qmax, int* kp_dst, bool& full) {
  constexpr int R = NT / BK;
  const int mine = threadIdx.x / BK;   // which of the R candidates this thread's key is in
  while (j < nkb) {
    const bool seen = kp >= 0 && (!p.causal || qmax - kp >= 0) &&
                      (!p.has_window || qmin - kp < p.window);
    const bool all = kp >= 0 && (!p.causal || qmin - kp >= 0) &&
                     (!p.has_window || qmax - kp < p.window);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (__syncthreads_or(seen && mine == r)) {
        full = __syncthreads_and(all || mine != r);
        if (mine == r) kp_dst[threadIdx.x - r * BK] = kp;
        return j + r;
      }
    }
    j += R;
    kp = key_pos<BK>(p, kpos, j);
  }
  return nkb;
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
    load_tile<T, HD, BQ>(Qs, qg, p.q_ss, nq, vec);
    load_tile<T, HD, BK>(Ks, kg + j * BK * p.k_ss, p.k_ss, p.Sk - j * BK, vec);
    load_tile<T, HD, BK>(Vs, vg + j * BK * p.v_ss, p.v_ss, p.Sk - j * BK, vec);
  }
  cp_async_commit();
  int kp_ahead = key_pos<BK>(p, kpos, j + 1);

  while (j < nkb) {
    // Issue the next visible tile into the other stage, then wait for this one.
    const int jn = next_tile<BK, NT>(p, kpos, j + 1, nkb, kp_ahead, qmin, qmax,
                                 kp_s + (st ^ 1) * BK, full_next);
    if (jn < nkb) {
      load_tile<T, HD, BK>(Ks + (st ^ 1) * BK * LD, kg + jn * BK * p.k_ss, p.k_ss,
                           p.Sk - jn * BK, vec);
      load_tile<T, HD, BK>(Vs + (st ^ 1) * BK * LD, vg + jn * BK * p.v_ss, p.v_ss,
                           p.Sk - jn * BK, vec);
    }
    cp_async_commit();
    kp_ahead = key_pos<BK>(p, kpos, jn + 1);   // read while this tile is multiplied
    cp_async_wait1();
    __syncthreads();

    if (warp_rows) {
      float s[NB][4];
      scores<HD, BK>(s, qa, ka + st * BK * LD);

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
      accumulate<HD, BK>(o, s, Vs + st * BK * LD, lane);
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
    case 128: return f32 ? tiles<float, 128>(block_keys, smem_bytes, blocks_per_sm)
                         : tiles<__nv_bfloat16, 128>(block_keys, smem_bytes, blocks_per_sm);
    case 256: return f32 ? tiles<float, 256>(block_keys, smem_bytes, blocks_per_sm)
                         : tiles<__nv_bfloat16, 256>(block_keys, smem_bytes, blocks_per_sm);
    default: return cudaErrorInvalidValue;
  }
}
