// Tensor-core and copy building blocks shared by the flash attention forward
// (flash_attention.cu) and its backward (flash_attention_bwd.cu), sm_90a.
//
// Products run on mma.sync with fp32 accumulation:
// - fp32 operands as 3xTF32: x = big + small, big = tf32(x) and small =
//   tf32(x - big), rounded as cvt.rna rounds; a product is small*big +
//   big*small + big*big (m16n8k8), which drops only small*small, about
//   2^-22 of it;
// - bf16 operands exactly (m16n8k16): products of bf16 values are exact in
//   fp32.  An fp32 left operand (probabilities, score gradients) is split
//   into bf16 hi + lo and multiplied twice.
// Tiles sit in shared memory as rows of HD elements padded to LD, so every
// fragment load of a warp hits 32 distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

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
// 4 bytes (src_bytes 0 writes a zero and reads nothing).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// ROWS x HD elements from src (row stride in elements) into a tile of row
// stride LD, by NT threads; rows at or past n_valid are zero-filled
// (src_bytes 0: nothing is read).  vec: src and stride are 16-byte
// multiples, so the copy is cp.async; else plain loads into the same tile.
template <typename T, int HD, int ROWS, int NT, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride,
                                          int n_valid, bool vec) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));   // elements per 16 B
  constexpr int CPR = HD / EPC;                            // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
    const int r = c / CPR, col = (c % CPR) * EPC;
    const bool in = r < n_valid;
    const T* s = src + (in ? r : 0) * stride + col;
    T* d = dst + r * LD + col;
    if (vec) {
      cp_async16(d, s, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < EPC; ++e) d[e] = in ? s[e] : zero<T>();
    }
  }
}

// -- the two products of one warp -----------------------------------------------
// A warp's 16 rows: lane (g = lane/4, t = lane%4) holds rows g and g+8 of
// every m16n8 accumulator, columns 2t and 2t+1 of its 8.  The A operand
// (16 rows) and the B operand (rows of the right-hand tile) come by
// ldmatrix: A's four tiles are (rows 0-7 | 8-15) x (the first | second 16
// bytes of a k-step), B's are (rows 8n..8n+7 | 8n+8..8n+15) x (first |
// second 16 bytes), so one ldmatrix feeds two n-tiles.  qa and ka are this
// lane's row addresses:
//   qa = A + (row0 + (mi & 1) * 8 + (lane & 7)) * LD + (mi >> 1) * EPC,
//   ka = B + ((mi >> 1) * 8 + (lane & 7)) * LD + (mi & 1) * EPC,  mi = lane / 8.

// s[n] = A B^T over HD for rows 8n..8n+7 of B (3xTF32, k-steps of 8).  SEP:
// the small terms (small*big + big*small) go to accumulators of their own,
// added at the end, so the tensor cores' fp32 sums round a third as many
// additions into the large accumulator (the backward's S and dP, whose
// dP - D cancels; about half the error at hd 256).
template <int HD, int BK, int LD, bool SEP = false>
__device__ __forceinline__ void scores(float (&s)[BK / 8][4], const float* qa, const float* ka) {
  float sl[BK / 8][4];
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = sl[n][e] = 0.f;
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
      if (SEP) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_tf32(sl[n + m], as, bb[m]);
          mma_tf32(sl[n + m], ab, bs[m]);
          mma_tf32(s[n + m], ab, bb[m]);
        }
      } else {
        mma_3xtf32(s[n], ab, as, bb[0], bs[0]);
        mma_3xtf32(s[n + 1], ab, as, bb[1], bs[1]);
      }
    }
  }
  if (SEP) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += sl[n][e];
  }
}

// The same for bf16 (one product, k-steps of 16; SEP has nothing to separate).
template <int HD, int BK, int LD, bool SEP = false>
__device__ __forceinline__ void scores(float (&s)[BK / 8][4], const __nv_bfloat16* qa,
                                       const __nv_bfloat16* ka) {
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

// o[d] += P V for output columns 8d..8d+7: p is an accumulator of scores()
// (the warp's 16 rows x BK), V a tile of BK rows (row stride LD) whose first
// HD columns are summed into.
template <int HD, int BK, int LD>
__device__ __forceinline__ void accumulate(float (&o)[HD / 8][4], const float (&p)[BK / 8][4],
                                           const float* Vt, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    // m16n8k8's A and accumulator layouts do not line up, so each 8-row
    // group of V is taken in a permuted order: logical k = t is row 8n+2t,
    // k = t+4 is row 8n+2t+1, and the accumulator's (c0, c2, c1, c3) are
    // the A operand's (a0, a1, a2, a3).
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

// For bf16, V's B operand comes by a transposing ldmatrix: tiles (rows
// 16j..16j+7 | 16j+8..16j+15) x (columns 8d..8d+7 | 8d+8..8d+15).
template <int HD, int BK, int LD>
__device__ __forceinline__ void accumulate(float (&o)[HD / 8][4], const float (&p)[BK / 8][4],
                                           const __nv_bfloat16* Vt, int lane) {
  const int mi = lane >> 3;
  const __nv_bfloat16* va = Vt + ((mi & 1) * 8 + (lane & 7)) * LD + (mi >> 1) * 8;
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    // Accumulators 2j and 2j+1 (rows 16j..16j+15 of V) are m16n8k16's A operand.
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

// -- key tiles that a block of queries may see ----------------------------------------

// This thread's key of tiles j .. j + (threads/BK) - 1 (-1 past Sk).
template <int BK, typename P>
__device__ __forceinline__ int key_pos(const P& p, const int* kpos, int j) {
  const int c = j * BK + threadIdx.x;
  return c < p.Sk ? __ldg(kpos + c) : -1;
}

// The first key tile at or after j that some query of the block may see
// (nkb if none).  kp is key_pos(j): one read covers NT/BK candidate tiles,
// and the caller reads the first one ahead of time.  full: every query of
// the block sees every key of the tile (no mask needed).  The tile's
// positions go to kp_dst after the first barrier, so the stage's last reader
// is done with it.
template <int BK, int NT, typename P>
__device__ __forceinline__ int next_tile(const P& p, const int* kpos, int j, int nkb,
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

}  // namespace
