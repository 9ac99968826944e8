// Flash attention forward for Hopper (sm_90a): blocked online softmax.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py
// (flash_attention_pallas, body _kernel).  Same contract: q (B,Sq,H,hd),
// k/v (B,Sk,K,hd), GQA head h reads kv head h / (H/K); the mask comes from
// position vectors (causal q_pos-k_pos >= 0, window q_pos-k_pos < window,
// k_pos < 0 is an empty ring slot); optional tanh softcap; scale 1/sqrt(hd);
// running max, sum and accumulator in fp32; output in q's dtype.  One
// difference, on purpose: a row whose keys are all masked returns 0, as
// kernels/ref.py does, where the TPU kernel (masking with -1e30) returns the
// mean of the masked values.  Here masked scores are -inf and a row's running
// max stays -inf until it sees an allowed key, so masked keys never add
// weight, whichever key block they fall in.
//
// What bounds it on this card.  Per (b, h) the work is 4*hd flops for every
// allowed (query, key) pair against one read of q, k, v and one write of
// the output.  At the serving shape (smollm prefill, B=8 S=512 H=9 K=3
// hd=64, causal) that is ~2.4 GFLOP against ~25 MB: in fp32, which must stay
// off the tensor cores (no TF32), the 67 TFLOP/s of the CUDA cores bound it
// (~36 us) well before the 3.35 TB/s of HBM (~7.5 us).
//
// What the design does about it.  The scores never touch device memory: one
// thread block owns 64 query rows of one (b, h) and loops over key blocks of
// 64, in place of the TPU grid's sequential kv axis, keeping the softmax
// state in registers.  q/k/v are read through their strides in the
// (B,S,heads,hd) layout (no transpose copies) and converted to fp32 in shared
// memory; ragged edges are masked in the kernel (no padding copies).  Each
// of the 256 threads computes a 4x4 register tile of scores and a 4 x hd/16
// tile of the output, so every shared-memory load feeds 2 fused
// multiply-adds.  Key blocks that no query of the block may see (causal
// future, outside the window, empty slots) are skipped whole.  Tensor cores
// (wgmma for bf16) and TMA pipelining are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per inner step
constexpr int NT = 256;       // threads: a 16 x 16 grid (ty rows, tx keys/dims)
constexpr int PLD = BK + 1;   // padded row stride of the probability tile

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  // Q, K, V tiles (row stride HD+1 keeps the strided reads conflict-free),
  // the probability tile, and the block's query and key positions.
  return sizeof(float) * ((BQ + 2 * BK) * (HD + 1) + BQ * PLD) + sizeof(int) * (BQ + BK);
}

struct Params {
  const void* q; const void* k; const void* v;
  const int* q_pos; const int* k_pos;
  void* o;
  int Sq, Sk, H, K;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, has_window, window;
  float softcap, scale;
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_attention_fwd_kernel(const Params p) {
  constexpr int LD = HD + 1;
  constexpr int DJ = HD / 16;   // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;
  int* qp_s = reinterpret_cast<int*>(Ps + BQ * PLD);
  int* kp_s = qp_s + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;
  const int* qpos = p.q_pos + (long long)b * p.Sq;
  const int* kpos = p.k_pos + (long long)b * p.Sk;
  const int nq = min(BQ, p.Sq - q0);   // valid query rows of this block

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    Qs[r * LD + d] = r < nq ? to_f32(qg[(q0 + r) * p.q_ss + d]) : 0.f;
  }
  if (tid < BQ) qp_s[tid] = tid < nq ? qpos[q0 + tid] : 0;
  __syncthreads();
  // The block's position range decides which key blocks it may skip.
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int r = 0; r < nq; ++r) {
    qmin = min(qmin, qp_s[r]);
    qmax = max(qmax, qp_s[r]);
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < p.Sk; k0 += BK) {
    __syncthreads();   // the previous step is done with Ks, Vs, Ps, kp_s
    int seen = 0;
    if (tid < BK) {
      const int c = k0 + tid;
      const int kp = c < p.Sk ? kpos[c] : -1;
      kp_s[tid] = kp;
      // Necessary for any query of the block to see this key.
      seen = kp >= 0 && (!p.causal || qmax - kp >= 0) &&
             (!p.has_window || qmin - kp < p.window);
    }
    if (!__syncthreads_or(seen)) continue;   // every score of the step is masked
    const int nk = min(BK, p.Sk - k0);
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD;
      const bool in = r < nk;
      Ks[r * LD + d] = in ? to_f32(kg[(k0 + r) * p.k_ss + d]) : 0.f;
      Vs[r * LD + d] = in ? to_f32(vg[(k0 + r) * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    // Scores for rows ty+16i and keys tx+16j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qp = qp_s[r];
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kp_s[tx + 16 * j];
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        const bool ok = kp >= 0 && (!p.causal || qp - kp >= 0) &&
                        (!p.has_window || qp - kp < p.window);
        s[i][j] = ok ? x : -INFINITY;
        rmax = fmaxf(rmax, s[i][j]);
      }
      // The 16 threads of a row are one half-warp: xor 8, 4, 2, 1 stays inside it.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;   // no key seen yet
      const float alpha = expf(m[i] - m_use);                 // 0 while m[i] is -inf
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = expf(s[i][j] - m_use);                // masked: exp(-inf) = 0
        rsum += pj;
        Ps[r * PLD + tx + 16 * j] = pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc[rows ty+16i][dims tx+16j] += P @ V
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PLD + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  // Output is contiguous (B, Sq, H, hd).
  T* og = static_cast<T*>(p.o) + ((long long)b * p.Sq * p.H + h) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    const bool any = l[i] > 0.f;   // false only for a fully masked row
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      og[(long long)(q0 + r) * p.H * HD + tx + 16 * j] =
          from_f32<T>(any ? acc[i][j] / l[i] : 0.f);
  }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  // Above 48 KB, dynamic shared memory needs an opt-in, once per instantiation.
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  flash_attention_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(p);
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last axis
// of q, k and v must be contiguous, positions are contiguous int32 (B,S) and
// the output is a contiguous (B,Sq,H,hd) buffer of q's dtype.  Returns the
// launch's cudaError_t (0 on success); the launch does not synchronise.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v,
    const void* q_pos, const void* k_pos, void* out,
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
  p.Sq = Sq; p.Sk = Sk; p.H = H; p.K = K;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
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
