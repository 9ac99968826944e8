// RWKV-6 WKV chunked scan forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py (rwkv6_scan_pallas,
// body _kernel).  Same contract: r/k/v (B,S,H,N) in fp32 or bf16, logw
// (B,S,H,N) fp32 log-decay, u (H,N) and the initial state (B,H,N,N) in fp32;
// y (B,S,H,N) in r's dtype and the final state (B,H,N,N) in fp32.  Within a
// chunk of L steps, with cum the inclusive and cum_excl the exclusive running
// sum of logw over the chunk:
//   A[t,s] = sum_n r[t,n] k[s,n] exp(cum_excl[t,n] - cum[s,n])   (s < t)
//   A[t,t] = sum_n r[t,n] u[n] k[t,n]
//   y      = A @ V + (r * exp(cum_excl)) @ S
//   S     <- diag(exp(cum[L-1])) S + (k * exp(cum[L-1] - cum))^T @ V
// All arithmetic is fp32.  Pairs s >= t are never exponentiated: the exponent
// of a pair s < t is a sum of log-decays, so it is <= 0 and nothing
// overflows.  A ragged last chunk (S % L != 0) is masked here: its missing
// rows read r = k = v = 0 and logw = 0, which leaves y and the state as the
// JAX wrapper's padding does.
//
// What bounds it on this card.  Per (b, h) the kernel reads r, k, v, logw
// once and writes y once, and it does about 2*L*N*(L/2 + 2N) flops and
// L*L*N/2 exponentials per chunk of L rows.  At the serving shape (rwkv6-1.6b
// prefill, B=8 S=512 H=32 N=64 L=32, fp32) that is ~3.2 GFLOP against
// ~176 MB: the 3.35 TB/s of HBM (~53 us) and the 67 TFLOP/s of the CUDA cores
// (~48 us) bound it about equally.
//
// What the design does about it.  The TPU grid's sequential chunk axis
// becomes a loop inside one thread block per (b, h), with the N x N fp32
// state resident in shared memory for the whole sequence (16 KB at N=64), so
// the state never touches device memory between chunks.  Each chunk's r, k,
// v, logw tiles, the running sums and the L x L matrix A live in shared
// memory (row stride N+1, so that a warp's column reads are conflict-free).
// In the two products a thread owns one output column and a set of rows,
// and reuses each shared load of V or S across its rows.  As in the plain
// chunked scan, each product is summed on its own and added to the other
// term once (y = A@V + r'@S; S = decay*S + k'^T@V): adding 32 small terms one
// by one to a large running value would round each time.  Head size 64 only,
// the one the served model has, and chunks up to 32, so that a thread's
// accumulators stay in registers.  B*H blocks (256 at
// the serving shape) fill the 132 SMs about twice; splitting a sequence
// across blocks, and tensor cores for the products, are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;     // threads per block
constexpr int LMAX = 32;    // longest chunk taken: every config's rwkv_chunk

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

constexpr int N = 64;       // head size

size_t smem_bytes(int L) {
  // state; r, k, v, cum, cum_excl tiles; A; u; cum at the chunk's last row
  return sizeof(float) * (N * (N + 1) + 5 * L * (N + 1) + L * (L + 1) + 2 * N);
}

struct Params {
  const void* r; const void* k; const void* v;
  const float* logw; const float* u; const float* s0;
  void* y; float* s_out;
  int S, H, L;
};

template <typename T>
__global__ void __launch_bounds__(NT) rwkv6_scan_kernel(const Params p) {
  constexpr int LD = N + 1;
  constexpr int NG = NT / N;     // threads that share one column
  constexpr int RY = LMAX / NG;  // most rows of y a thread owns
  constexpr int RS = N / NG;     // rows of the state a thread owns
  extern __shared__ float smem[];
  const int L = p.L;
  float* Ss = smem;              // state S[n][m]
  float* rs = Ss + N * LD;       // r, then r * exp(cum_excl)
  float* ks = rs + L * LD;       // k, then k * exp(cum_last - cum)
  float* vs = ks + L * LD;
  float* cs = vs + L * LD;       // logw, then cum
  float* es = cs + L * LD;       // cum_excl
  float* As = es + L * LD;       // A, row stride L+1
  float* us = As + L * (L + 1);
  float* ds = us + N;            // cum at the chunk's last row

  const int tid = threadIdx.x, col = tid % N, grp = tid / N;
  const int bh = blockIdx.x, h = bh % p.H, b = bh / p.H;
  const long long row = (long long)p.H * N;                     // one time step
  const long long base = (long long)b * p.S * row + (long long)h * N;
  const T* rg = static_cast<const T*>(p.r);
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);
  T* yg = static_cast<T*>(p.y);

  const float* s0 = p.s0 + (long long)bh * N * N;
  for (int i = tid; i < N * N; i += NT) Ss[(i / N) * LD + i % N] = s0[i];
  if (tid < N) us[tid] = p.u[h * N + tid];

  for (int c0 = 0; c0 < p.S; c0 += L) {
    const int Lc = min(L, p.S - c0);   // valid rows of this chunk
    __syncthreads();                   // the previous chunk is done with the tiles
    for (int i = tid; i < L * N; i += NT) {
      const int t = i / N, n = i % N;
      const bool in = t < Lc;
      const long long off = base + (long long)(c0 + t) * row + n;
      rs[t * LD + n] = in ? to_f32(rg[off]) : 0.f;
      ks[t * LD + n] = in ? to_f32(kg[off]) : 0.f;
      vs[t * LD + n] = in ? to_f32(vg[off]) : 0.f;
      cs[t * LD + n] = in ? p.logw[off] : 0.f;
    }
    __syncthreads();
    if (tid < N) {
      float acc = 0.f;
      for (int t = 0; t < L; ++t) {
        const float w = cs[t * LD + tid];
        acc += w;
        cs[t * LD + tid] = acc;
        es[t * LD + tid] = acc - w;
      }
      ds[tid] = acc;
    }
    __syncthreads();

    // A: a warp takes one row t and consecutive s.
    for (int i = tid; i < L * L; i += NT) {
      const int t = i / L, s = i % L;
      float a = 0.f;
      if (s < t) {
#pragma unroll 8
        for (int n = 0; n < N; ++n)
          a = fmaf(rs[t * LD + n] * ks[s * LD + n], expf(es[t * LD + n] - cs[s * LD + n]), a);
      } else if (s == t) {
#pragma unroll 8
        for (int n = 0; n < N; ++n) a = fmaf(rs[t * LD + n] * us[n], ks[t * LD + n], a);
      }
      As[t * (L + 1) + s] = a;
    }
    __syncthreads();
    for (int i = tid; i < L * N; i += NT) {
      const int t = i / N, n = i % N;
      rs[t * LD + n] *= expf(es[t * LD + n]);
      ks[t * LD + n] *= expf(ds[n] - cs[t * LD + n]);
    }
    __syncthreads();

    // y[t][col] for rows t = grp + NG*i.
    {
      float intra[RY], inter[RY];
#pragma unroll
      for (int i = 0; i < RY; ++i) intra[i] = inter[i] = 0.f;
      for (int s = 0; s < L; ++s) {
        const float vv = vs[s * LD + col];
#pragma unroll
        for (int i = 0; i < RY; ++i) {
          const int t = grp + NG * i;
          if (t < L) intra[i] = fmaf(As[t * (L + 1) + s], vv, intra[i]);
        }
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float sv = Ss[n * LD + col];
#pragma unroll
        for (int i = 0; i < RY; ++i) {
          const int t = grp + NG * i;
          if (t < L) inter[i] = fmaf(rs[t * LD + n], sv, inter[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < RY; ++i) {
        const int t = grp + NG * i;
        if (t < Lc) yg[base + (long long)(c0 + t) * row + col] = from_f32<T>(intra[i] + inter[i]);
      }
    }
    __syncthreads();   // every read of the old state is done

    // S[n][col] for rows n = grp + NG*i; each entry has one owner.
    {
      float acc[RS];
#pragma unroll
      for (int i = 0; i < RS; ++i) acc[i] = 0.f;
      for (int t = 0; t < L; ++t) {
        const float vv = vs[t * LD + col];
#pragma unroll
        for (int i = 0; i < RS; ++i) acc[i] = fmaf(ks[t * LD + grp + NG * i], vv, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < RS; ++i) {
        const int n = grp + NG * i;
        Ss[n * LD + col] = expf(ds[n]) * Ss[n * LD + col] + acc[i];
      }
    }
  }
  __syncthreads();
  float* so = p.s_out + (long long)bh * N * N;
  for (int i = tid; i < N * N; i += NT) so[i] = Ss[(i / N) * LD + i % N];
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  // Above 48 KB, dynamic shared memory needs an opt-in, once per instantiation.
  static const cudaError_t attr = cudaFuncSetAttribute(
      rwkv6_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(LMAX)));
  if (attr != cudaSuccess) return attr;
  rwkv6_scan_kernel<T><<<B * p.H, NT, smem_bytes(p.L), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype of r/k/v/y: 0 = float32, 1 = bfloat16.  Every tensor is contiguous:
// r, k, v, logw, y (B,S,H,N); u (H,N), state and s_out (B,H,N,N), all three
// fp32.  1 <= L <= 32; head_size is N = 64.  Returns the launch's cudaError_t
// (0 on success); the launch does not synchronise.
extern "C" int rwkv6_scan_fwd(
    const void* r, const void* k, const void* v, const void* logw,
    const void* u, const void* state, void* y, void* s_out,
    int dtype, int B, int S, int H, int head_size, int L, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || head_size != N || L <= 0 || L > LMAX)
    return cudaErrorInvalidValue;
  Params p;
  p.r = r; p.k = k; p.v = v;
  p.logw = static_cast<const float*>(logw);
  p.u = static_cast<const float*>(u);
  p.s0 = static_cast<const float*>(state);
  p.y = y; p.s_out = static_cast<float*>(s_out);
  p.S = S; p.H = H; p.L = L;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(p, B, s);
    case 1: return launch<__nv_bfloat16>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}
