// RWKV-6 WKV chunked scan forward for Hopper (sm_90a), in two kernels.
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
// What bounds it on this card.  Per (b, h) the function reads r, k, v, logw
// once and writes y once, and it does about 2*L*N*(L/2 + 2N) flops and
// L*L*N/2 exponentials per chunk of L rows.  At the serving shape (rwkv6-1.6b
// prefill, B=8 S=512 H=32 N=64 L=32, fp32) that is ~3.2 GFLOP against
// ~176 MB: the 3.35 TB/s of HBM (~53 us) and the 67 TFLOP/s of the CUDA cores
// (~48 us) bound it about equally.  But a scan that walks the chunks of one
// (b, h) in order has only B*H = 256 independent walks, about two blocks an
// SM, too few to hide the latency of its loads, exponentials and barriers.
//
// What the design does about it.  Only the state links one chunk to the
// next, and only two plain products touch it, so the scan is cut there into
// two kernels on one stream:
// - rwkv6_scan_states_kernel, grid (b, h, column group): a block carries
//   MG = 32 of the state's 64 columns through the chunks in order, in
//   registers (8 entries a thread), and writes the state entering every
//   chunk after the first to a workspace (B, H, n_chunks - 1, N, N) and the
//   final state to s_out.  Each block loads the next chunk's k, logw and v
//   into registers while it works on this one.  Both blocks of a (b, h)
//   compute the running sums and k * exp(cum_last - cum); they are
//   neighbours in the grid, so the second one's reads of k and logw hit L2.
//   512 blocks at the serving shape, all resident at once.
// - rwkv6_scan_outputs_kernel, grid (b, h, chunk): every chunk at once,
//   4,096 blocks at the serving shape.  A block builds A for its chunk, with
//   the L(L+1)/2 pairs at or below the diagonal spread evenly over its
//   threads (off-diagonal pairs first, so that few warps mix the two kinds),
//   then y from A, V and the state entering the chunk (the initial state for
//   chunk 0, else the workspace), which it loads while it makes r' and A @ V
//   and keeps where k and r were, so that four blocks fit an SM.
// The arithmetic of each product is the single-kernel scan's, term for term
// and in the same order: each product is summed on its own and added to the
// other term once (y = A@V + r'@S; S = decay*S + k'^T@V), since adding 32
// small terms one by one to a large running value would round each time.
// The split costs bytes (the workspace is written once and read once, ~2.3x
// the function's bytes at the serving shape) for 16x the blocks.  Tiles read
// by column across a warp have row stride N+1, so that those reads are
// conflict-free; the products read rows of A, r' and k' as float4.  Head
// size 64 only, the one the served model has, and chunks up to 32, so that
// a thread's accumulators stay in registers.  Tensor cores for the
// products, loads that bypass registers (cp.async) and an A without an
// exponential per (t, s, n) are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int LMAX = 32;    // longest chunk taken: every config's rwkv_chunk
constexpr int N = 64;       // head size
constexpr int LD = N + 1;   // row stride of a tile read by column
constexpr int LA = LMAX + 4;  // row stride of A: rows 16-byte aligned

// states kernel: G column groups of MG columns; a thread owns RS rows of one
// column, rows RS*rg .. RS*rg + RS-1, so that its reads of k' are float4.
constexpr int G = 2;
constexpr int MG = N / G;
constexpr int NT1 = 256;
constexpr int MINB1 = 4;    // blocks an SM: 512 blocks resident at once
constexpr int RS = N * MG / NT1;
constexpr int KJ = LMAX * N / NT1;    // elements of k (and of logw) a thread loads
constexpr int VJ = LMAX * MG / NT1;   // elements of v a thread loads
// outputs kernel: NG threads share one column of y, a thread owns RY rows.
constexpr int NT2 = 256;
constexpr int MINB2 = 4;
constexpr int NG = NT2 / N;
constexpr int RY = LMAX / NG;

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

__host__ __device__ constexpr size_t states_smem(int L) {
  // k then k'; logw then cum; this group's columns of v; cum at the last row
  return sizeof(float) * (2 * L * N + L * MG + N);
}

// A tile of L rows of stride LD, rounded up to whole float4s.
__host__ __device__ constexpr int tile(int L) { return (L * LD + 3) / 4 * 4; }

// L rounded up to whole float4s: the rows of v, and the columns of A, that
// A @ V runs over (the ones past L are 0).
__host__ __device__ constexpr int round4(int L) { return (L + 3) / 4 * 4; }

__host__ __device__ constexpr size_t outputs_smem(int L) {
  // k and r, later the entering state; cum, later r'; cum_excl; v; A; u
  return sizeof(float) * ((2 * tile(L) > N * N ? 2 * tile(L) : N * N) + 2 * tile(L) +
                          round4(L) * N + L * LA + N);
}
// Both fit the 48 KB a block gets without an opt-in, at every chunk (the
// largest chunk needs the most).
static_assert(states_smem(LMAX) <= 48 * 1024 && outputs_smem(LMAX) <= 48 * 1024,
              "shared memory above 48 KB needs cudaFuncSetAttribute");

struct Params {
  const void* r; const void* k; const void* v;
  const float* logw; const float* u; const float* s0;
  void* y; float* s_out;
  float* ws;          // state entering chunks 1 .. nc-1: (B, H, nc-1, N, N)
  int S, H, L, nc;
};

// Column n's running sums over the chunk's L rows of c (row stride ld),
// summed in row order: c <- cum; e <- cum_excl (if given); returns cum at
// the last row.  Run by one thread per column; reads 8 rows ahead.
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
        if (e) e[(t0 + j) * ld + n] = acc - w[j];
      }
    }
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(NT1, MINB1) rwkv6_scan_states_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int L = p.L;
  float* ks = smem;              // k, then k * exp(cum_last - cum); row stride N
  float* cs = ks + L * N;        // logw, then cum
  float* vs = cs + L * N;        // this block's MG columns of v
  float* ds = vs + L * MG;       // cum at the chunk's last row

  const int tid = threadIdx.x, m = tid % MG, rg = tid / MG;
  const int g = blockIdx.x % G, bh = blockIdx.x / G, h = bh % p.H, b = bh / p.H;
  const int col = g * MG + m;
  const long long row = (long long)p.H * N;                     // one time step
  const long long base = (long long)b * p.S * row + (long long)h * N;
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);

  // The next chunk's k, logw and v, loaded into registers while this chunk
  // is worked on; rows past S read 0.
  float pk[KJ], pw[KJ], pv[VJ];
  auto fetch = [&](int c0) {
    const int Lc = min(L, p.S - c0);
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int t = (tid + NT1 * j) / N;
      const long long off = base + (long long)(c0 + t) * row + tid % N;
      pk[j] = t < Lc ? to_f32(kg[off]) : 0.f;
      pw[j] = t < Lc ? p.logw[off] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < VJ; ++j) {
      const int t = (tid + NT1 * j) / MG;
      pv[j] = t < Lc ? to_f32(vg[base + (long long)(c0 + t) * row + g * MG + m]) : 0.f;
    }
  };

  float st[RS];                  // S[RS*rg + j][col]
  const float* s0 = p.s0 + (long long)bh * N * N;
#pragma unroll
  for (int j = 0; j < RS; ++j) st[j] = s0[(RS * rg + j) * N + col];
  fetch(0);

  for (int c = 0; c < p.nc; ++c) {
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int i = tid + NT1 * j;
      if (i < L * N) { ks[i] = pk[j]; cs[i] = pw[j]; }
    }
#pragma unroll
    for (int j = 0; j < VJ; ++j) {
      const int i = tid + NT1 * j;
      if (i < L * MG) vs[i] = pv[j];
    }
    __syncthreads();
    if (c + 1 < p.nc) fetch((c + 1) * L);
    if (tid < N) ds[tid] = running_sums(cs, nullptr, N, tid, L);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int i = tid + NT1 * j;
      if (i < L * N) ks[i] *= expf(ds[i % N] - cs[i]);
    }
    __syncthreads();

    float acc[RS];
#pragma unroll
    for (int j = 0; j < RS; ++j) acc[j] = 0.f;
    for (int t = 0; t < L; ++t) {
      const float vv = vs[t * MG + m];
#pragma unroll
      for (int q = 0; q < RS; q += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(ks + t * N + RS * rg + q);
        acc[q] = fmaf(kk.x, vv, acc[q]);
        acc[q + 1] = fmaf(kk.y, vv, acc[q + 1]);
        acc[q + 2] = fmaf(kk.z, vv, acc[q + 2]);
        acc[q + 3] = fmaf(kk.w, vv, acc[q + 3]);
      }
    }
    float* dst = c + 1 < p.nc ? p.ws + ((long long)bh * (p.nc - 1) + c) * N * N
                              : p.s_out + (long long)bh * N * N;
#pragma unroll
    for (int j = 0; j < RS; ++j) {
      const int n = RS * rg + j;
      st[j] = expf(ds[n]) * st[j] + acc[j];
      dst[n * N + col] = st[j];
    }
    __syncthreads();   // the next chunk's tiles overwrite these
  }
}

// Pair i of the strict lower triangle, row by row: (t, s) with s < t and
// i = t(t-1)/2 + s.
__device__ __forceinline__ int2 lower_pair(int i) {
  int t = static_cast<int>((1.f + sqrtf(8.f * i + 1.f)) * 0.5f);
  t -= t * (t - 1) / 2 > i;      // sqrtf's rounding puts t at most one off
  t += (t + 1) * t / 2 <= i;
  return make_int2(t, i - t * (t - 1) / 2);
}

template <typename T>
__global__ void __launch_bounds__(NT2, MINB2) rwkv6_scan_outputs_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int L = p.L, TL = tile(L), L4 = round4(L);
  float* ks = smem;              // k; rows of stride LD
  float* rs = ks + TL;           // r
  float* Ss = smem;              // once r' is made: the state entering the chunk
  float* cs = smem + (2 * TL > N * N ? 2 * TL : N * N);   // logw, then cum
  float* rp = cs;                // once A is built: r * exp(cum_excl), row stride N
  float* es = cs + TL;           // cum_excl
  float* vs = es + TL;           // v, row stride N, L4 rows
  float* As = vs + L4 * N;       // A, row stride LA
  float* us = As + L * LA;

  const int tid = threadIdx.x;
  const int c = blockIdx.x % p.nc, bh = blockIdx.x / p.nc, h = bh % p.H, b = bh / p.H;
  const int c0 = c * L, Lc = min(L, p.S - c0);     // valid rows of this chunk
  const long long row = (long long)p.H * N;
  const long long base = (long long)b * p.S * row + (long long)h * N + (long long)c0 * row;
  const T* rg = static_cast<const T*>(p.r);
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);
  T* yg = static_cast<T*>(p.y);

#pragma unroll
  for (int j = 0; j < LMAX * N / NT2; ++j) {
    const int i = tid + NT2 * j, t = i / N, n = i % N;
    const bool in = t < Lc;
    const long long off = base + (long long)t * row + n;
    if (t < L) {
      rs[t * LD + n] = in ? to_f32(rg[off]) : 0.f;
      ks[t * LD + n] = in ? to_f32(kg[off]) : 0.f;
      cs[t * LD + n] = in ? p.logw[off] : 0.f;
    }
    if (t < L4) vs[i] = in ? to_f32(vg[off]) : 0.f;
  }
  if (tid < N) us[tid] = p.u[h * N + tid];
  if (tid < L * (L4 - L)) As[tid / (L4 - L) * LA + L + tid % (L4 - L)] = 0.f;
  __syncthreads();
  if (tid < N) running_sums(cs, es, LD, tid, L);
  __syncthreads();

  // A: the L(L-1)/2 pairs below the diagonal, then the L on it.  Each entry
  // above the diagonal is set to 0 by the thread of its mirror pair.
  const int P = L * (L - 1) / 2;
  for (int i = tid; i < P + L; i += NT2) {
    float a = 0.f;
    if (i < P) {
      const int2 ts = lower_pair(i);
      const int t = ts.x, s = ts.y;
#pragma unroll 8
      for (int n = 0; n < N; ++n)
        a = fmaf(rs[t * LD + n] * ks[s * LD + n], expf(es[t * LD + n] - cs[s * LD + n]), a);
      As[t * LA + s] = a;
      As[s * LA + t] = 0.f;
    } else {
      const int t = i - P;
#pragma unroll 8
      for (int n = 0; n < N; ++n) a = fmaf(rs[t * LD + n] * us[n], ks[t * LD + n], a);
      As[t * LA + t] = a;
    }
  }
  __syncthreads();

  // The state entering the chunk (the initial state for chunk 0) is loaded
  // while r' and A @ V are made, then takes the place of k and r.
  const float* s_in = c == 0 ? p.s0 + (long long)bh * N * N
                             : p.ws + ((long long)bh * (p.nc - 1) + c - 1) * N * N;
  float sv[N * N / NT2];
#pragma unroll
  for (int j = 0; j < N * N / NT2; ++j) sv[j] = s_in[tid + NT2 * j];
#pragma unroll
  for (int j = 0; j < LMAX * N / NT2; ++j) {
    const int i = tid + NT2 * j, t = i / N, n = i % N;
    if (t < L) rp[i] = rs[t * LD + n] * expf(es[t * LD + n]);
  }
  // y[t][col] for rows t = grp + NG*i: A @ V first.
  const int col = tid % N, grp = tid / N;
  float intra[RY], inter[RY];
#pragma unroll
  for (int i = 0; i < RY; ++i) intra[i] = inter[i] = 0.f;
  for (int s = 0; s < L4; s += 4) {
    const float v0 = vs[s * N + col], v1 = vs[(s + 1) * N + col];
    const float v2 = vs[(s + 2) * N + col], v3 = vs[(s + 3) * N + col];
#pragma unroll
    for (int i = 0; i < RY; ++i) {
      const int t = grp + NG * i;
      if (t < L) {
        const float4 a = *reinterpret_cast<const float4*>(As + t * LA + s);
        intra[i] = fmaf(a.x, v0, intra[i]);
        intra[i] = fmaf(a.y, v1, intra[i]);
        intra[i] = fmaf(a.z, v2, intra[i]);
        intra[i] = fmaf(a.w, v3, intra[i]);
      }
    }
  }
  __syncthreads();   // every read of k and r is done
#pragma unroll
  for (int j = 0; j < N * N / NT2; ++j) Ss[tid + NT2 * j] = sv[j];
  __syncthreads();
  for (int n = 0; n < N; n += 4) {
    const float s0 = Ss[n * N + col], s1 = Ss[(n + 1) * N + col];
    const float s2 = Ss[(n + 2) * N + col], s3 = Ss[(n + 3) * N + col];
#pragma unroll
    for (int i = 0; i < RY; ++i) {
      const int t = grp + NG * i;
      if (t < L) {
        const float4 rv = *reinterpret_cast<const float4*>(rp + t * N + n);
        inter[i] = fmaf(rv.x, s0, inter[i]);
        inter[i] = fmaf(rv.y, s1, inter[i]);
        inter[i] = fmaf(rv.z, s2, inter[i]);
        inter[i] = fmaf(rv.w, s3, inter[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RY; ++i) {
    const int t = grp + NG * i;
    if (t < Lc) yg[base + (long long)t * row + col] = from_f32<T>(intra[i] + inter[i]);
  }
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  rwkv6_scan_states_kernel<T><<<B * p.H * G, NT1, states_smem(p.L), stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rwkv6_scan_outputs_kernel<T><<<B * p.H * p.nc, NT2, outputs_smem(p.L), stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t occupancy(int L, int* smem_bytes, int* blocks_per_sm) {
  smem_bytes[0] = static_cast<int>(states_smem(L));
  smem_bytes[1] = static_cast<int>(outputs_smem(L));
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, rwkv6_scan_states_kernel<T>, NT1, states_smem(L));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm + 1, rwkv6_scan_outputs_kernel<T>, NT2, outputs_smem(L));
}

}  // namespace

// dtype of r/k/v/y: 0 = float32, 1 = bfloat16.  Every tensor is contiguous:
// r, k, v, logw, y (B,S,H,N); u (H,N), state and s_out (B,H,N,N), all three
// fp32; ws, the fp32 workspace (B,H,ceil(S/L)-1,N,N), unused when S <= L.
// 1 <= L <= 32; head_size is N = 64.  Launches the states kernel, then the
// outputs kernel, on the stream without synchronising; returns the first
// cudaError_t (0 on success).
extern "C" int rwkv6_scan_fwd(
    const void* r, const void* k, const void* v, const void* logw,
    const void* u, const void* state, void* y, void* s_out, void* ws,
    int dtype, int B, int S, int H, int head_size, int L, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || head_size != N || L <= 0 || L > LMAX)
    return cudaErrorInvalidValue;
  Params p;
  p.r = r; p.k = k; p.v = v;
  p.logw = static_cast<const float*>(logw);
  p.u = static_cast<const float*>(u);
  p.s0 = static_cast<const float*>(state);
  p.y = y; p.s_out = static_cast<float*>(s_out);
  p.ws = static_cast<float*>(ws);
  p.S = S; p.H = H; p.L = L; p.nc = (S + L - 1) / L;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(p, B, s);
    case 1: return launch<__nv_bfloat16>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a block and blocks an SM can hold, for the states
// kernel ([0]) and the outputs kernel ([1]) at chunk L, as the card reports
// them.  Returns a cudaError_t.
extern "C" int rwkv6_scan_occupancy(int dtype, int L, int* smem_bytes, int* blocks_per_sm) {
  if (L <= 0 || L > LMAX) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return occupancy<float>(L, smem_bytes, blocks_per_sm);
    case 1: return occupancy<__nv_bfloat16>(L, smem_bytes, blocks_per_sm);
    default: return cudaErrorInvalidValue;
  }
}
