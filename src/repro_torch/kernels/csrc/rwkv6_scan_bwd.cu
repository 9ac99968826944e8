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
// dstate fp32; all arithmetic fp32.
//
// What bounds it on this card.  Per (b, h) the function reads r, k, v, logw
// and dy once and writes dr, dk, dv and dlogw once: at the training shape
// (rwkv6-1.6b, B=8 S=512 H=32 N=64 L=32, fp32) 9 x 33.5 MB, ~90 us at
// 3.35 TB/s.  Its operations are about three times the forward's, with
// three exponentials for every pair (t, s) below the diagonal and channel n
// (one for A, one each for dr and dk), so on the CUDA cores it is bound by
// operations, as the forward is.
//
// What the design does about it: the forward's split, run backwards.  Only
// dS links one chunk to the one before it, so
// - rwkv6_scan_bwd_states_kernel, grid (b, h, column group), carries MG = 32
//   columns of dS through the chunks from the last to the first in
//   registers (8 entries a thread) and writes dS' of every chunk to a
//   workspace (B, H, n_chunks, N, N), and dS entering chunk 0 to dstate:
//   the forward's states kernel with (r e^{ce}, dy) in place of
//   (k e^{cL - c}, v);
// - rwkv6_scan_bwd_grads_kernel, grid (b, h, chunk), takes S (the forward's
//   workspace, or the initial state for chunk 0) and dS', builds A and dA
//   for its chunk, then each thread owns one channel of a few rows and
//   makes dr, dk, dv and their parts of dlogw, sigma and du; after a barrier
//   one thread a channel runs dlogw's running sum and writes the chunk's
//   partial of du;
// - rwkv6_scan_bwd_du_kernel sums the partials of du over b and the chunks
//   in a fixed order, so that two runs give the same bits (no atomics).
// Tiles read by column across a warp have row stride N+1.  Head size 64 and
// chunks up to 32, the forward's limits.  Tensor cores, cp.async and speed
// work are left for later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int LMAX = 32;    // longest chunk taken
constexpr int N = 64;       // head size
constexpr int LD = N + 1;   // row stride of a tile read by column
constexpr int LA = LMAX + 1;  // row stride of A and dA

// states kernel: G column groups of MG columns; a thread owns RS rows of one
// column, rows RS*rg .. RS*rg + RS-1, so that its reads of r' are float4.
constexpr int G = 2;
constexpr int MG = N / G;
constexpr int NT1 = 256;
constexpr int RS = N * MG / NT1;
// grads kernel: a thread owns channel tid % N of rows tid / N + RG*j.
constexpr int NT2 = 256;
constexpr int RG = NT2 / N;
constexpr int RJ = LMAX / RG;    // rows a thread owns, at most

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
  // r then r'; logw then cum; cum_excl; this group's columns of dy; cum at the last row
  return sizeof(float) * (3 * L * N + L * MG + N);
}

__host__ __device__ constexpr size_t grads_smem(int L) {
  // r, k, v, dy, cum, cum_excl, k e^{cL - c} (L x LD each); S and dS' (N x LD
  // each); A and dA (L x LA each); u, cL; the partials of sigma and du (RG x N each)
  return sizeof(float) * (7 * L * LD + 2 * N * LD + 2 * L * LA + 2 * N + 2 * RG * N);
}
static_assert(states_smem(LMAX) <= 48 * 1024, "the states kernel takes no opt-in");
static_assert(grads_smem(LMAX) <= 113 * 1024, "two grads blocks an SM");

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

// Pair i of the strict lower triangle, row by row: (t, s) with s < t and
// i = t(t-1)/2 + s.
__device__ __forceinline__ int2 lower_pair(int i) {
  int t = static_cast<int>((1.f + sqrtf(8.f * i + 1.f)) * 0.5f);
  t -= t * (t - 1) / 2 > i;      // sqrtf's rounding puts t at most one off
  t += (t + 1) * t / 2 <= i;
  return make_int2(t, i - t * (t - 1) / 2);
}

template <typename T>
__global__ void __launch_bounds__(NT2, 2) rwkv6_scan_bwd_grads_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int L = p.L;
  float* rs = smem;              // r, later rho; rows of stride LD
  float* ks = rs + L * LD;       // k, later kappa
  float* vs = ks + L * LD;
  float* ys = vs + L * LD;       // dy
  float* cs = ys + L * LD;       // logw, then cum
  float* es = cs + L * LD;       // cum_excl
  float* kp = es + L * LD;       // k * exp(cL - cum)
  float* Ss = kp + L * LD;       // the state entering the chunk, N rows of stride LD
  float* dSs = Ss + N * LD;      // the gradient of the state leaving it
  float* As = dSs + N * LD;      // A, row stride LA
  float* dAs = As + L * LA;      // dA
  float* us = dAs + L * LA;
  float* cl = us + N;            // cum at the last row
  float* sg = cl + N;            // partials of sigma's second term, RG x N
  float* dg = sg + RG * N;       // partials of du, RG x N

  const int tid = threadIdx.x;
  const int c = blockIdx.x % p.nc, bh = blockIdx.x / p.nc, h = bh % p.H, b = bh / p.H;
  const int c0 = c * L, Lc = min(L, p.S - c0);
  const long long row = (long long)p.H * N;
  const long long base = (long long)b * p.S * row + (long long)h * N + (long long)c0 * row;

  {
    const T* rg = static_cast<const T*>(p.r);
    const T* kg = static_cast<const T*>(p.k);
    const T* vg = static_cast<const T*>(p.v);
    const T* yg = static_cast<const T*>(p.dy);
    for (int i = tid; i < L * N; i += NT2) {
      const int t = i / N, n = i % N;
      const bool in = t < Lc;
      const long long off = base + (long long)t * row + n;
      rs[t * LD + n] = in ? to_f32(rg[off]) : 0.f;
      ks[t * LD + n] = in ? to_f32(kg[off]) : 0.f;
      vs[t * LD + n] = in ? to_f32(vg[off]) : 0.f;
      ys[t * LD + n] = in ? to_f32(yg[off]) : 0.f;
      cs[t * LD + n] = in ? p.logw[off] : 0.f;
    }
    const float* s_in = c == 0 ? p.s0 + (long long)bh * N * N
                               : p.ws + ((long long)bh * (p.nc - 1) + c - 1) * N * N;
    const float* ds_in = p.dws + ((long long)bh * p.nc + c) * N * N;
    for (int i = tid; i < N * N; i += NT2) {
      Ss[i / N * LD + i % N] = s_in[i];
      dSs[i / N * LD + i % N] = ds_in[i];
    }
    if (tid < N) us[tid] = p.u[h * N + tid];
  }
  __syncthreads();
  if (tid < N) cl[tid] = running_sums(cs, es, LD, tid, L);
  __syncthreads();

  for (int i = tid; i < L * N; i += NT2) {
    const int t = i / N, n = i % N;
    kp[t * LD + n] = ks[t * LD + n] * expf(cl[n] - cs[t * LD + n]);
  }
  // A and dA at and below the diagonal: the L(L-1)/2 pairs below it, then the L on it.
  const int P = L * (L - 1) / 2;
  for (int i = tid; i < P + L; i += NT2) {
    float a = 0.f, d = 0.f;
    int t, s;
    if (i < P) {
      const int2 ts = lower_pair(i);
      t = ts.x, s = ts.y;
#pragma unroll 8
      for (int n = 0; n < N; ++n)
        a = fmaf(rs[t * LD + n] * ks[s * LD + n], expf(es[t * LD + n] - cs[s * LD + n]), a);
    } else {
      t = s = i - P;
#pragma unroll 8
      for (int n = 0; n < N; ++n) a = fmaf(rs[t * LD + n] * us[n], ks[t * LD + n], a);
    }
#pragma unroll 8
    for (int m = 0; m < N; ++m) d = fmaf(ys[t * LD + m], vs[s * LD + m], d);
    As[t * LA + s] = a;
    dAs[t * LA + s] = d;
  }
  __syncthreads();

  // Channel n of rows t = t0 + RG*j: dr, dk and dv, and the parts of dlogw.
  const int n = tid % N, t0 = tid / N;
  T* drg = static_cast<T*>(p.dr);
  T* dkg = static_cast<T*>(p.dk);
  T* dvg = static_cast<T*>(p.dv);
  float rho[RJ], kappa[RJ], sig = 0.f, dus = 0.f;
#pragma unroll
  for (int j = 0; j < RJ; ++j) {
    const int t = t0 + RG * j;
    rho[j] = kappa[j] = 0.f;
    if (t >= L) continue;
    const float e_t = es[t * LD + n], c_t = cs[t * LD + n];
    const float r_t = rs[t * LD + n], k_t = ks[t * LD + n], dA_tt = dAs[t * LA + t];
    // dr_t: the pairs s < t, then e^{ce_t} (S dy_t)
    float intra = 0.f;
    for (int s = 0; s < t; ++s)
      intra = fmaf(dAs[t * LA + s] * ks[s * LD + n], expf(e_t - cs[s * LD + n]), intra);
    float sdy = 0.f;
#pragma unroll 8
    for (int m = 0; m < N; ++m) sdy = fmaf(Ss[n * LD + m], ys[t * LD + m], sdy);
    const float inter = expf(e_t) * sdy;
    // dk_t: the pairs t' > t, then e^{cL - c_t} (dS' v_t)
    float kintra = 0.f;
    for (int s = t + 1; s < L; ++s)
      kintra = fmaf(dAs[s * LA + t] * rs[s * LD + n], expf(es[s * LD + n] - c_t), kintra);
    float dsv = 0.f;
#pragma unroll 8
    for (int m = 0; m < N; ++m) dsv = fmaf(dSs[n * LD + m], vs[t * LD + m], dsv);
    const float kinter = expf(cl[n] - c_t) * dsv;
    // dv_t, column n: A^T dy, then (k e^{cL - c})_t dS'
    float av = 0.f;
    for (int s = t; s < L; ++s) av = fmaf(As[s * LA + t], ys[s * LD + n], av);
    float kv = 0.f;
#pragma unroll 8
    for (int m = 0; m < N; ++m) kv = fmaf(kp[t * LD + m], dSs[m * LD + n], kv);
    rho[j] = r_t * (intra + inter);
    kappa[j] = k_t * (kintra + kinter);
    sig = fmaf(k_t, kinter, sig);
    dus = fmaf(r_t * k_t, dA_tt, dus);
    if (t < Lc) {
      const long long off = base + (long long)t * row + n;
      drg[off] = from_f32<T>(intra + us[n] * k_t * dA_tt + inter);
      dkg[off] = from_f32<T>(kintra + us[n] * r_t * dA_tt + kinter);
      dvg[off] = from_f32<T>(av + kv);
    }
  }
  __syncthreads();   // every read of r and k is done
#pragma unroll
  for (int j = 0; j < RJ; ++j) {
    const int t = t0 + RG * j;
    if (t < L) { rs[t * LD + n] = rho[j]; ks[t * LD + n] = kappa[j]; }
  }
  sg[t0 * N + n] = sig;
  dg[t0 * N + n] = dus;
  __syncthreads();
  if (tid < N) {
    float ssd = 0.f;
#pragma unroll 8
    for (int m = 0; m < N; ++m) ssd = fmaf(Ss[tid * LD + m], dSs[tid * LD + m], ssd);
    float acc = expf(cl[tid]) * ssd, du = 0.f;
    for (int q = 0; q < RG; ++q) { acc += sg[q * N + tid]; du += dg[q * N + tid]; }
    for (int j = L - 1; j >= 0; --j) {
      acc -= ks[j * LD + tid];
      if (j < Lc) p.dlogw[base + (long long)j * row + tid] = acc;
      acc += rs[j * LD + tid];
    }
    p.du_part[(((long long)b * p.nc + c) * p.H + h) * N + tid] = du;
  }
}

// du[h][n]: the partials summed over b, then the chunks, in that fixed order.
__global__ void __launch_bounds__(N) rwkv6_scan_bwd_du_kernel(const Params p) {
  const int h = blockIdx.x, n = threadIdx.x;
  float acc = 0.f;
  for (int b = 0; b < p.B; ++b)
    for (int c = 0; c < p.nc; ++c)
      acc += p.du_part[(((long long)b * p.nc + c) * p.H + h) * N + n];
  p.du[h * N + n] = acc;
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  rwkv6_scan_bwd_states_kernel<T><<<p.B * p.H * G, NT1, states_smem(p.L), stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(rwkv6_scan_bwd_grads_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(grads_smem(LMAX)));
  if (err != cudaSuccess) return err;
  rwkv6_scan_bwd_grads_kernel<T><<<p.B * p.H * p.nc, NT2, grads_smem(p.L), stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rwkv6_scan_bwd_du_kernel<<<p.H, N, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t occupancy(int L, int* smem_bytes, int* blocks_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(rwkv6_scan_bwd_grads_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(grads_smem(LMAX)));
  if (err != cudaSuccess) return err;
  smem_bytes[0] = static_cast<int>(states_smem(L));
  smem_bytes[1] = static_cast<int>(grads_smem(L));
  smem_bytes[2] = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, rwkv6_scan_bwd_states_kernel<T>, NT1, states_smem(L));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm + 1, rwkv6_scan_bwd_grads_kernel<T>, NT2, grads_smem(L));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm + 2, rwkv6_scan_bwd_du_kernel, N, 0);
}

}  // namespace

// dtype of r/k/v/dy and dr/dk/dv: 0 = float32, 1 = bfloat16.  Every tensor is
// contiguous: r, k, v, logw, dy, dr, dk, dv, dlogw (B,S,H,N); u and du (H,N)
// fp32; state, ds_out and dstate (B,H,N,N) fp32, ds_out null for zeros; ws
// the forward's workspace (B,H,ceil(S/L)-1,N,N) fp32, unused when S <= L;
// dws (B,H,ceil(S/L),N,N) and du_part (B,ceil(S/L),H,N) fp32 scratch.
// 1 <= L <= 32; head_size is N = 64.  Launches the states kernel, the grads
// kernel and the du kernel on the stream without synchronising; returns the
// first cudaError_t (0 on success).
extern "C" int rwkv6_scan_bwd(
    const void* r, const void* k, const void* v, const void* logw, const void* u,
    const void* state, const void* ws, const void* dy, const void* ds_out,
    void* dr, void* dk, void* dv, void* dlogw, void* du, void* dstate,
    void* dws, void* du_part,
    int dtype, int B, int S, int H, int head_size, int L, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || head_size != N || L <= 0 || L > LMAX)
    return cudaErrorInvalidValue;
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
