// Flash-attention forward for Hopper (sm_90a): online-softmax attention with
// causal masking, a sliding window and grouped-query heads.
//
// Replaces the TPU kernel kernels/flash_attention.py:_fwd_kernel of the JAX
// package (line 58; reached there through flash_attention_fwd ->
// ops.flash_attention -> models/attention.py:self_attention on the prefill
// and forward path). It computes what that kernel computes:
//   s = (q·kᵀ)·sm_scale in float32; key j visible from query i iff
//       (not causal or j <= i) and (no window or i - j < window) and j < Sk;
//   m = running max, p = exp(s - m) on visible keys, l = Σp,
//   acc = Σ p·v in float32 (P is never rounded to a narrower type);
//   o = acc / l in q's type, lse = m + log l (float32).
// GQA: q head h reads kv head h / (Hq / Hkv); k and v are never repeated.
//
// Differences from the TPU kernel, on purpose:
// - Ragged edges are masked. The JAX wrapper floors n_q = Sq / block_q and
//   leaves the tail rows of o unwritten; here any Sq and Sk work (rows past
//   Sq are computed on zeros and not stored; keys past Sk are masked and
//   their k/v rows zero-filled in shared memory, so 0·v is never NaN).
// - A masked entry contributes p = 0 exactly. The TPU kernel uses the
//   finite NEG_INF = -1e30 alone, so a row whose first visited block is
//   all masked briefly carries p = exp(0) = 1 until a visible key wipes it
//   with alpha = 0. Here that never happens, and a row with nothing visible
//   ends with l = 0, o = 0 and lse = NEG_INF + log 1, the value the plain
//   version (ref.flash_attention_fwd_torch) gives.
//
// What bounds it on this card. At the prefill's shapes (B=8, Hq=32, Hkv=8,
// S=2048, D=64, bf16, causal) the work is 4·B·Hq·D·S(S+1)/2 ≈ 1.37e11
// operations against ≈ 170 MB of q/k/v/o/lse: at the bf16 tensor-core peak
// (989 TFLOP/s) 0.139 ms, at 3.35 TB/s 0.05 ms, so the function is bound by
// operations. This first version does every product as a float32 FMA on
// the CUDA cores (67 TFLOP/s peak, so at least ~2 ms there) and reads its
// operands from shared memory, so in practice it is bound by the FMA rate
// and shared-memory load bandwidth. mma.sync/wgmma for q·kᵀ, TMA staging and a
// bf16 P are left for later work.
//
// Design. Grid (ceil(Sq/64), B·Hq); one block of 256 threads owns 64 query
// rows of one (batch, head) and loops over the 64-key tiles that the causal
// limit and the window admit (tiles wholly outside are never loaded). Under
// causal masking the heaviest query tiles are launched first. q, k and v
// tiles are converted to float32 into shared memory (row pitch D+4 floats:
// 16-byte aligned rows, conflict-free float4 reads across a quarter warp).
// Thread (ty, tx) holds rows ty+16i and key columns tx+16j (i, j < 4) of
// the score tile and output columns tx+16n (n < D/16); the 16 threads that
// share a row sit in one half warp, so the row max and sum are shuffles.
// The running (m, l, acc) stay in registers for the whole key loop; P goes
// through shared memory for the P·V product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;
constexpr int PK = BK + 4;     // pitch of the P tile's rows (floats)
constexpr float NEG_INF = -1e30f;

template <int D>
struct Smem {
  static constexpr int P = D + 4;               // pitch of q/k/v rows
  static constexpr int q = 0;
  static constexpr int k = q + BQ * P;
  static constexpr int v = k + BK * P;
  static constexpr int p = v + BK * P;
  static constexpr size_t bytes = (size_t)(p + BQ * PK) * sizeof(float);
};

__device__ __forceinline__ float4 load4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* src) {
  const uint2 u = *reinterpret_cast<const uint2*>(src);
  __nv_bfloat162 lo, hi;
  lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* dst, float x) { *dst = x; }

__device__ __forceinline__ void store1(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);                   // round to nearest even
}

__device__ __forceinline__ float fma4(float4 a, float4 b, float c) {
  c = fmaf(a.x, b.x, c);
  c = fmaf(a.y, b.y, c);
  c = fmaf(a.z, b.z, c);
  return fmaf(a.w, b.w, c);
}

// Rows [row0, row0 + 64) of a row-major (n_rows, D) matrix into shared
// memory as float32 with pitch D+4; rows at or past n_rows are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int n_rows) {
  constexpr int P = Smem<D>::P;
  constexpr int V4 = D / 4;
  for (int c = threadIdx.x; c < 64 * V4; c += THREADS) {
    const int r = c / V4;
    const int d = (c % V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) x = load4(src + (size_t)(row0 + r) * D + d);
    *reinterpret_cast<float4*>(&dst[r * P + d]) = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
                 int causal, int window, float scale) {
  using L = Smem<D>;
  constexpr int P = L::P;
  constexpr int NC = D / 16;                    // output columns per thread
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* Qs = smem + L::q;
  float* Ks = smem + L::k;
  float* Vs = smem + L::v;
  float* Ps = smem + L::p;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int kvh = (bh % Hq) / (Hq / Hkv);
  const int qt = causal ? (int)(gridDim.x - 1 - blockIdx.x) : (int)blockIdx.x;
  const int q0 = qt * BQ;
  const size_t kv_base = ((size_t)b * Hkv + kvh) * Sk * D;
  const T* kb = k + kv_base;
  const T* vb = v + kv_base;

  load_tile<T, D>(Qs, q + (size_t)bh * Sq * D, q0, Sq);

  // the key tiles any row of this query tile can see
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + BQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt_begin = k_lo / BK;
  const int kt_end = (k_hi + BK - 1) / BK;

  float m_i[4], l_i[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.0f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.0f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                 // the last tile's K, V and P are consumed
    load_tile<T, D>(Ks, kb, k0, Sk);
    load_tile<T, D>(Vs, vb, k0, Sk);
    __syncthreads();

    // s = q·kᵀ for rows ty+16i, keys tx+16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * P + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bk[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * P + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fma4(a[i], bk[j], s[i][j]);
    }

    // mask, online softmax, P into shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      bool vis[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        vis[j] = c < Sk && (!causal || r >= c) && (window <= 0 || r - c < window);
        s[i][j] = vis[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = vis[j] ? expf(s[i][j] - m_new) : 0.0f;
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * PK + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // acc += P·V for rows ty+16i, columns tx+16n
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * PK + kk]);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int col = tx + 16 * n;
        const float4 vc =
            make_float4(Vs[(kk + 0) * P + col], Vs[(kk + 1) * P + col],
                        Vs[(kk + 2) * P + col], Vs[(kk + 3) * P + col]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][n] = fma4(pr[i], vc, acc[i][n]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float safe_l = l_i[i] > 0.0f ? l_i[i] : 1.0f;
    T* orow = o + ((size_t)bh * Sq + r) * D;
#pragma unroll
    for (int n = 0; n < NC; ++n) store1(orow + tx + 16 * n, acc[i][n] / safe_l);
    if (tx == 0) lse[(size_t)bh * Sq + r] = m_i[i] + logf(safe_l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                   int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)(B * Hq));
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, Hq, Hkv, Sq,
      Sk, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the forward on `stream` and returns cudaGetLastError() right
// after the launch (cudaSuccess and no launch when Sq or B·Hq is 0).
// Shapes: q (B, Hq, Sq, D); k, v (B, Hkv, Sk, D), contiguous and 16-byte
// aligned, Hq % Hkv == 0, B·Hq <= 65535; o like q; lse (B, Hq, Sq) float32.
// dtype 0 = float32, 1 = bfloat16 (o has q's type); D is 64 or 128;
// window <= 0 means no window.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int Hq, int Hkv,
                               int Sq, int Sk, int D, int dtype, int causal,
                               int window, float scale, void* stream) {
  if (Sq <= 0 || B * Hq <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  using Launch = cudaError_t (*)(const void*, const void*, const void*, void*,
                                 void*, int, int, int, int, int, int, int,
                                 float, cudaStream_t);
  Launch fn = nullptr;
  if (dtype == 0 && D == 64) fn = launch<float, 64>;
  if (dtype == 0 && D == 128) fn = launch<float, 128>;
  if (dtype == 1 && D == 64) fn = launch<__nv_bfloat16, 64>;
  if (dtype == 1 && D == 128) fn = launch<__nv_bfloat16, 128>;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)fn(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal, window, scale,
                 (cudaStream_t)stream);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
