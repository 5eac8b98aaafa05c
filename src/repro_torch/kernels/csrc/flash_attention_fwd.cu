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
// operations, and by the tensor cores' rate once they do the products.
//
// Two instantiations, chosen by dtype.
//
// bfloat16: tensor cores (flash_fwd_tc_kernel). Numerics, the contract
// that keeps what the TPU kernel computes: q·kᵀ is one bf16 mma.sync pass
// (exact products of bf16 values summed in float32). P stays float32 and
// enters P·V as the unevaluated sum hi + lo of two bf16 values, hi =
// bf16(p), lo = bf16(p - hi) (flash_mma.cuh): |p - (hi + lo)| ≤ 2⁻¹⁷·p,
// far below the one bf16 rounding of o that the plain version applies too,
// and P·V = hi·V + lo·V, two exact passes into float32 accumulators. P is
// never rounded to one bf16 value (what SDPA does and the TPU kernel does
// not). The row sum l is taken over the same hi + lo, by the tensor cores:
// one more n-tile of the P·V product against a column of ones, so for
// v = 1 every column of acc equals l bit for bit and o = acc / l = 1.
// That is 3 bf16 passes for 2 products (plus the ones column, 1/8 of a
// P·V pass at D = 64): 1.5× the tensor work that the bound counts.
// Design: grid (B·Hq, ceil(Sq/128)), heaviest query tiles first under
// causal masking (blockIdx.y counts from the last tile, so every head's
// diagonal-heavy tiles are scheduled before any light one). A block of 8
// warps owns 128 query rows of one (batch, q head); warp w owns rows
// 16w..16w+15 and keeps their q fragments in registers for the whole key
// loop (at D ≤ 128; see D = 256 below). 64-key K/V tiles stream through a
// ring of 3 stages (D = 64; 2 at D = 128 and 256) in shared memory, loaded with cp.async, so the next tiles' loads
// overlap this tile's products. Per tile a warp computes S = q·kᵀ (16 × 64,
// mma.sync m16n8k16, K read with ldmatrix), masks it only where the tile
// straddles the causal diagonal, the window or Sk, updates the online
// softmax (row max by two shuffles within the 4 lanes of a row), splits P
// in registers and feeds the S accumulators straight back as the A
// operand of P·V (V read with ldmatrix.trans), with no shared-memory round
// trip for P. o is written once through shared memory in 16-byte stores.
// The ring uses cp.async and wait_group, not TMA and mbarriers, and the
// products are mma.sync, not wgmma: wgmma is the next step.
// At D = 256 (gemma-2b) a warp's o accumulators alone are 128 float32
// registers a thread, so q's fragments are not kept for the key loop (64
// more registers would pass the 255 a thread allows): each k-step of
// q·kᵀ reads them again from the q tile with ldmatrix. The ring then holds
// 2 stages, (128 + 2·2·64)·264·2 B = 202,752 B, one block an SM.
//
// float32: CUDA cores (flash_fwd_kernel). Every product is a float32 FMA
// (67 TFLOP/s peak, so at least ~2 ms at the prefill's shapes), operands in
// shared memory, so it is bound by the FMA rate and shared-memory load
// bandwidth. No measured path runs float32 attention; the float32 checks
// run through it. Design: grid (ceil(Sq/64), B·Hq); one block of 256
// threads owns 64 query rows of one (batch, head) and loops over the 64-key
// tiles that the causal limit and the window admit (tiles wholly outside
// are never loaded). Under causal masking the heaviest query tiles are
// launched first. q, k and v tiles are converted to float32 into shared
// memory (row pitch D+4 floats: 16-byte aligned rows, conflict-free float4
// reads across a quarter warp). Thread (ty, tx) holds rows ty+16i and key
// columns tx+16j (i, j < 4) of the score tile and output columns tx+16n
// (n < D/16); the 16 threads that share a row sit in one half warp, so the
// row max and sum are shuffles. The running (m, l, acc) stay in registers
// for the whole key loop; P goes through shared memory for the P·V product.
// Shared memory is (3·64·(D+4) + 64·68)·4 B: 217,088 B at D = 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;
constexpr int PK = BK + 4;     // pitch of the P tile's rows (floats)
using flash_mma::NEG_INF;

template <int D>
struct Smem {
  static constexpr int P = D + 4;               // pitch of q/k/v rows
  static constexpr int q = 0;
  static constexpr int k = q + BQ * P;
  static constexpr int v = k + BK * P;
  static constexpr int p = v + BK * P;
  static constexpr size_t bytes = (size_t)(p + BQ * PK) * sizeof(float);
  static_assert(bytes <= 232448, "over the 227 KB a block may use");
};

__device__ __forceinline__ float4 load4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}

__device__ __forceinline__ void store1(float* dst, float x) { *dst = x; }

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

// ---- bfloat16 on the tensor cores -----------------------------------------

namespace fm = flash_mma;
using fm::bf16;

namespace tc {

constexpr int BQ = 128;        // query rows per block: 8 warps × 16
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;

// Shared memory, in bf16 elements: the q tile, then the K/V ring (stage s
// holds k at kv + 2·s·BK·P and v BK·P after it); rows of pitch D + 8.
template <int D>
struct Smem {
  static constexpr int P = D + 8;
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr int MIN_BLOCKS = D == 64 ? 2 : 1;   // blocks an SM
  static constexpr bool QREG = D <= 128;        // q's fragments in registers
  static constexpr int q = 0;
  static constexpr int kv = BQ * P;
  static constexpr size_t bytes =
      (size_t)(kv + STAGES * 2 * BK * P) * sizeof(bf16);
  static_assert(bytes <= 232448, "over the 227 KB a block may use");
};

template <int D>
__global__ void __launch_bounds__(THREADS, Smem<D>::MIN_BLOCKS)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
                    int causal, int window, float scale) {
  using L = Smem<D>;
  constexpr int P = L::P;
  constexpr int ST = L::STAGES;
  constexpr int KD = D / 16;                    // k-steps of q·kᵀ
  constexpr int NS = BK / 8;                    // n-tiles of S
  constexpr int NO = D / 8;                     // n-tiles of o
  extern __shared__ float4 smem_f4[];
  bf16* smem = reinterpret_cast<bf16*>(smem_f4);
  bf16* Qs = smem + L::q;

  const int lane = threadIdx.x & 31;
  const int w0 = (threadIdx.x >> 5) * 16;       // the warp's first row
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int kvh = (bh % Hq) / (Hq / Hkv);
  const int qt = causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y;
  const int q0 = qt * BQ;
  const size_t kv_base = ((size_t)b * Hkv + kvh) * Sk * D;
  const bf16* kb = k + kv_base;
  const bf16* vb = v + kv_base;

  // the key tiles any row of this query tile can see
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + BQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt0 = k_lo / BK;
  const int n_tiles = k_lo < k_hi ? (k_hi + BK - 1) / BK - kt0 : 0;

  auto load_kv = [&](int i) {
    bf16* Ks = smem + L::kv + (i % ST) * 2 * BK * P;
    fm::cp_tile<D, BK, THREADS>(Ks, kb, (kt0 + i) * BK, Sk);
    fm::cp_tile<D, BK, THREADS>(Ks + BK * P, vb, (kt0 + i) * BK, Sk);
  };
  // group s holds tile s (and group 0 the q tile)
  if (n_tiles > 0) fm::cp_tile<D, BQ, THREADS>(Qs, q + (size_t)bh * Sq * D, q0, Sq);
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < n_tiles) load_kv(s);
    fm::cp_async_commit();
  }

  const int r0 = q0 + w0 + g;                   // rows r0 and r0 + 8
  const float sl2 = scale * fm::LOG2E;          // scores in log2 units
  uint32_t qf[L::QREG ? KD : 1][4];
  float acc[NO][4], lacc[4] = {0.f, 0.f, 0.f, 0.f};
  float m0 = fm::NEG_INF, m1 = fm::NEG_INF;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    fm::cp_async_wait<ST - 2>();                // tile i has landed
    __syncthreads();                            // ... for every thread; tile i-1 consumed
    if (i + ST - 1 < n_tiles) load_kv(i + ST - 1);
    fm::cp_async_commit();
    if constexpr (L::QREG) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          fm::ldsm_x4(qf[kk], Qs + (w0 + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8);
      }
    }
    const bf16* Ks = smem + L::kv + (i % ST) * 2 * BK * P;
    const bf16* Vs = Ks + BK * P;
    const int k0 = (kt0 + i) * BK;
    // a tile none of this warp's rows can see leaves its state as it is
    if ((causal && k0 > q0 + w0 + 15) ||
        (window > 0 && q0 + w0 - (k0 + BK - 1) >= window))
      continue;

    // S = q·kᵀ: n-tile j holds keys k0 + 8j .. + 7
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qk[4];
      if constexpr (L::QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qk[e] = qf[kk][e];
      } else {
        fm::ldsm_x4(qk, Qs + (w0 + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t kf[4];
        fm::ldsm_x4(kf, Ks + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * P +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        fm::mma(s[2 * jp], qk, kf[0], kf[1]);
        fm::mma(s[2 * jp + 1], qk, kf[2], kf[3]);
      }
    }

    // mask (only a tile that straddles the diagonal, the window or Sk),
    // online softmax in log2 units
    const bool full = k0 + BK <= Sk && (!causal || k0 + BK - 1 <= q0 + w0) &&
                      (window <= 0 || q0 + w0 + 15 - k0 < window);
    float mx0 = fm::NEG_INF, mx1 = fm::NEG_INF;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = k0 + 8 * j + 2 * t + e;
        float x0 = s[j][e] * sl2, x1 = s[j][2 + e] * sl2;
        if (!full) {
          if (!fm::visible(r0, c, Sq, Sk, causal, window)) x0 = fm::NEG_INF;
          if (!fm::visible(r0 + 8, c, Sq, Sk, causal, window)) x1 = fm::NEG_INF;
        }
        s[j][e] = x0;
        s[j][2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    // a row with nothing visible yet subtracts 0, so its masked
    // NEG_INF entries give p = 0, never exp(0)
    const float u0 = mn0 == fm::NEG_INF ? 0.f : mn0;
    const float u1 = mn1 == fm::NEG_INF ? 0.f : mn1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = exp2f(s[j][0] - u0);
      s[j][1] = exp2f(s[j][1] - u0);
      s[j][2] = exp2f(s[j][2] - u1);
      s[j][3] = exp2f(s[j][3] - u1);
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
    lacc[0] *= a0;
    lacc[1] *= a0;
    lacc[2] *= a1;
    lacc[3] *= a1;

    // acc += P·V and l += P·1, P = hi + lo
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      fm::split_a(s[2 * kk], s[2 * kk + 1], hi, lo);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        fm::ldsm_x4_t(vf, Vs + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * P +
                              dp * 16 + ((lane >> 4) << 3));
        fm::mma(acc[2 * dp], hi, vf[0], vf[1]);
        fm::mma(acc[2 * dp], lo, vf[0], vf[1]);
        fm::mma(acc[2 * dp + 1], hi, vf[2], vf[3]);
        fm::mma(acc[2 * dp + 1], lo, vf[2], vf[3]);
      }
      fm::mma(lacc, hi, fm::BF16_ONES, fm::BF16_ONES);
      fm::mma(lacc, lo, fm::BF16_ONES, fm::BF16_ONES);
    }
  }
  fm::cp_async_wait<0>();

  // o = acc / l through this warp's rows of the q tile (read by no other
  // warp), then out in 16-byte stores; lse = m + log l
  const float l0 = lacc[0] > 0.f ? lacc[0] : 1.f;
  const float l1 = lacc[2] > 0.f ? lacc[2] : 1.f;
  bf16* Os = Qs + w0 * P;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(Os + g * P + 8 * n + 2 * t) =
        __floats2bfloat162_rn(acc[n][0] / l0, acc[n][1] / l0);
    *reinterpret_cast<__nv_bfloat162*>(Os + (g + 8) * P + 8 * n + 2 * t) =
        __floats2bfloat162_rn(acc[n][2] / l1, acc[n][3] / l1);
  }
  __syncwarp();
#pragma unroll
  for (int idx = lane; idx < 16 * (D / 8); idx += 32) {
    const int r = idx / (D / 8);
    const int c = (idx % (D / 8)) * 8;
    if (q0 + w0 + r < Sq)
      *reinterpret_cast<uint4*>(o + ((size_t)bh * Sq + q0 + w0 + r) * D + c) =
          *reinterpret_cast<const uint4*>(Os + r * P + c);
  }
  if (t == 0) {
    float* lrow = lse + (size_t)bh * Sq;
    if (r0 < Sq) lrow[r0] = (m0 == fm::NEG_INF ? fm::NEG_INF : m0 * fm::LN2) + logf(l0);
    if (r0 + 8 < Sq)
      lrow[r0 + 8] = (m1 == fm::NEG_INF ? fm::NEG_INF : m1 * fm::LN2) + logf(l1);
  }
}

// The kernel's dynamic shared memory above the 48 KB default.
template <int D>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(flash_fwd_tc_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Smem<D>::bytes);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                   int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = allow_smem<D>();
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Sq + BQ - 1) / BQ));
  flash_fwd_tc_kernel<D><<<grid, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      Hq, Hkv, Sq, Sk, causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t info(int* smem_bytes, int* blocks_per_sm) {
  cudaError_t err = allow_smem<D>();
  if (err != cudaSuccess) return err;
  *smem_bytes = (int)Smem<D>::bytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_fwd_tc_kernel<D>, THREADS, Smem<D>::bytes);
}

}  // namespace tc

}  // namespace

extern "C" {

// Launches the forward on `stream` and returns cudaGetLastError() right
// after the launch (cudaSuccess and no launch when Sq or B·Hq is 0).
// Shapes: q (B, Hq, Sq, D); k, v (B, Hkv, Sk, D), contiguous and 16-byte
// aligned, Hq % Hkv == 0, B·Hq <= 65535; o like q; lse (B, Hq, Sq) float32.
// dtype 0 = float32, 1 = bfloat16 (o has q's type); D is 64, 128 or 256;
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
  if (dtype == 0 && D == 256) fn = launch<float, 256>;
  if (dtype == 1 && D == 64) fn = tc::launch<64>;
  if (dtype == 1 && D == 128) fn = tc::launch<128>;
  if (dtype == 1 && D == 256) fn = tc::launch<256>;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)fn(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal, window, scale,
                 (cudaStream_t)stream);
}

// The bfloat16 kernel's dynamic shared memory and resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) for head_dim D.
int flash_attention_fwd_info(int D, int* smem_bytes, int* blocks_per_sm) {
  if (D == 64) return (int)tc::info<64>(smem_bytes, blocks_per_sm);
  if (D == 128) return (int)tc::info<128>(smem_bytes, blocks_per_sm);
  if (D == 256) return (int)tc::info<256>(smem_bytes, blocks_per_sm);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
