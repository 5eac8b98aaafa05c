// Flash-attention backward for Hopper (sm_90a): dq, and dk/dv, of
// online-softmax attention with causal masking, a sliding window and
// grouped-query heads, from the forward's logsumexp.
//
// Four kernels, two for each TPU kernel of the JAX package's
// kernels/flash_attention.py (reached there through flash_attention_bwd ->
// the custom_vjp of ops.flash_attention -> jax.value_and_grad(Model.loss)
// on the training path):
//   flash_bwd_dq_tc_kernel (bf16) and flash_bwd_dq_kernel (float32)
//     replace _bwd_dq_kernel (line 151): dq;
//   flash_bwd_dkv_tc_kernel (bf16) and flash_bwd_dkv_kernel (float32)
//     replace _bwd_dkv_kernel (line 180): dk and dv.
// Both compute, for each visible (query i, key j) pair, what the TPU
// kernels compute:
//   s  = (q_i·k_j)·scale in float32,  p = exp(s - lse_i),
//   dp = do_i·v_j,                    ds = p·(dp - delta_i)·scale,
// with delta_i = Σ_d do_i·o_i (float32, computed by the wrapper, as the
// JAX wrapper computes it outside its kernels), and then
//   dq_i = Σ_j ds·k_j,   dk_j = Σ_i ds·q_i,   dv_j = Σ_i p·do_i,
// every sum in float32, each output rounded once to the inputs' type.
// Key j is visible from query i iff j < Sk, i < Sq, (not causal or
// j <= i) and (no window or i - j < window). A masked pair gives p = 0 by
// selection, never by a product with the mask: a row with nothing visible
// has lse = NEG_INF + log 1 from the forward, where exp(s - lse) would
// overflow; such a row gets zero gradients.
//
// Differences from the TPU kernels, on purpose:
// - dk/dv are summed over each kv head's group of q heads inside the
//   kernel. The JAX wrapper writes (B, Hq, Sk, D) float32 per q head and
//   group-sums it afterwards (flash_attention.py:270-277); here one block
//   owns a key tile of one kv head and loops over the group's q heads, so
//   no (B, Hq, Sk, D) intermediate exists and no atomics are needed: the
//   result is deterministic. It is the same function summed in another
//   order.
// - Ragged edges are masked. The JAX wrapper floors n_q and n_k to whole
//   blocks; here any Sq and Sk work (rows past Sq or Sk are zero-filled in
//   shared memory, masked and never stored).
//
// What bounds them on this card. At the training step's shapes (B=4,
// Hq=32, Hkv=8, S=2048, D=64, bf16, causal) there are B·Hq·S(S+1)/2 ≈
// 2.69e8 visible pairs, 2·D operations each per product: dq does three
// products (s, dp, dq: 1.03e11 operations, 0.104 ms at the bf16
// tensor-core peak of 989 TFLOP/s), dk/dv four (s, dp, dv, dk: 1.37e11,
// 0.139 ms), against ~0.1 GB of q/k/v/do/lse/delta read and gradients
// written (~0.03 ms at 3.35 TB/s): both are bound by operations.
//
// dk/dv in bfloat16: tensor cores (flash_bwd_dkv_tc_kernel). Numerics, the
// contract that keeps what the TPU kernel computes: Sᵀ = k·qᵀ and dPᵀ =
// v·doᵀ are one bf16 mma.sync pass each (exact products of bf16 values
// summed in float32). P and dS stay float32 and are never rounded to one
// bf16 value: each enters the second products as the unevaluated sum
// hi + lo of two bf16 values, hi = bf16(x), lo = bf16(x - hi)
// (flash_mma.cuh), |x - (hi + lo)| ≤ 2⁻¹⁷·|x|, far below the one bf16
// rounding of dk and dv that the plain version applies too; dV += Pᵀ·dO =
// hiᵀ·dO + loᵀ·dO and dK += dSᵀ·Q = hiᵀ·Q + loᵀ·Q, every pass exact into
// float32 accumulators. 6 bf16 passes for 4 products: 1.5× the tensor
// work that the bound counts.
// Design: grid (B·Hkv, ceil(Sk/64)[, 2 at D = 256]), the earliest (heaviest under causal
// masking) key tiles of every head first. A block of 4 warps owns 64 keys
// of one kv head (warp w owns keys 16w..16w+15) and loops over the group's
// q heads and, for each, the query tiles that can see its keys (64 rows at
// D = 64, 32 at D = 128 and 256), so dk/dv come out group-summed,
// deterministic, with no atomics. At D = 256 (gemma-2b) dk and dv in
// registers would be 2·(D/8)·4 = 256 float32 a thread, more than the
// register file gives one: the grid gains a third axis, the half of the
// head dim whose dk/dv columns a block owns. Both halves of a key tile
// compute the same Sᵀ and dPᵀ over all 256 dims (so those two products
// run twice), and each sums its own 128 columns of dV += Pᵀ·dO and
// dK += dSᵀ·Q over the whole group, as at D = 128: the sum over the group
// and its order are those of the unsplit kernel, and no column is added
// by two blocks. Q, dO, lse and delta tiles stream through a 2-stage
// ring in shared memory, loaded with cp.async, so the next tile's loads
// overlap this tile's products. Per tile a warp computes the transposed
// scores with the key dimension as M (k and v fragments by ldmatrix, q and
// do as the B operand by ldmatrix), then Pᵀ = exp(Sᵀ - lse) and dSᵀ =
// Pᵀ∘(dPᵀ - delta)·scale in the accumulator fragments (lse and delta per
// column from shared memory; masked only where the tile straddles the
// diagonal, the window, Sq or Sk), splits them in registers and feeds them
// straight back as the A operand of dV += Pᵀ·dO and dK += dSᵀ·Q, with q and
// do read through the transposing ldmatrix. dk and dv stay in float32
// registers for the whole loop and are written once through shared memory
// in 16-byte stores. cp.async and mma.sync, not TMA and wgmma: wgmma is
// the next step.
//
// dq in bfloat16: tensor cores (flash_bwd_dq_tc_kernel). Numerics, the
// contract dk/dv keeps: S = q·kᵀ and dP = do·vᵀ are one bf16 mma.sync pass
// each; dS stays float32 and enters dq += dS·k as hi + lo (|dS - (hi +
// lo)| ≤ 2⁻¹⁷·|dS|), two exact passes into float32 accumulators, and dq is
// rounded once, to bf16, at the end. 4 bf16 passes for 3 products: 4/3 of
// the tensor work the bound counts (1.375e11 operations at the training
// step's shapes, 0.139 ms at the bf16 peak). What bounds it then is the
// rate mma.sync reaches (on an H100 at 700 W it executes ~200 TFLOP/s of
// that split work, the bf16 forward and dk/dv kernels 243–275, a fifth to
// a quarter of the peak) and, beside the products, the per-pair exp2, mask
// and split on the CUDA cores.
// Design: grid (B·Hq, ceil(Sq/64)), heaviest query tiles first under causal
// masking (blockIdx.y counts from the last tile). A block of 4 warps owns
// 64 query rows of one q head (warp w owns rows 16w..16w+15) and keeps
// their q and do fragments in registers for the whole loop over the key
// tiles of its kv head that the causal limit and the window admit (64 keys
// a tile at D = 64, 32 at D = 128 and 256, so that the float32 S, dP and
// dq accumulators fit the register file). At D = 256 dq alone takes 128
// registers a thread and the q and do fragments would take 128 more, so
// each k-step of S and dP reads them again from the tiles with ldmatrix. K/V tiles stream through a 3-stage
// cp.async ring. Per tile a warp computes S and dP with the query dimension
// as M (k and v as B operands by ldmatrix), then P = exp2(S·scale·log2e -
// lse·log2e) and dS = P∘(dP - delta)·scale in the accumulator fragments
// (lse and delta per row in registers, rows g and g + 8 of the warp; masked
// only where the tile straddles the diagonal, the window, Sq or Sk), splits
// dS in registers and feeds it straight back as the A operand of dq +=
// dS·k, with k read through the transposing ldmatrix: dS never goes
// through shared memory. dq stays in float32 registers for the whole loop
// and is written once, in bf16, through shared memory in 16-byte stores.
//
// float32 (dq and dk/dv): CUDA cores. Every product is a float32 FMA
// (67 TFLOP/s peak) from operands in shared memory, so in practice they
// are bound by the FMA rate and shared-memory bandwidth, well above the
// tensor-core bound. No measured path runs float32 attention; the float32
// checks run through these. Design: 256 threads a block, 64×64 tiles
// (32×32 at D = 256: four 64-row tiles of pitch 260 floats and the score
// tiles would need ~300 KB of shared memory, over the 227 KB a block may
// use), operands converted to float32 in shared memory with row pitch D+4
// (16-byte aligned rows, conflict-free float4 reads across a quarter
// warp), as in flash_attention_fwd.cu. Thread (ty, tx) holds rows ty+16i
// and columns tx+16j (i, j < 4; < 2 at D = 256) of a score tile and output columns
// tx+16n (n < D/16); p or ds goes through shared memory for the second
// product.
// - dq: grid (ceil(Sq/N), B·Hq) with N = 64 (32 at D = 256); a block
//   owns N query rows of one q head and loops over the key tiles of its
//   kv head that the causal limit and the window admit (tiles wholly
//   outside are never loaded),
//   heaviest query tiles first under causal masking. dq stays in float32
//   registers for the whole loop and is written once.
// - dk/dv: grid (ceil(Sk/N), B·Hkv); a block owns N keys of one kv
//   head and loops over the group's q heads and, for each, the query
//   tiles that can see its keys, heaviest key tiles first under causal
//   masking. dk and dv stay in float32 registers and are written once in
//   (B, Hkv, Sk, D).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

constexpr int THREADS = 256;

// The float32 kernels' tiles: N query rows and N keys (N = 16·R; thread
// (ty, tx) holds rows ty+16i and columns tx+16j, i, j < R, of an N×N score
// tile). N is 64, or 32 at D = 256, where four 64-row tiles of pitch 260
// would pass the 227 KB of shared memory a block may use.
template <int D>
struct Tile {
  static constexpr int R = D == 256 ? 2 : 4;
  static constexpr int N = 16 * R;
  static constexpr int PT = N + 4;              // pitch of a score tile's rows
  static constexpr int P = D + 4;               // pitch of q/k/v/do rows
};

// dq kernel's shared memory: q, do, k, v tiles and the ds tile.
template <int D>
struct SmemDq {
  static constexpr int P = Tile<D>::P;
  static constexpr int BQ = Tile<D>::N, BK = Tile<D>::N, PT = Tile<D>::PT;
  static constexpr int q = 0;
  static constexpr int dO = q + BQ * P;
  static constexpr int k = dO + BQ * P;
  static constexpr int v = k + BK * P;
  static constexpr int ds = v + BK * P;
  static constexpr size_t bytes = (size_t)(ds + BQ * PT) * sizeof(float);
  static_assert(bytes <= 232448, "over the 227 KB a block may use");
};

// dk/dv kernel's shared memory: k, v, q, do tiles, the transposed p and ds
// tiles, and the q tile's lse and delta.
template <int D>
struct SmemDkv {
  static constexpr int P = Tile<D>::P;
  static constexpr int BQ = Tile<D>::N, BK = Tile<D>::N, PT = Tile<D>::PT;
  static constexpr int k = 0;
  static constexpr int v = k + BK * P;
  static constexpr int q = v + BK * P;
  static constexpr int dO = q + BQ * P;
  static constexpr int pt = dO + BQ * P;
  static constexpr int dst = pt + BK * PT;
  static constexpr int lse = dst + BK * PT;
  static constexpr int delta = lse + BQ;
  static constexpr size_t bytes = (size_t)(delta + BQ) * sizeof(float);
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

// Rows [row0, row0 + N) of a row-major (n_rows, D) matrix into shared
// memory as float32 with pitch D+4; rows at or past n_rows are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int n_rows) {
  constexpr int P = Tile<D>::P;
  constexpr int V4 = D / 4;
  for (int c = threadIdx.x; c < Tile<D>::N * V4; c += THREADS) {
    const int r = c / V4;
    const int d = (c % V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) x = load4(src + (size_t)(row0 + r) * D + d);
    *reinterpret_cast<float4*>(&dst[r * P + d]) = x;
  }
}

// out[i][j] = A[ty+16i] · B[tx+16j] over D, for two N-row tiles in
// shared memory with pitch D+4.
template <int D>
__device__ __forceinline__ void tile_dot(float out[Tile<D>::R][Tile<D>::R],
                                         const float* A, const float* Bm,
                                         int ty, int tx) {
  constexpr int P = Tile<D>::P;
  constexpr int R = Tile<D>::R;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) out[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[R], b[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      a[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * P + d]);
#pragma unroll
    for (int j = 0; j < R; ++j)
      b[j] = *reinterpret_cast<const float4*>(&Bm[(tx + 16 * j) * P + d]);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) out[i][j] = fma4(a[i], b[j], out[i][j]);
  }
}

// acc[i][n] += Σ_kk S[ty+16i][kk] · M[kk][tx+16n]: an N×N score tile (pitch
// PT) times an N×D operand tile (pitch D+4), both in shared memory.
template <int D>
__device__ __forceinline__ void tile_mma(float acc[Tile<D>::R][D / 16],
                                         const float* S, const float* M,
                                         int ty, int tx) {
  constexpr int P = Tile<D>::P;
  constexpr int R = Tile<D>::R;
  constexpr int PT = Tile<D>::PT;
  constexpr int NC = D / 16;
#pragma unroll 2
  for (int kk = 0; kk < Tile<D>::N; kk += 4) {
    float4 sr[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      sr[i] = *reinterpret_cast<const float4*>(&S[(ty + 16 * i) * PT + kk]);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = tx + 16 * n;
      const float4 mc =
          make_float4(M[(kk + 0) * P + col], M[(kk + 1) * P + col],
                      M[(kk + 2) * P + col], M[(kk + 3) * P + col]);
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i][n] = fma4(sr[i], mc, acc[i][n]);
    }
  }
}

using flash_mma::visible;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Hq, int Hkv, int Sq, int Sk, int causal, int window,
                    float scale) {
  using L = SmemDq<D>;
  constexpr int NC = D / 16;
  constexpr int R = Tile<D>::R, BQ = L::BQ, BK = L::BK, PT = L::PT;
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* Qs = smem + L::q;
  float* DOs = smem + L::dO;
  float* Ks = smem + L::k;
  float* Vs = smem + L::v;
  float* DSs = smem + L::ds;

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
  load_tile<T, D>(DOs, dout + (size_t)bh * Sq * D, q0, Sq);
  float lse_i[R], delta_i[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_i[i] = r < Sq ? lse[(size_t)bh * Sq + r] : 0.0f;
    delta_i[i] = r < Sq ? delta[(size_t)bh * Sq + r] : 0.0f;
  }

  // the key tiles any row of this query tile can see
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + BQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt_begin = k_lo / BK;
  const int kt_end = (k_hi + BK - 1) / BK;

  float acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.0f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                 // the last tile's K, V and ds are consumed
    load_tile<T, D>(Ks, kb, k0, Sk);
    load_tile<T, D>(Vs, vb, k0, Sk);
    __syncthreads();

    float s[R][R], dp[R][R];
    tile_dot<D>(s, Qs, Ks, ty, tx);             // rows ty+16i, keys tx+16j
    tile_dot<D>(dp, DOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int c = k0 + tx + 16 * j;
        const float p = visible(r, c, Sq, Sk, causal, window)
                            ? expf(s[i][j] * scale - lse_i[i])
                            : 0.0f;
        DSs[(ty + 16 * i) * PT + tx + 16 * j] =
            p * (dp[i][j] - delta_i[i]) * scale;
      }
    }
    __syncthreads();
    tile_mma<D>(acc, DSs, Ks, ty, tx);          // dq += ds·k
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    T* row = dq + ((size_t)bh * Sq + r) * D;
#pragma unroll
    for (int n = 0; n < NC; ++n) store1(row + tx + 16 * n, acc[i][n]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Hq, int Hkv, int Sq, int Sk,
                     int causal, int window, float scale) {
  using L = SmemDkv<D>;
  constexpr int NC = D / 16;
  constexpr int R = Tile<D>::R, BQ = L::BQ, BK = L::BK, PT = L::PT;
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* Ks = smem + L::k;
  float* Vs = smem + L::v;
  float* Qs = smem + L::q;
  float* DOs = smem + L::dO;
  float* PTs = smem + L::pt;
  float* DSTs = smem + L::dst;
  float* LSEs = smem + L::lse;
  float* DELs = smem + L::delta;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bkv = blockIdx.y;                   // b·Hkv + kv head
  const int b = bkv / Hkv;
  const int kvh = bkv % Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.x * BK;               // heaviest (earliest) first
  const size_t kv_base = (size_t)bkv * Sk * D;

  load_tile<T, D>(Ks, k + kv_base, k0, Sk);
  load_tile<T, D>(Vs, v + kv_base, k0, Sk);

  // the query tiles that can see any key of this tile
  int q_lo = 0, q_hi = Sq;
  if (causal) q_lo = k0;
  if (window > 0) q_hi = min(Sq, k0 + BK - 1 + window);
  const int qt_begin = q_lo / BQ;
  const int qt_end = q_lo < q_hi ? (q_hi + BQ - 1) / BQ : qt_begin;

  float dk_acc[R][NC], dv_acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      dk_acc[i][n] = 0.0f;
      dv_acc[i][n] = 0.0f;
    }

  for (int g = 0; g < group; ++g) {
    const size_t bh = (size_t)b * Hq + kvh * group + g;
    const T* qb = q + bh * Sq * D;
    const T* dob = dout + bh * Sq * D;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();               // the last tile's Q, dO, pᵀ, dsᵀ are consumed
      load_tile<T, D>(Qs, qb, q0, Sq);
      load_tile<T, D>(DOs, dob, q0, Sq);
      if (threadIdx.x < BQ) {
        const int r = q0 + threadIdx.x;
        LSEs[threadIdx.x] = r < Sq ? lse[bh * Sq + r] : 0.0f;
        DELs[threadIdx.x] = r < Sq ? delta[bh * Sq + r] : 0.0f;
      }
      __syncthreads();

      // transposed tiles: keys ty+16i, queries tx+16j
      float st[R][R], dpt[R][R];
      tile_dot<D>(st, Ks, Qs, ty, tx);
      tile_dot<D>(dpt, Vs, DOs, ty, tx);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int qc = tx + 16 * j;
        const int r = q0 + qc;
        const float lse_r = LSEs[qc];
        const float del_r = DELs[qc];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int c = k0 + ty + 16 * i;
          const float p = visible(r, c, Sq, Sk, causal, window)
                              ? expf(st[i][j] * scale - lse_r)
                              : 0.0f;
          PTs[(ty + 16 * i) * PT + qc] = p;
          DSTs[(ty + 16 * i) * PT + qc] = p * (dpt[i][j] - del_r) * scale;
        }
      }
      __syncthreads();
      tile_mma<D>(dv_acc, PTs, DOs, ty, tx);    // dv += pᵀ·do
      tile_mma<D>(dk_acc, DSTs, Qs, ty, tx);    // dk += dsᵀ·q
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= Sk) continue;
    T* dkr = dk + kv_base + (size_t)c * D;
    T* dvr = dv + kv_base + (size_t)c * D;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      store1(dkr + tx + 16 * n, dk_acc[i][n]);
      store1(dvr + tx + 16 * n, dv_acc[i][n]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int Hq, int Hkv, int Sq, int Sk,
                      int causal, int window, float scale,
                      cudaStream_t stream) {
  const size_t smem = SmemDq<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int BQ = SmemDq<D>::BQ;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)(B * Hq));
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, Hq, Hkv, Sq, Sk, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int Hq, int Hkv, int Sq,
                       int Sk, int causal, int window, float scale,
                       cudaStream_t stream) {
  const size_t smem = SmemDkv<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int BK = SmemDkv<D>::BK;
  const dim3 grid((unsigned)((Sk + BK - 1) / BK), (unsigned)(B * Hkv));
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, Hq, Hkv, Sq, Sk,
      causal, window, scale);
  return cudaGetLastError();
}

// ---- dk/dv in bfloat16 on the tensor cores --------------------------------

namespace fm = flash_mma;
using fm::bf16;

namespace tc {

constexpr int BKV = 64;        // keys per block: 4 warps × 16
constexpr int THREADS = 128;
constexpr int STAGES = 2;

// Shared memory: k and v tiles (bf16, pitch D + 8), then the ring of q/do
// tiles (stage s: q at ring + 2·s·BQ·P, do BQ·P after it), then lse and
// delta of each stage (float32, lse at stat + 2·s·BQ, delta BQ after it).
template <int D>
struct Smem {
  static constexpr int P = D + 8;
  static constexpr int BQ = D == 64 ? 64 : 32;  // query rows per tile
  // dk/dv columns a block owns: all D, or half at D = 256, where dk and dv
  // in registers would be 256 float32 a thread (blockIdx.z picks the half)
  static constexpr int DH = D == 256 ? D / 2 : D;
  static constexpr int k = 0;
  static constexpr int v = BKV * P;
  static constexpr int ring = 2 * BKV * P;
  static constexpr size_t stat =
      (size_t)(ring + STAGES * 2 * BQ * P) * sizeof(bf16);
  static constexpr size_t bytes = stat + STAGES * 2 * BQ * sizeof(float);
  static_assert(bytes <= 232448, "over the 227 KB a block may use");
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int Hq, int Hkv, int Sq, int Sk,
                        int causal, int window, float scale) {
  using L = Smem<D>;
  constexpr int P = L::P;
  constexpr int BQ = L::BQ;
  constexpr int KD = D / 16;                    // k-steps of the score products
  constexpr int NS = BQ / 8;                    // n-tiles of Sᵀ, dPᵀ
  constexpr int DH = L::DH;
  constexpr int NO = DH / 8;                    // n-tiles of dk, dv
  extern __shared__ float4 smem_f4[];
  bf16* smem = reinterpret_cast<bf16*>(smem_f4);
  bf16* Ks = smem + L::k;
  bf16* Vs = smem + L::v;
  float* stats = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(smem_f4) + L::stat);

  const int lane = threadIdx.x & 31;
  const int w0 = (threadIdx.x >> 5) * 16;       // the warp's first key
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bkv = blockIdx.x;                   // b·Hkv + kv head
  const int b = bkv / Hkv;
  const int kvh = bkv % Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.y * BKV;              // heaviest (earliest) first
  const int col0 = blockIdx.z * DH;             // the block's dk/dv columns
  const size_t kv_base = (size_t)bkv * Sk * D;
  const int c0 = k0 + w0 + g;                   // keys c0 and c0 + 8

  // the query tiles that can see any key of this tile, for each q head
  int q_lo = 0, q_hi = Sq;
  if (causal) q_lo = k0;
  if (window > 0) q_hi = min(Sq, k0 + BKV - 1 + window);
  const int qt0 = q_lo / BQ;
  const int nq = q_lo < q_hi ? (q_hi + BQ - 1) / BQ - qt0 : 0;
  const int n_iter = group * nq;

  auto load_q = [&](int it) {
    const int s = it % STAGES;
    const size_t bh = (size_t)b * Hq + kvh * group + it / nq;
    const int q0 = (qt0 + it % nq) * BQ;
    bf16* Qs = smem + L::ring + s * 2 * BQ * P;
    fm::cp_tile<D, BQ, THREADS>(Qs, q + bh * Sq * D, q0, Sq);
    fm::cp_tile<D, BQ, THREADS>(Qs + BQ * P, dout + bh * Sq * D, q0, Sq);
    float* st = stats + s * 2 * BQ;
    for (int i = threadIdx.x; i < 2 * BQ; i += THREADS) {
      const int r = q0 + i % BQ;
      const float* src = (i < BQ ? lse : delta) + bh * Sq;
      fm::cp_async4(st + i, src + (r < Sq ? r : 0), r < Sq);
    }
  };
  // group 0 holds k, v and the first q tile; group i the q tile i
  if (n_iter > 0) {
    fm::cp_tile<D, BKV, THREADS>(Ks, k + kv_base, k0, Sk);
    fm::cp_tile<D, BKV, THREADS>(Vs, v + kv_base, k0, Sk);
    load_q(0);
  }
  fm::cp_async_commit();

  const float sl2 = scale * fm::LOG2E;          // scores in log2 units
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dka[n][e] = 0.f;
      dva[n][e] = 0.f;
    }

  for (int it = 0; it < n_iter; ++it) {
    fm::cp_async_wait<0>();                     // tile it has landed
    __syncthreads();                            // ... for every thread; tile it-1 consumed
    if (it + 1 < n_iter) load_q(it + 1);
    fm::cp_async_commit();
    const int s = it % STAGES;
    const bf16* Qs = smem + L::ring + s * 2 * BQ * P;
    const bf16* DOs = Qs + BQ * P;
    const float* LSEs = stats + s * 2 * BQ;
    const float* DELs = LSEs + BQ;
    const int q0 = (qt0 + it % nq) * BQ;
    // a tile that sees none of this warp's keys adds nothing
    if ((causal && k0 + w0 > q0 + BQ - 1) ||
        (window > 0 && q0 - (k0 + w0 + 15) >= window))
      continue;

    // Sᵀ = k·qᵀ and dPᵀ = v·doᵀ: rows keys, n-tile j queries q0 + 8j .. + 7
    float st[NS][4], dpt[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[j][e] = 0.f;
        dpt[j][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t kf[4], vf[4];
      fm::ldsm_x4(kf, Ks + (w0 + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8);
      fm::ldsm_x4(vf, Vs + (w0 + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        const int off = (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * P +
                        kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bq[4], bo[4];
        fm::ldsm_x4(bq, Qs + off);
        fm::ldsm_x4(bo, DOs + off);
        fm::mma(st[2 * jp], kf, bq[0], bq[1]);
        fm::mma(st[2 * jp + 1], kf, bq[2], bq[3]);
        fm::mma(dpt[2 * jp], vf, bo[0], bo[1]);
        fm::mma(dpt[2 * jp + 1], vf, bo[2], bo[3]);
      }
    }

    // Pᵀ = exp(Sᵀ - lse) on visible pairs (0 by selection elsewhere: an
    // empty row's lse is NEG_INF), dSᵀ = Pᵀ∘(dPᵀ - delta)·scale
    const bool full = q0 + BQ <= Sq && k0 + w0 + 16 <= Sk &&
                      (!causal || k0 + w0 + 15 <= q0) &&
                      (window <= 0 || q0 + BQ - 1 - (k0 + w0) < window);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const int c = c0 + (e >> 1) * 8;
        float p = exp2f(fmaf(st[j][e], sl2, -LSEs[col] * fm::LOG2E));
        if (!full && !fm::visible(q0 + col, c, Sq, Sk, causal, window)) p = 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - DELs[col]) * scale;
      }

    // dV += Pᵀ·dO and dK += dSᵀ·Q over the block's columns, each as
    // hi + lo: k-step kq is queries q0 + 16kq .. + 15
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      uint32_t phi[4], plo[4], dhi[4], dlo[4];
      fm::split_a(st[2 * kq], st[2 * kq + 1], phi, plo);
      fm::split_a(dpt[2 * kq], dpt[2 * kq + 1], dhi, dlo);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        const int off = (kq * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * P +
                        col0 + dp * 16 + ((lane >> 4) << 3);
        uint32_t bo[4], bq[4];
        fm::ldsm_x4_t(bo, DOs + off);
        fm::ldsm_x4_t(bq, Qs + off);
        fm::mma(dva[2 * dp], phi, bo[0], bo[1]);
        fm::mma(dva[2 * dp], plo, bo[0], bo[1]);
        fm::mma(dva[2 * dp + 1], phi, bo[2], bo[3]);
        fm::mma(dva[2 * dp + 1], plo, bo[2], bo[3]);
        fm::mma(dka[2 * dp], dhi, bq[0], bq[1]);
        fm::mma(dka[2 * dp], dlo, bq[0], bq[1]);
        fm::mma(dka[2 * dp + 1], dhi, bq[2], bq[3]);
        fm::mma(dka[2 * dp + 1], dlo, bq[2], bq[3]);
      }
    }
  }
  fm::cp_async_wait<0>();

  // dk and dv through this warp's rows of the k and v tiles (read by no
  // other warp), then out in 16-byte stores
  bf16* dKs = Ks + w0 * P;
  bf16* dVs = Vs + w0 * P;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = col0 + 8 * n + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(dKs + g * P + c) =
        __floats2bfloat162_rn(dka[n][0], dka[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(dKs + (g + 8) * P + c) =
        __floats2bfloat162_rn(dka[n][2], dka[n][3]);
    *reinterpret_cast<__nv_bfloat162*>(dVs + g * P + c) =
        __floats2bfloat162_rn(dva[n][0], dva[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(dVs + (g + 8) * P + c) =
        __floats2bfloat162_rn(dva[n][2], dva[n][3]);
  }
  __syncwarp();
#pragma unroll
  for (int idx = lane; idx < 16 * (DH / 8); idx += 32) {
    const int r = idx / (DH / 8);
    const int c = col0 + (idx % (DH / 8)) * 8;
    if (k0 + w0 + r >= Sk) continue;
    const size_t at = kv_base + (size_t)(k0 + w0 + r) * D + c;
    *reinterpret_cast<uint4*>(dk + at) =
        *reinterpret_cast<const uint4*>(dKs + r * P + c);
    *reinterpret_cast<uint4*>(dv + at) =
        *reinterpret_cast<const uint4*>(dVs + r * P + c);
  }
}

// A kernel's dynamic shared memory above the 48 KB default.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// A kernel's dynamic shared memory and resident blocks an SM.
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, size_t bytes, int* smem_bytes,
                      int* blocks_per_sm) {
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  *smem_bytes = (int)bytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                       THREADS, bytes);
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int Hq, int Hkv, int Sq,
                       int Sk, int causal, int window, float scale,
                       cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = allow_smem(flash_bwd_dkv_tc_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * Hkv), (unsigned)((Sk + BKV - 1) / BKV),
                  (unsigned)(D / Smem<D>::DH));
  flash_bwd_dkv_tc_kernel<D><<<grid, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, Hq, Hkv,
      Sq, Sk, causal, window, scale);
  return cudaGetLastError();
}

// ---- dq in bfloat16 on the tensor cores -----------------------------------

constexpr int BQD = 64;        // query rows per dq block: 4 warps × 16

// Shared memory: the q and do tiles (bf16, pitch D + 8), then the ring of
// k/v tiles (stage s: k at kv + 2·s·BK·P, v BK·P after it).
template <int D>
struct SmemDq {
  static constexpr int P = D + 8;
  static constexpr int BK = D == 64 ? 64 : 32;  // keys per tile
  static constexpr int STAGES = 3;
  // q's and do's fragments in registers for the whole loop; at D = 256
  // they would be 128 registers a thread beside dq's 128, so each k-step
  // reads them again from the tiles
  static constexpr bool QREG = D <= 128;
  static constexpr int q = 0;
  static constexpr int dO = BQD * P;
  static constexpr int kv = 2 * BQD * P;
  static constexpr size_t bytes =
      (size_t)(kv + STAGES * 2 * BK * P) * sizeof(bf16);
  static_assert(bytes <= 232448, "over the 227 KB a block may use");
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int Hq, int Hkv, int Sq, int Sk, int causal, int window,
                       float scale) {
  using L = SmemDq<D>;
  constexpr int P = L::P;
  constexpr int BK = L::BK;
  constexpr int ST = L::STAGES;
  constexpr int KD = D / 16;                    // k-steps of S and dP
  constexpr int NS = BK / 8;                    // n-tiles of S, dP
  constexpr int NO = D / 8;                     // n-tiles of dq
  extern __shared__ float4 smem_f4[];
  bf16* smem = reinterpret_cast<bf16*>(smem_f4);
  bf16* Qs = smem + L::q;
  bf16* DOs = smem + L::dO;

  const int lane = threadIdx.x & 31;
  const int w0 = (threadIdx.x >> 5) * 16;       // the warp's first row
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int kvh = (bh % Hq) / (Hq / Hkv);
  const int qt = causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y;
  const int q0 = qt * BQD;
  const size_t kv_base = ((size_t)b * Hkv + kvh) * Sk * D;
  const bf16* kb = k + kv_base;
  const bf16* vb = v + kv_base;

  // the key tiles any row of this query tile can see
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + BQD);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int kt0 = k_lo / BK;
  const int n_tiles = k_lo < k_hi ? (k_hi + BK - 1) / BK - kt0 : 0;

  auto load_kv = [&](int i) {
    bf16* Ks = smem + L::kv + (i % ST) * 2 * BK * P;
    fm::cp_tile<D, BK, THREADS>(Ks, kb, (kt0 + i) * BK, Sk);
    fm::cp_tile<D, BK, THREADS>(Ks + BK * P, vb, (kt0 + i) * BK, Sk);
  };
  // group s holds tile s (and group 0 the q and do tiles)
  if (n_tiles > 0) {
    fm::cp_tile<D, BQD, THREADS>(Qs, q + (size_t)bh * Sq * D, q0, Sq);
    fm::cp_tile<D, BQD, THREADS>(DOs, dout + (size_t)bh * Sq * D, q0, Sq);
  }
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < n_tiles) load_kv(s);
    fm::cp_async_commit();
  }

  // rows r0 and r0 + 8: −lse in log2 units and delta; rows past Sq take 0
  // (their q and do are zero, so their p is finite and their dS 0; they
  // are never stored)
  const int r0 = q0 + w0 + g;
  const float* lrow = lse + (size_t)bh * Sq;
  const float* drow = delta + (size_t)bh * Sq;
  const float nl0 = r0 < Sq ? -lrow[r0] * fm::LOG2E : 0.f;
  const float nl1 = r0 + 8 < Sq ? -lrow[r0 + 8] * fm::LOG2E : 0.f;
  const float dl0 = r0 < Sq ? drow[r0] : 0.f;
  const float dl1 = r0 + 8 < Sq ? drow[r0 + 8] : 0.f;
  const float sl2 = scale * fm::LOG2E;          // scores in log2 units
  uint32_t qf[L::QREG ? KD : 1][4], df[L::QREG ? KD : 1][4];
  float acc[NO][4];
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
        for (int kk = 0; kk < KD; ++kk) {
          const int off = (w0 + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8;
          fm::ldsm_x4(qf[kk], Qs + off);
          fm::ldsm_x4(df[kk], DOs + off);
        }
      }
    }
    const bf16* Ks = smem + L::kv + (i % ST) * 2 * BK * P;
    const bf16* Vs = Ks + BK * P;
    const int k0 = (kt0 + i) * BK;
    // a tile none of this warp's rows can see adds nothing
    if ((causal && k0 > q0 + w0 + 15) ||
        (window > 0 && q0 + w0 - (k0 + BK - 1) >= window))
      continue;

    // S = q·kᵀ and dP = do·vᵀ: n-tile j holds keys k0 + 8j .. + 7
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], da[4];
      if constexpr (L::QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qa[e] = qf[kk][e];
          da[e] = df[kk][e];
        }
      } else {
        const int off = (w0 + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8;
        fm::ldsm_x4(qa, Qs + off);
        fm::ldsm_x4(da, DOs + off);
      }
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        const int off = (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * P +
                        kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t kf[4], vf[4];
        fm::ldsm_x4(kf, Ks + off);
        fm::ldsm_x4(vf, Vs + off);
        fm::mma(s[2 * jp], qa, kf[0], kf[1]);
        fm::mma(s[2 * jp + 1], qa, kf[2], kf[3]);
        fm::mma(dp[2 * jp], da, vf[0], vf[1]);
        fm::mma(dp[2 * jp + 1], da, vf[2], vf[3]);
      }
    }

    // P = exp(S - lse) on visible pairs (0 by selection elsewhere: an
    // empty row's lse is NEG_INF), dS = P∘(dP - delta)·scale, into s
    const bool full = k0 + BK <= Sk && (!causal || k0 + BK - 1 <= q0 + w0) &&
                      (window <= 0 || q0 + w0 + 15 - k0 < window);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = k0 + 8 * j + 2 * t + (e & 1);
        const int r = e < 2 ? r0 : r0 + 8;
        float p = exp2f(fmaf(s[j][e], sl2, e < 2 ? nl0 : nl1));
        if (!full && !fm::visible(r, c, Sq, Sk, causal, window)) p = 0.f;
        s[j][e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1)) * scale;
      }

    // dq += dS·k as hi + lo: k-step kk is keys k0 + 16kk .. + 15
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      fm::split_a(s[2 * kk], s[2 * kk + 1], hi, lo);
#pragma unroll
      for (int dp2 = 0; dp2 < D / 16; ++dp2) {
        uint32_t kf[4];
        fm::ldsm_x4_t(kf, Ks + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * P +
                              dp2 * 16 + ((lane >> 4) << 3));
        fm::mma(acc[2 * dp2], hi, kf[0], kf[1]);
        fm::mma(acc[2 * dp2], lo, kf[0], kf[1]);
        fm::mma(acc[2 * dp2 + 1], hi, kf[2], kf[3]);
        fm::mma(acc[2 * dp2 + 1], lo, kf[2], kf[3]);
      }
    }
  }
  fm::cp_async_wait<0>();

  // dq through this warp's rows of the q tile (read by no other warp),
  // then out in 16-byte stores
  bf16* dQs = Qs + w0 * P;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(dQs + g * P + 8 * n + 2 * t) =
        __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(dQs + (g + 8) * P + 8 * n + 2 * t) =
        __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
  __syncwarp();
#pragma unroll
  for (int idx = lane; idx < 16 * (D / 8); idx += 32) {
    const int r = idx / (D / 8);
    const int c = (idx % (D / 8)) * 8;
    if (q0 + w0 + r < Sq)
      *reinterpret_cast<uint4*>(dq + ((size_t)bh * Sq + q0 + w0 + r) * D + c) =
          *reinterpret_cast<const uint4*>(dQs + r * P + c);
  }
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int Hq, int Hkv, int Sq, int Sk,
                      int causal, int window, float scale,
                      cudaStream_t stream) {
  const size_t smem = SmemDq<D>::bytes;
  cudaError_t err = allow_smem(flash_bwd_dq_tc_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Sq + BQD - 1) / BQD));
  flash_bwd_dq_tc_kernel<D><<<grid, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, Hq, Hkv, Sq, Sk,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// Each launches one kernel on `stream` and returns cudaGetLastError() right
// after the launch (cudaSuccess and no launch when the grid is empty).
// Shapes: q, do (B, Hq, Sq, D); k, v (B, Hkv, Sk, D), contiguous, one type,
// 16-byte aligned, Hq % Hkv == 0, B·Hq <= 65535; lse and delta (B, Hq, Sq)
// float32; dq like q; dk, dv like k. dtype 0 = float32, 1 = bfloat16; D is
// 64, 128 or 256; window <= 0 means no window.
int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, int B, int Hq,
                                  int Hkv, int Sq, int Sk, int D, int dtype,
                                  int causal, int window, float scale,
                                  void* stream) {
  if (Sq <= 0 || B * Hq <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  using Launch = cudaError_t (*)(const void*, const void*, const void*,
                                 const void*, const void*, const void*, void*,
                                 int, int, int, int, int, int, int, float,
                                 cudaStream_t);
  Launch fn = nullptr;
  if (dtype == 0 && D == 64) fn = launch_dq<float, 64>;
  if (dtype == 0 && D == 128) fn = launch_dq<float, 128>;
  if (dtype == 0 && D == 256) fn = launch_dq<float, 256>;
  if (dtype == 1 && D == 64) fn = tc::launch_dq<64>;
  if (dtype == 1 && D == 128) fn = tc::launch_dq<128>;
  if (dtype == 1 && D == 256) fn = tc::launch_dq<256>;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)fn(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Sq, Sk, causal,
                 window, scale, (cudaStream_t)stream);
}

int flash_attention_bwd_dkv_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int Hq, int Hkv,
                                   int Sq, int Sk, int D, int dtype,
                                   int causal, int window, float scale,
                                   void* stream) {
  if (Sk <= 0 || B * Hkv <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  using Launch = cudaError_t (*)(const void*, const void*, const void*,
                                 const void*, const void*, const void*, void*,
                                 void*, int, int, int, int, int, int, int,
                                 float, cudaStream_t);
  Launch fn = nullptr;
  if (dtype == 0 && D == 64) fn = launch_dkv<float, 64>;
  if (dtype == 0 && D == 128) fn = launch_dkv<float, 128>;
  if (dtype == 0 && D == 256) fn = launch_dkv<float, 256>;
  if (dtype == 1 && D == 64) fn = tc::launch_dkv<64>;
  if (dtype == 1 && D == 128) fn = tc::launch_dkv<128>;
  if (dtype == 1 && D == 256) fn = tc::launch_dkv<256>;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)fn(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq, Sk,
                 causal, window, scale, (cudaStream_t)stream);
}

// The bfloat16 dq kernel's dynamic shared memory and resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) for head_dim D.
int flash_attention_bwd_dq_info(int D, int* smem_bytes, int* blocks_per_sm) {
  if (D == 64)
    return (int)tc::occupancy(tc::flash_bwd_dq_tc_kernel<64>,
                              tc::SmemDq<64>::bytes, smem_bytes, blocks_per_sm);
  if (D == 128)
    return (int)tc::occupancy(tc::flash_bwd_dq_tc_kernel<128>,
                              tc::SmemDq<128>::bytes, smem_bytes,
                              blocks_per_sm);
  if (D == 256)
    return (int)tc::occupancy(tc::flash_bwd_dq_tc_kernel<256>,
                              tc::SmemDq<256>::bytes, smem_bytes,
                              blocks_per_sm);
  return (int)cudaErrorInvalidValue;
}

// The bfloat16 dk/dv kernel's dynamic shared memory and resident blocks an
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) for head_dim D.
int flash_attention_bwd_dkv_info(int D, int* smem_bytes, int* blocks_per_sm) {
  if (D == 64)
    return (int)tc::occupancy(tc::flash_bwd_dkv_tc_kernel<64>,
                              tc::Smem<64>::bytes, smem_bytes, blocks_per_sm);
  if (D == 128)
    return (int)tc::occupancy(tc::flash_bwd_dkv_tc_kernel<128>,
                              tc::Smem<128>::bytes, smem_bytes,
                              blocks_per_sm);
  if (D == 256)
    return (int)tc::occupancy(tc::flash_bwd_dkv_tc_kernel<256>,
                              tc::Smem<256>::bytes, smem_bytes,
                              blocks_per_sm);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
