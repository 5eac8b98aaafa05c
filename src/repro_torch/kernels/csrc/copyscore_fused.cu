// Fused dual-direction copyscore over a list of pair tiles, for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/copyscore.py:_copyscore_fused_kernel of the
// JAX package (reached there through copyscore_fused_pallas ->
// ops.copyscore_tile_fused -> distributed._local_tile_scores). One launch
// covers one chunk group of the engine's stream over the group's whole tile
// list, as one device's lax.scan over its tiles did.
//
// Per live tile (r, c) and per chunk g of the group (one p̂, δ and non-Ē
// flag m per chunk), for every pair (i, j) of the tile:
//   count   = V[r*T+i, g, :] · V[c*T+j, g, :]        int8 -> exact int32
//   f→, f←  = Eq. 6 from (a_i, a_j, p̂)               f← swaps the copied-source role
//   C→ += f→·count   C← += f←·count   n += count   n_out += m·count   err += δ·count
// The five (n_tiles, T, T) float32 stacks are updated in place: a block sums
// the group's chunks from zero and in chunk order, then adds that sum to the
// stack with one read-modify-write. That is the association of the JAX
// engine's `stacks + outs` (core/engine.py:974-975), where `outs` is the
// kernel's per-group sum. A (-1, -1) tile slot returns at once and leaves
// its stack rows untouched.
//
// What bounds it on this card. Per live tile and chunk: 2·T²·w int8
// operations and, per pair, two logf and three IEEE divisions. Bytes per
// group: the (S_pad, Gc, w) slab read once, plus 5 × 4 B × T² per live tile
// read and written. The detection pass's launch (T = 256, 2080 live tiles,
// Gc = 1, w = 4096) is 1.12e12 int8 operations (0.57 ms at the int8
// tensor-core peak) against 5.45 GB of stacks read and written (1.63 ms at
// 3.35 TB/s): the stack traffic bounds it, the count product well behind.
//
// Design. The count product runs on the int8 tensor cores with B3's pieces
// (copyscore_mma.cuh: mma.sync m16n8k32, ldmatrix, a cp.async ring of
// 64-entry K-slices with an 80-byte pitch; the dp4a kernel this replaces
// was held at 27× the bound by its CUDA-core product). A 1-D grid of (tile
// slot × sub-tile) blocks of 8 warps; a sub-tile is 128 rows × TN columns of
// one pair tile, and the sub-tiles of one tile are adjacent in the grid, so
// the blocks in flight share their rows' and columns' incidence in L2 (the
// engine's list is r ≤ c row-major: consecutive tiles share their row
// band). Rows and columns past T within the tile (T = 64 or 96) are
// zero-filled on load and never written: the mask is the tile's edge, since
// the next tile's rows are live data. Warp w owns rows 64·(w / 4) .. + 63
// and TN / 4 columns of the sub-tile, its counts in registers.
//   Gc = 1 (the detection pass): TN = 128 and a 3-stage ring. Nothing is
// carried between chunks, so after the product each channel in turn goes
// through the Eq. 6 epilogue into a staging tile in the ring's shared
// memory and leaves in coalesced 16-byte read-modify-writes of its stack
// (512 contiguous bytes a sub-tile row). The counts stay in registers over
// the five passes (pr_ind is recomputed for C←, bit for bit as for C→); the
// accuracies are read from shared memory in each pass, so no pass keeps
// them live across the next, and the kernel fits 128 registers and two
// blocks an SM: one block's five output passes overlap the other's
// products. Where w is a multiple of 64 (the pass's 4096) a variant copies
// only whole 16-byte pieces and has no check for a chunk's ragged end in
// its loop: the generic variant's runtime checks cost B3 ~20 % of its time
// (PERF.md §6, step 0).
//   Gc > 1: the five sums must live across the chunks, and five 128×128
// float32 channels (320 KB) fit nowhere, so the sub-tile is 128 × 64 and its
// five sums (184 KB) sit in shared memory beside a 2-stage ring (31 KB),
// one block an SM; each chunk's epilogue adds into them in place, and the
// sums leave once after the last chunk.
//
// Numerics. Every floating-point step is an explicit IEEE-rounded intrinsic
// and logf is the accurate one (build without --use_fast_math), so nothing
// is contracted into an FMA and the kernel follows the plain PyTorch
// version's separately rounded steps. Eq. 3 and Eq. 6 are the shared
// copyscore_eq6.cuh functions, as in B3 (copyscore.cu); pr_ind multiplies
// a_i·a_j first, which is symmetric in the two accuracies, and f→ and f←
// come from one function: on a diagonal tile C← equals C→ᵀ bit for bit,
// which the engine's scatter relies on, and on one chunk B3's full square
// equals the grid these stacks scatter into, bit for bit. The counts are
// exact int32 whichever unit computes them, so neither equality depends on
// the tile shape. No float atomics: two launches give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "copyscore_eq6.cuh"
#include "copyscore_mma.cuh"

namespace {

namespace cm = copyscore_mma;
namespace eq = copyscore_eq6;
namespace fm = flash_mma;

constexpr int THREADS = 256;
constexpr int CHANNELS = 5;   // C→, C←, n, n_out, err
constexpr int TM = 128;       // sub-tile rows
constexpr int WM = 64;        // a warp's rows
constexpr int MT = WM / 16;   // a warp's m-tiles
constexpr int KS = 64;        // entries a K-slice
constexpr int PB = KS + 16;   // ring row pitch (bytes)

// SUMS (Gc > 1): the five sums carried in shared memory after the ring.
// After them (or after the ring and staging), the sub-tile's TM row and TN
// column accuracies.
template <bool SUMS>
struct Tile {
  static constexpr int TN = SUMS ? 64 : 128;   // sub-tile columns
  static constexpr int WN = TN / 4;            // a warp's columns
  static constexpr int NT = WN / 8;            // a warp's n-tiles
  static constexpr int STAGES = SUMS ? 2 : 3;
  static constexpr int STAGE = (TM + TN) * PB; // bytes a ring stage
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SP = TN + 8;            // staging row pitch (floats):
                                               // conflict-free float2 writes
  static constexpr int CHANNEL = TM * SP * 4;  // bytes a staged channel
  static constexpr int ACC =                   // bytes before the accuracies
      SUMS ? RING + CHANNELS * CHANNEL : (RING > CHANNEL ? RING : CHANNEL);
  static constexpr int SMEM = ACC + (TM + TN) * 4;
};

// ALIGNED: w a multiple of KS and the slab 16-byte aligned (the detection
// pass), so every K-slice is whole and copied 16 bytes at a time, with no
// check for a chunk's ragged end in the loop.
template <bool SUMS, bool ALIGNED>
__global__ void __launch_bounds__(THREADS, SUMS ? 1 : 2)
copyscore_fused_kernel(const int8_t* __restrict__ v,
                       const float* __restrict__ acc,
                       const float* __restrict__ p_hat,
                       const float* __restrict__ delta,
                       const float* __restrict__ nout,
                       const int32_t* __restrict__ coords,
                       float* __restrict__ c_fwd, float* __restrict__ c_bwd,
                       float* __restrict__ cnt, float* __restrict__ cnt_out,
                       float* __restrict__ err, int tile, int gc, int w,
                       int vec16, int vec_out, float s, float one_m_s,
                       float n_false) {
  using L = Tile<SUMS>;
  extern __shared__ float4 smem_f4[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem_f4);
  float* sums = reinterpret_cast<float*>(ring + (SUMS ? L::RING : 0));
  float* acc_s = reinterpret_cast<float*>(ring + L::ACC);

  // this block's tile slot and sub-tile
  const int n_sn = (tile + L::TN - 1) / L::TN;
  const int per_tile = (tile + TM - 1) / TM * n_sn;
  const int slot = (int)blockIdx.x / per_tile;
  const int sub = (int)blockIdx.x % per_tile;
  const int rb = coords[2 * slot];
  const int cb = coords[2 * slot + 1];
  if (rb < 0 || cb < 0) return;
  const int i0 = sub / n_sn * TM;               // the sub-tile in its tile
  const int j0 = sub % n_sn * L::TN;
  const long long row_bytes = (long long)gc * w;
  const int8_t* v_rows = v + (long long)rb * tile * row_bytes;
  const int8_t* v_cols = v + (long long)cb * tile * row_bytes;
  // the accuracies, read by the epilogue from shared memory: after each
  // barrier anew, so no pass keeps them in registers (0.5 past the tile)
  for (int x = threadIdx.x; x < TM + L::TN; x += THREADS) {
    const int k = x < TM ? i0 + x : j0 + x - TM;
    acc_s[x] = k < tile ? acc[(long long)(x < TM ? rb : cb) * tile + k] : 0.5f;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 2) * WM;              // the warp's rows in the sub-tile
  const int wn = (warp & 3) * L::WN;            // ... and columns
  const int spb = (w + KS - 1) / KS;            // K-slices a chunk
  const int total = gc * spb;

  auto load = [&](int it) {                     // with one chunk, slice it
    const int sl = SUMS ? it % spb : it;
    const long long k0 = SUMS ? (long long)(it / spb) * w + sl * KS
                              : (long long)sl * KS;
    const int n_valid = ALIGNED ? KS : min(KS, w - sl * KS);
    int8_t* As = ring + (it % L::STAGES) * L::STAGE;
    cm::cp_slice<TM, KS, THREADS>(As, v_rows, i0, tile, row_bytes, k0,
                                  n_valid, ALIGNED || vec16);
    cm::cp_slice<L::TN, KS, THREADS>(As + TM * PB, v_cols, j0, tile,
                                     row_bytes, k0, n_valid, ALIGNED || vec16);
  };
  // group s holds slice s
#pragma unroll
  for (int st = 0; st < L::STAGES - 1; ++st) {
    if (st < total) load(st);
    fm::cp_async_commit();
  }

  int32_t count[MT][L::NT][4];

  // The Eq. 6 epilogue of chunk k from this thread's counts: channels
  // [lo, hi) into St, channel ch at St + (ch − lo)·TM·SP, each value added
  // to what the slot holds with `add`, else to 0. Slots are this thread's
  // own: rows wm + 16·mi + g (+ 8), columns wn + 8·ni + 2t (+ 1).
  auto put = [&](int k, float* St, int lo, int hi, bool add) {
    const float p = p_hat[k];
    const float d = delta[k];
    const float mo = nout[k];
    float aj[L::NT][2];
#pragma unroll
    for (int ni = 0; ni < L::NT; ++ni) {
      const float2 a2 = *reinterpret_cast<const float2*>(
          acc_s + TM + wn + 8 * ni + 2 * t);
      aj[ni][0] = a2.x;
      aj[ni][1] = a2.y;
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + 16 * mi + g + 8 * h;
        const float ai = acc_s[r];
#pragma unroll
        for (int ni = 0; ni < L::NT; ++ni) {
          const int o = r * L::SP + wn + 8 * ni + 2 * t;
          float c[2], pr[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            c[e] = (float)count[mi][ni][2 * h + e];
            pr[e] = lo <= 1 && hi > 0
                        ? eq::pr_independent(p, ai, aj[ni][e], n_false)
                        : 0.0f;
          }
#pragma unroll
          for (int ch = 0; ch < CHANNELS; ++ch) {
            if (ch < lo || ch >= hi) continue;
            float x[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (ch == 0)
                x[e] = __fmul_rn(
                    eq::pair_score(p, aj[ni][e], pr[e], s, one_m_s), c[e]);
              else if (ch == 1)
                x[e] = __fmul_rn(eq::pair_score(p, ai, pr[e], s, one_m_s),
                                 c[e]);
              else if (ch == 2)
                x[e] = c[e];
              else if (ch == 3)
                x[e] = __fmul_rn(mo, c[e]);
              else
                x[e] = __fmul_rn(d, c[e]);
            }
            float* q = St + (ch - lo) * (TM * L::SP) + o;
            const float2 was = add ? *reinterpret_cast<const float2*>(q)
                                   : make_float2(0.f, 0.f);
            *reinterpret_cast<float2*>(q) = make_float2(
                __fadd_rn(was.x, x[0]), __fadd_rn(was.y, x[1]));
          }
        }
      }
  };

  auto zero = [&]() {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < L::NT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) count[mi][ni][e] = 0;
  };
  zero();
  for (int it = 0; it < total; ++it) {
    fm::cp_async_wait<L::STAGES - 2>();         // slice it has landed
    __syncthreads();                            // ... for every thread; slice it-1 consumed
    if (it + L::STAGES - 1 < total) load(it + L::STAGES - 1);
    fm::cp_async_commit();
    const int sl = SUMS ? it % spb : it;
    const int8_t* As = ring + (it % L::STAGES) * L::STAGE;
    cm::count_slice<MT, L::NT, KS>(count, As, As + TM * PB, wm, wn,
                                   ALIGNED ? KS : w - sl * KS);
    if (SUMS && sl == spb - 1) {
      put(it / spb, sums, 0, CHANNELS, it >= spb);
      zero();
    }
  }
  fm::cp_async_wait<0>();

  // out: each channel's sub-tile of this slot's stack, added once
  float* const outs[CHANNELS] = {c_fwd, c_bwd, cnt, cnt_out, err};
  const long long base = (long long)slot * tile * tile + (long long)i0 * tile + j0;
  if (SUMS) {
    __syncthreads();                            // every thread's sums are in
#pragma unroll
    for (int ch = 0; ch < CHANNELS; ++ch)
      cm::store_tile<TM, L::TN, L::SP, THREADS>(
          sums + ch * (TM * L::SP), outs[ch] + base, tile, tile - i0,
          tile - j0, true, vec_out);
  } else {
    float* St = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int ch = 0; ch < CHANNELS; ++ch) {
      __syncthreads();                          // the ring, or the last channel's staging, is free
      put(0, St, ch, ch + 1, false);
      __syncthreads();
      cm::store_tile<TM, L::TN, L::SP, THREADS>(St, outs[ch] + base, tile,
                                                tile - i0, tile - j0, true,
                                                vec_out);
    }
  }
}

template <bool SUMS, bool ALIGNED>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(copyscore_fused_kernel<SUMS, ALIGNED>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Tile<SUMS>::SMEM);
}

template <bool SUMS, bool ALIGNED>
cudaError_t launch(const int8_t* v, const float* acc, const float* p_hat,
                   const float* delta, const float* nout,
                   const int32_t* coords, float* const (&stacks)[CHANNELS],
                   int n_tiles, int tile, int gc, int w, float s,
                   float one_m_s, float n_false, cudaStream_t stream) {
  using L = Tile<SUMS>;
  const long long blocks = (long long)n_tiles * ((tile + TM - 1) / TM) *
                           ((tile + L::TN - 1) / L::TN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<SUMS, ALIGNED>();
  if (err != cudaSuccess) return err;
  const bool vec16 = w % 16 == 0 && (uintptr_t)v % 16 == 0;
  bool vec_out = tile % 4 == 0;
  for (float* st : stacks) vec_out = vec_out && (uintptr_t)st % 16 == 0;
  copyscore_fused_kernel<SUMS, ALIGNED><<<(unsigned)blocks, THREADS, L::SMEM,
                                          stream>>>(
      v, acc, p_hat, delta, nout, coords, stacks[0], stacks[1], stacks[2],
      stacks[3], stacks[4], tile, gc, w, (int)vec16, (int)vec_out, s,
      one_m_s, n_false);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one chunk group over `n_tiles` tile slots on `stream` and returns
// cudaGetLastError() right after the launch (cudaSuccess when n_tiles is 0:
// nothing is launched). Shapes: v (S_pad, gc, w) int8 with w % 8 == 0 and the
// base 8-byte aligned; acc (S_pad,); p_hat, delta, nout (gc,); coords
// (n_tiles, 2) int32 with every live slot inside the S_pad/tile grid; the
// five stacks (n_tiles, tile, tile) float32. one_m_s is 1 − s rounded to
// float from double, as the host-side expression gives it.
int copyscore_fused_launch(const void* v, const void* acc, const void* p_hat,
                           const void* delta, const void* nout,
                           const void* coords, void* c_fwd, void* c_bwd,
                           void* cnt, void* cnt_out, void* err, int n_tiles,
                           int tile, int gc, int w, float s, float one_m_s,
                           float n_false, void* stream) {
  if (n_tiles <= 0) return (int)cudaSuccess;
  float* const stacks[CHANNELS] = {(float*)c_fwd, (float*)c_bwd, (float*)cnt,
                                   (float*)cnt_out, (float*)err};
  const auto* vv = (const int8_t*)v;
  const auto* a = (const float*)acc;
  const auto* p = (const float*)p_hat;
  const auto* d = (const float*)delta;
  const auto* m = (const float*)nout;
  const auto* c = (const int32_t*)coords;
  cudaStream_t st = (cudaStream_t)stream;
  if (gc > 1)
    return (int)launch<true, false>(vv, a, p, d, m, c, stacks, n_tiles, tile,
                                    gc, w, s, one_m_s, n_false, st);
  if (w % KS == 0 && (uintptr_t)v % 16 == 0)
    return (int)launch<false, true>(vv, a, p, d, m, c, stacks, n_tiles, tile,
                                    gc, w, s, one_m_s, n_false, st);
  return (int)launch<false, false>(vv, a, p, d, m, c, stacks, n_tiles, tile,
                                   gc, w, s, one_m_s, n_false, st);
}

// B1's dynamic shared memory and resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) with one chunk a group, as
// the detection pass launches it.
int copyscore_fused_info(int* smem_bytes, int* blocks_per_sm) {
  cudaError_t err = allow_smem<false, true>();
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = Tile<false>::SMEM;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, copyscore_fused_kernel<false, true>, THREADS,
      Tile<false>::SMEM);
}

const char* copyscore_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
