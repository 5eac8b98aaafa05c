// Single-direction copyscore over one rectangular pair block, for Hopper
// (sm_90a).
//
// Replaces two TPU kernels of the JAX package, reached there through
// copyscore_pallas (kernels/copyscore.py):
//   _copyscore_kernel      (C→, n)       — ops.copyscore, ops.copyscore_store,
//                                           ops.copyscore_tile without δ:
//                                           copyscore_tc_kernel<·, false>
//                                           (B3);
//   _copyscore_err_kernel  (C→, n, err)  — ops.copyscore_tile with δ:
//                                           copyscore_tc_kernel<true, true>
//                                           (B2).
//
// Rows copy from columns. For every pair (i, j) of the S_i × S_j block and
// every entry block b of width block_e (one p̂_b, and δ_b for B2):
//   count = V_rows[i, b] · V_cols[j, b]               int8 -> exact int32
//   f→    = Eq. 6 from (a_i, a_j, p̂_b)                a_j the copied source
//   C→ += f→·count    n += count    (B2: err += δ_b·count)
// The sums start from zero and run over the entry blocks in order; each
// output is then written once — or, with `accumulate`, added once to what
// the output already holds (the store path sums its chunks on the device
// that way, one launch per chunk, in chunk order).
//
// What bounds them on this card. Per pair and entry block: 2·block_e int8
// operations and ~21 float32 operations (one logf and two divisions among
// them). Bytes: each incidence row read once, the outputs written once (read
// and written with `accumulate`). The store's full square at S = 16384 and
// one 4096-wide chunk a launch is 2.2e12 int8 operations (1.1 ms at the
// int8 tensor-core peak) against 4.3 GB of accumulators read and written
// (1.3 ms at 3.35 TB/s): bytes bound the function, the int8 product close
// behind.
//
// B3, copyscore_tc_kernel: the count product on the int8 tensor cores
// (mma.sync m16n8k32 s8·s8→s32, copyscore_mma.cuh), because on the CUDA
// cores (dp4a, 4 multiply-adds an instruction) that product alone held the
// kernel at ~40× the bound. Design: a 1-D grid of 128×128 pair tiles, taken
// in groups of 16 tile rows so that the blocks in flight share their rows'
// and columns' incidence in L2 (each incidence byte is read by S/128
// blocks). A block of 8 warps owns one tile; warp w owns rows
// 64·(w / 4) .. + 63 and columns 32·(w % 4) .. + 31 of it, 4 × 4 fragments
// of 16×8 int32 counts, 64 a thread, in registers. K-slices of 64 entries
// of the tile's 128 rows and 128 columns stream through a 3-stage cp.async
// ring with an 80-byte pitch (conflict-free ldmatrix): 16-byte copies where
// rows and blocks sit on 16-byte boundaries (the store path, w = 4096),
// 4-byte copies otherwise (block_e a multiple of 4, ROADMAP C8), in the
// same kernel. Bytes past an entry block's end and rows past S_i / S_j are
// zero-filled, and zero entries are inert, so ragged S_i, S_j and narrow
// blocks need no padding from the caller. The entry-block loop is the outer
// loop: after each block the exact int32 counts go through the per-pair
// Eq. 6 epilogue into float32 sums, in block order. The sums are staged in
// shared memory and leave in coalesced 16-byte read-modify-writes of the
// (S_i, S_j) outputs, one channel at a time. With one entry block (the
// store path) nothing is carried between blocks, so the staging reuses the
// ring's memory and two blocks fit an SM, one block's epilogue and output
// traffic overlapping the other's products; with more entry blocks
// (SUMS) the sums keep their own 136 KB of shared memory for the whole
// loop, one block an SM. On an H100 at 700 W a store launch takes ~6.6 ms,
// 5× the bytes bound. Variants of it timed apart on that card split the
// time: the count product alone ~3.5 ms (a library int8 GEMM alone takes
// 2.4 ms), the per-pair epilogue ~0.75 ms more, the output traffic ~0.9 ms
// not overlapped, and ~1.4 ms for the runtime paths this generic kernel
// keeps in its loop (the 4- or 16-byte copy chosen per launch, the check
// for a block's ragged end); B1 (copyscore_fused.cu) has a variant
// without them.
//
// B2, copyscore_tc_kernel<true, true>: B3's kernel, tile, ring and raster
// with the error channel, err += δ_b·count, in the same per-block epilogue
// (the ERR template parameter). Three 128×136 float32 channels beside the
// ring would need 270 KB of shared memory, so C→ and err are summed in
// 136 KB of it and n, an integer, in int32 registers (64 a thread beside
// the 64 counts), one block an SM. At the legacy per-tile scan's 256×256
// tile a 128×128 grid is only 4 blocks for 132 SMs, so the entry blocks
// are split into contiguous ranges, one grid row of tiles each
// (ops.py's _err_splits chooses the count so that the blocks reach the SMs;
// range k is [k·n_blocks / splits, (k + 1)·n_blocks / splits)). With one
// range the block writes, or adds to, the outputs itself; with more, each
// range writes its partial sums to a workspace that the wrapper allocates,
// and a second, fixed-order pass (copyscore_err_reduce_kernel) sums the
// ranges in range order and writes, or adds to, the outputs. No atomics:
// two launches give the same bits. Counts stay exact; C→ and err are summed
// range by range, an association other than the plain version's block
// order, within its float32 round-off (ROADMAP C4). The legacy scan's launch
// (65 entry blocks of 248, E = 16120) is bound by its 9 MB of bytes (2.7 µs)
// and takes a few launch latencies: the tiles, then the reduction.
//
// Numerics. Every floating-point step is an explicit IEEE-rounded intrinsic
// and logf is the accurate one (no --use_fast_math): nothing is contracted
// into an FMA. pr_independent and pair_score are the shared functions of
// copyscore_eq6.cuh, which B1 (copyscore_fused.cu) calls too (a1·a2 first),
// and B3 sums from zero in block order, so on one entry block B3's C→
// equals, bit for bit, the grid that B1's C→ and C← stacks scatter into:
// the counts are exact whichever unit computes them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "copyscore_eq6.cuh"
#include "copyscore_mma.cuh"

namespace {

constexpr int THREADS = 256;

using copyscore_eq6::pair_score;
using copyscore_eq6::pr_independent;

// ---- B3 on the int8 tensor cores ------------------------------------------

namespace cm = copyscore_mma;
namespace fm = flash_mma;

namespace tc {

constexpr int TM = 128;        // pair tile rows
constexpr int TN = 128;        // pair tile columns
constexpr int WM = 64;         // a warp's rows
constexpr int WN = 32;         // a warp's columns
constexpr int MT = WM / 16;    // a warp's m-tiles
constexpr int NT = WN / 8;     // a warp's n-tiles
constexpr int KS = 64;         // entries a K-slice
constexpr int PB = KS + 16;    // ring row pitch (bytes)
constexpr int STAGES = 3;
constexpr int STAGE = (TM + TN) * PB;         // bytes a ring stage
constexpr int RING = STAGES * STAGE;
constexpr int SP = TN + 8;     // staging row pitch (floats): conflict-free
                               // float2 writes within a half warp
constexpr int CHANNEL = TM * SP * 4;          // bytes a staged channel
constexpr int GROUP = 16;      // tile rows a raster group

// SUMS: more than one entry block, the sums carried in their own shared
// memory after the ring; else one channel staged at a time in the ring's.
// ERR (B2, always with SUMS): the second sum is err (δ_b·count) in place of
// n, n is carried as int32 in registers, and the grid holds n_splits ranges
// of entry blocks, one grid row of tiles each.
template <bool SUMS>
constexpr int smem_bytes() {
  return SUMS ? RING + 2 * CHANNEL : (RING > CHANNEL ? RING : CHANNEL);
}

template <bool SUMS, bool ERR>
__global__ void __launch_bounds__(THREADS, SUMS ? 1 : 2)
copyscore_tc_kernel(const int8_t* __restrict__ v_rows,
                    const int8_t* __restrict__ v_cols,
                    const float* __restrict__ acc_rows,
                    const float* __restrict__ acc_cols,
                    const float* __restrict__ p_blk,
                    const float* __restrict__ delta_blk,
                    float* __restrict__ c_fwd, float* __restrict__ cnt,
                    float* __restrict__ err, float* __restrict__ work,
                    int s_i, int s_j, int n_blocks, int block_e, int n_splits,
                    int accumulate, int vec16, int vec_out, float s,
                    float one_m_s, float n_false) {
  static_assert(SUMS || !ERR, "B2 carries its sums beside the ring");
  extern __shared__ float4 smem_f4[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem_f4);
  float* sums = reinterpret_cast<float*>(ring + (SUMS ? RING : 0));

  // this block's range of entry blocks (B2: its grid row's; B3: all of
  // them), and its tile, in raster groups of GROUP tile rows
  const int n_tm = (s_i + TM - 1) / TM;
  const int n_tn = (s_j + TN - 1) / TN;
  const int split = ERR ? (int)blockIdx.x / (n_tm * n_tn) : 0;
  const int tix = (int)blockIdx.x - split * n_tm * n_tn;
  const int per_group = GROUP * n_tn;
  const int first = tix / per_group * GROUP;
  const int rows_here = min(n_tm - first, GROUP);
  const int in_group = tix % per_group;
  const int i0 = (first + in_group % rows_here) * TM;
  const int j0 = (in_group / rows_here) * TN;
  const int b_lo = ERR ? (int)((long long)split * n_blocks / n_splits) : 0;
  const int b_hi =
      ERR ? (int)((long long)(split + 1) * n_blocks / n_splits) : n_blocks;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 2) * WM;              // the warp's rows in the tile
  const int wn = (warp & 3) * WN;               // ... and columns
  const long long row_bytes = (long long)n_blocks * block_e;
  const int spb = (block_e + KS - 1) / KS;      // K-slices an entry block
  const int total = (b_hi - b_lo) * spb;

  auto load = [&](int it) {
    const int sl = it % spb;
    const long long k0 = (long long)(b_lo + it / spb) * block_e + sl * KS;
    const int n_valid = min(KS, block_e - sl * KS);
    int8_t* As = ring + (it % STAGES) * STAGE;
    cm::cp_slice<TM, KS, THREADS>(As, v_rows, i0, s_i, row_bytes, k0, n_valid,
                                  vec16);
    cm::cp_slice<TN, KS, THREADS>(As + TM * PB, v_cols, j0, s_j, row_bytes,
                                  k0, n_valid, vec16);
  };
  // group s holds slice s
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < total) load(st);
    fm::cp_async_commit();
  }

  int32_t count[MT][NT][4];
  int32_t n_sum[MT][NT][4];                     // B2's n, exact
  if (ERR) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) n_sum[mi][ni][e] = 0;
  }

  // The Eq. 6 epilogue of entry block b from this thread's counts: C→ (f·c)
  // into Sc and the second channel into Sx, n (c) for B3 and err (δ_b·c)
  // for B2, whose n goes to n_sum; each added to what the slot holds with
  // `add`, else to 0; a null channel is skipped. Slots are this thread's
  // own: rows wm + 16·mi + g (+ 8), columns wn + 8·ni + 2t (+ 1).
  auto put = [&](int b, float* Sc, float* Sx, bool add) {
    const float p = p_blk[b];
    const float d = ERR ? delta_blk[b] : 0.0f;
    float aj[NT][2];
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + wn + 8 * ni + 2 * t + e;
        aj[ni][e] = j < s_j ? acc_cols[j] : 0.5f;
      }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + 16 * mi + g + 8 * h;
        const float ai = i0 + r < s_i ? acc_rows[i0 + r] : 0.5f;
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const int c = wn + 8 * ni + 2 * t;
          const int o = r * SP + c;
          const float c0 = (float)count[mi][ni][2 * h];
          const float c1 = (float)count[mi][ni][2 * h + 1];
          if (ERR) {
            n_sum[mi][ni][2 * h] += count[mi][ni][2 * h];
            n_sum[mi][ni][2 * h + 1] += count[mi][ni][2 * h + 1];
          }
          if (Sc != nullptr) {
            float f[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              f[e] = pair_score(p, aj[ni][e],
                                pr_independent(p, ai, aj[ni][e], n_false), s,
                                one_m_s);
            const float2 was = add ? *reinterpret_cast<const float2*>(Sc + o)
                                   : make_float2(0.f, 0.f);
            *reinterpret_cast<float2*>(Sc + o) =
                make_float2(__fadd_rn(was.x, __fmul_rn(f[0], c0)),
                            __fadd_rn(was.y, __fmul_rn(f[1], c1)));
          }
          if (Sx != nullptr) {
            const float x0 = ERR ? __fmul_rn(d, c0) : c0;
            const float x1 = ERR ? __fmul_rn(d, c1) : c1;
            const float2 was = add ? *reinterpret_cast<const float2*>(Sx + o)
                                   : make_float2(0.f, 0.f);
            *reinterpret_cast<float2*>(Sx + o) =
                make_float2(__fadd_rn(was.x, x0), __fadd_rn(was.y, x1));
          }
        }
      }
  };

  for (int it = 0; it < total; ++it) {
    fm::cp_async_wait<STAGES - 2>();            // slice it has landed
    __syncthreads();                            // ... for every thread; slice it-1 consumed
    if (it + STAGES - 1 < total) load(it + STAGES - 1);
    fm::cp_async_commit();
    const int sl = it % spb;
    if (sl == 0) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) count[mi][ni][e] = 0;
    }
    const int8_t* As = ring + (it % STAGES) * STAGE;
    cm::count_slice<MT, NT, KS>(count, As, As + TM * PB, wm, wn,
                                block_e - sl * KS);
    if (SUMS && sl == spb - 1)
      put(b_lo + it / spb, sums, sums + TM * SP, it >= spb);
  }
  fm::cp_async_wait<0>();

  // out: one staged channel, into rows i0.., columns j0.. of `out`, in
  // coalesced 16-byte read-modify-writes (4-byte ones unless vec_out)
  const long long at = (long long)i0 * s_j + j0;
  auto write_out = [&](const float* St, float* out, bool add) {
    cm::store_tile<TM, TN, SP, THREADS>(St, out + at, s_j, s_i - i0, s_j - j0,
                                        add, vec_out);
  };

  if (ERR) {
    // the outputs themselves with one range, else this range's slice of the
    // workspace, (n_splits, 3, S_i, S_j): C→, n, err
    const long long plane = (long long)s_i * s_j;
    float* oc = c_fwd;
    float* on = cnt;
    float* oe = err;
    bool add = accumulate != 0;
    if (n_splits > 1) {
      oc = work + (long long)split * 3 * plane;
      on = oc + plane;
      oe = oc + 2 * plane;
      add = false;
    }
    __syncthreads();                            // every thread's sums are in
    write_out(sums, oc, add);
    write_out(sums + TM * SP, oe, add);
    __syncthreads();                            // C→ has left its staging
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
          *reinterpret_cast<float2*>(sums + (wm + 16 * mi + g + 8 * h) * SP +
                                     wn + 8 * ni + 2 * t) =
              make_float2((float)n_sum[mi][ni][2 * h],
                          (float)n_sum[mi][ni][2 * h + 1]);
    __syncthreads();
    write_out(sums, on, add);
  } else if (SUMS) {
    __syncthreads();                            // every thread's sums are in
    write_out(sums, c_fwd, accumulate);
    write_out(sums + TM * SP, cnt, accumulate);
  } else {
    float* St = reinterpret_cast<float*>(ring);
    __syncthreads();                            // every warp is done with the ring
    put(0, St, nullptr, false);
    __syncthreads();
    write_out(St, c_fwd, accumulate);
    __syncthreads();
    put(0, nullptr, St, false);
    __syncthreads();
    write_out(St, cnt, accumulate);
  }
}

// The second pass of a split B2 launch: for every output element, the
// ranges' partial sums in range order, from zero, then written to the output
// or, with `accumulate`, added to it once. One thread an element.
__global__ void __launch_bounds__(THREADS)
copyscore_err_reduce_kernel(const float* __restrict__ work,
                            float* __restrict__ c_fwd, float* __restrict__ cnt,
                            float* __restrict__ err, long long plane,
                            int n_splits, int accumulate) {
  const long long n = 3 * plane;
  const long long x = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (x >= n) return;
  float sum = 0.0f;
  for (int k = 0; k < n_splits; ++k)
    sum = __fadd_rn(sum, work[(long long)k * n + x]);
  const int ch = (int)(x / plane);
  float* out = (ch == 0 ? c_fwd : ch == 1 ? cnt : err) + (x - ch * plane);
  *out = accumulate ? __fadd_rn(*out, sum) : sum;
}

template <bool SUMS, bool ERR>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(copyscore_tc_kernel<SUMS, ERR>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<SUMS>());
}

template <bool SUMS, bool ERR>
cudaError_t launch(const int8_t* v_rows, const int8_t* v_cols,
                   const float* acc_rows, const float* acc_cols,
                   const float* p_blk, const float* delta_blk, float* c_fwd,
                   float* cnt, float* err, float* work, int s_i, int s_j,
                   int n_blocks, int block_e, int n_splits, int accumulate,
                   float s, float one_m_s, float n_false,
                   cudaStream_t stream) {
  if (n_splits < 1 || n_splits > n_blocks ||
      (n_splits > 1 && (!ERR || work == nullptr)))
    return cudaErrorInvalidValue;
  const long long blocks =
      (long long)((s_i + TM - 1) / TM) * ((s_j + TN - 1) / TN) * n_splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem<SUMS, ERR>();
  if (e != cudaSuccess) return e;
  const bool vec16 = block_e % 16 == 0 && (uintptr_t)v_rows % 16 == 0 &&
                     (uintptr_t)v_cols % 16 == 0;
  bool vec_out = s_j % 4 == 0;
  if (n_splits > 1)
    vec_out = vec_out && (uintptr_t)work % 16 == 0;
  else
    vec_out = vec_out && (uintptr_t)c_fwd % 16 == 0 &&
              (uintptr_t)cnt % 16 == 0 && (uintptr_t)err % 16 == 0;
  copyscore_tc_kernel<SUMS, ERR><<<(unsigned)blocks, THREADS,
                                   smem_bytes<SUMS>(), stream>>>(
      v_rows, v_cols, acc_rows, acc_cols, p_blk, delta_blk, c_fwd, cnt, err,
      work, s_i, s_j, n_blocks, block_e, n_splits, accumulate, (int)vec16,
      (int)vec_out, s, one_m_s, n_false);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 1) return e;
  const long long plane = (long long)s_i * s_j;
  copyscore_err_reduce_kernel<<<(unsigned)((3 * plane + THREADS - 1) / THREADS),
                                THREADS, 0, stream>>>(
      work, c_fwd, cnt, err, plane, n_splits, accumulate);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// Launches one pair block on `stream` and returns cudaGetLastError() right
// after the launch (cudaSuccess with nothing launched when S_i or S_j is 0).
// Shapes: v_rows (S_i, n_blocks·block_e) and v_cols (S_j, n_blocks·block_e)
// int8, row-major, block_e % 4 == 0, both starting on a 4-byte boundary;
// acc_rows (S_i,), acc_cols (S_j,), p_blk (n_blocks,), and delta_blk
// (n_blocks,) when err is not null, float32; c_fwd, cnt and err (S_i, S_j)
// float32, row-major. err == null selects B3 (copyscore_tc_kernel<·,
// false>), else B2 (copyscore_tc_kernel<true, true>) over n_splits ranges
// of entry blocks
// (1 ≤ n_splits ≤ n_blocks; with n_splits > 1, `work` holds (n_splits, 3,
// S_i, S_j) float32 of scratch and a second kernel sums the ranges; B3
// ignores both). accumulate != 0 adds the block's sums to the outputs
// instead of writing them. one_m_s is 1 − s rounded to float from double,
// as the host-side expression gives it.
int copyscore_launch(const void* v_rows, const void* v_cols,
                     const void* acc_rows, const void* acc_cols,
                     const void* p_blk, const void* delta_blk, void* c_fwd,
                     void* cnt, void* err, void* work, int s_i, int s_j,
                     int n_blocks, int block_e, int n_splits, int accumulate,
                     float s, float one_m_s, float n_false, void* stream) {
  if (s_i <= 0 || s_j <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* vr = (const int8_t*)v_rows;
  const int8_t* vc = (const int8_t*)v_cols;
  const float* ar = (const float*)acc_rows;
  const float* ac = (const float*)acc_cols;
  const float* pb = (const float*)p_blk;
  float* cf = (float*)c_fwd;
  float* cn = (float*)cnt;
  if (err != nullptr)
    return (int)tc::launch<true, true>(vr, vc, ar, ac, pb,
                                       (const float*)delta_blk, cf, cn,
                                       (float*)err, (float*)work, s_i, s_j,
                                       n_blocks, block_e, n_splits, accumulate,
                                       s, one_m_s, n_false, st);
  if (n_blocks > 1)
    return (int)tc::launch<true, false>(vr, vc, ar, ac, pb, nullptr, cf, cn,
                                        nullptr, nullptr, s_i, s_j, n_blocks,
                                        block_e, 1, accumulate, s, one_m_s,
                                        n_false, st);
  return (int)tc::launch<false, false>(vr, vc, ar, ac, pb, nullptr, cf, cn,
                                       nullptr, nullptr, s_i, s_j, n_blocks,
                                       block_e, 1, accumulate, s, one_m_s,
                                       n_false, st);
}

// B3's dynamic shared memory and resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) with one entry block a
// launch, as the store path launches it.
int copyscore_info(int* smem_bytes, int* blocks_per_sm) {
  cudaError_t err = tc::allow_smem<false, false>();
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = tc::smem_bytes<false>();
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, tc::copyscore_tc_kernel<false, false>, THREADS,
      tc::smem_bytes<false>());
}

// The same for B2 (copyscore_tc_kernel<true, true>).
int copyscore_err_info(int* smem_bytes, int* blocks_per_sm) {
  cudaError_t err = tc::allow_smem<true, true>();
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = tc::smem_bytes<true>();
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, tc::copyscore_tc_kernel<true, true>, THREADS,
      tc::smem_bytes<true>());
}

const char* copyscore_single_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
