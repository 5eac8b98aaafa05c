// Single-direction copyscore over one rectangular pair block, for Hopper
// (sm_90a).
//
// Replaces two TPU kernels of the JAX package, reached there through
// copyscore_pallas (kernels/copyscore.py):
//   _copyscore_kernel      (C→, n)       — ops.copyscore, ops.copyscore_store,
//                                           ops.copyscore_tile without δ:
//                                           copyscore_tc_kernel (B3);
//   _copyscore_err_kernel  (C→, n, err)  — ops.copyscore_tile with δ:
//                                           copyscore_err_kernel (B2).
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
// cores (__dp4a, 4 multiply-adds an instruction) that product alone held the
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
// 5× the bytes bound: the count product (a library int8 GEMM alone takes
// 2.4 ms), the ~17 GB of incidence the 128×128 tiles read from L2, the
// per-pair epilogue and the output traffic, overlapped only across the two
// blocks an SM, share that time in proportions not yet measured.
//
// B2, copyscore_err_kernel: the CUDA-core design, unchanged. Grid
// (ceil(S_j/64), ceil(S_i/64)); a block owns 64×64 pairs with 256 threads,
// each holding a 4×4 piece of every channel in registers plus 16 int32
// counts from __dp4a over K-slices of 64 entries staged through shared
// memory as 32-bit words (row pitch 20 words, conflict-free 16-byte reads;
// the staging and the dp4a loop are B1's, copyscore_fused.cu). Its dp4a
// rate bounds it; at the legacy scan's 256×256 tiles it runs 16 blocks on
// 132 SMs.
//
// Numerics. Every floating-point step is an explicit IEEE-rounded intrinsic
// and logf is the accurate one (no --use_fast_math): nothing is contracted
// into an FMA. pr_independent and pair_score are B1's functions, copied
// unchanged (a1·a2 first), and B3 sums from zero in block order, so on one
// entry block B3's C→ equals, bit for bit, the grid that B1's C→ and C←
// stacks scatter into: the counts are exact whichever unit computes them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "copyscore_mma.cuh"

namespace {

constexpr int BM = 64;        // B2: block edge (pairs)
constexpr int KW = 16;        // B2: K-slice in 32-bit words (64 int8 entries)
constexpr int PITCH = KW + 4; // B2: shared-memory row pitch in words
constexpr int THREADS = 256;

// Eq. (3), associated so that it is bitwise symmetric in a1 and a2.
__device__ __forceinline__ float pr_independent(float p, float a1, float a2,
                                                float n_false) {
  const float t1 = __fmul_rn(p, __fmul_rn(a1, a2));
  const float t2 = __fdiv_rn(
      __fmul_rn(__fsub_rn(1.0f, p),
                __fmul_rn(__fsub_rn(1.0f, a1), __fsub_rn(1.0f, a2))),
      n_false);
  return __fadd_rn(t1, t2);
}

// Eq. (6): the same-value score with `a_src` the copied source's accuracy.
__device__ __forceinline__ float pair_score(float p, float a_src, float pr_ind,
                                            float s, float one_m_s) {
  const float pr_src = __fadd_rn(__fmul_rn(p, a_src),
                                 __fmul_rn(__fsub_rn(1.0f, p),
                                           __fsub_rn(1.0f, a_src)));
  return logf(__fadd_rn(one_m_s, __fdiv_rn(__fmul_rn(s, pr_src), pr_ind)));
}

__global__ void __launch_bounds__(THREADS)
copyscore_err_kernel(const int8_t* __restrict__ v_rows,
                     const int8_t* __restrict__ v_cols,
                     const float* __restrict__ acc_rows,
                     const float* __restrict__ acc_cols,
                     const float* __restrict__ p_blk,
                     const float* __restrict__ delta_blk,
                     float* __restrict__ c_fwd, float* __restrict__ cnt,
                     float* __restrict__ err, int s_i, int s_j, int n_blocks,
                     int block_e, int accumulate, float s, float one_m_s,
                     float n_false) {
  __shared__ __align__(16) int32_t As[BM][PITCH];
  __shared__ __align__(16) int32_t Bs[BM][PITCH];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int i0 = blockIdx.y * BM;   // rows this block owns
  const int j0 = blockIdx.x * BM;   // columns this block owns
  const long long row_bytes = (long long)n_blocks * block_e;
  const int words = block_e >> 2;

  float ai[4], aj[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = i0 + ty + 16 * m;
    ai[m] = i < s_i ? acc_rows[i] : 0.5f;
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int j = j0 + tx + 16 * n;
    aj[n] = j < s_j ? acc_cols[j] : 0.5f;
  }

  float rf[4][4], rn[4][4], re[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) rf[m][n] = rn[m][n] = re[m][n] = 0.0f;

  for (int b = 0; b < n_blocks; ++b) {
    const long long off = (long long)b * block_e;
    int32_t count[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) count[m][n] = 0;

    for (int k0 = 0; k0 < words; k0 += KW) {
#pragma unroll
      for (int q = 0; q < (BM * KW) / THREADS; ++q) {
        const int idx = tid + THREADS * q;
        const int row = idx / KW;
        const int kw = idx % KW;
        const int k = k0 + kw;
        int32_t va = 0, vb = 0;
        if (k < words) {
          if (i0 + row < s_i)
            va = reinterpret_cast<const int32_t*>(
                v_rows + (long long)(i0 + row) * row_bytes + off)[k];
          if (j0 + row < s_j)
            vb = reinterpret_cast<const int32_t*>(
                v_cols + (long long)(j0 + row) * row_bytes + off)[k];
        }
        As[row][kw] = va;
        Bs[row][kw] = vb;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KW; kk += 4) {
        int4 a[4], bv[4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          a[m] = *reinterpret_cast<const int4*>(&As[ty + 16 * m][kk]);
#pragma unroll
        for (int n = 0; n < 4; ++n)
          bv[n] = *reinterpret_cast<const int4*>(&Bs[tx + 16 * n][kk]);
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            int32_t c = count[m][n];
            c = __dp4a(a[m].x, bv[n].x, c);
            c = __dp4a(a[m].y, bv[n].y, c);
            c = __dp4a(a[m].z, bv[n].z, c);
            c = __dp4a(a[m].w, bv[n].w, c);
            count[m][n] = c;
          }
      }
      __syncthreads();
    }

    const float p = p_blk[b];
    const float d = delta_blk[b];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float c = (float)count[m][n];
        const float pr = pr_independent(p, ai[m], aj[n], n_false);
        const float f = pair_score(p, aj[n], pr, s, one_m_s);
        rf[m][n] = __fadd_rn(rf[m][n], __fmul_rn(f, c));
        rn[m][n] = __fadd_rn(rn[m][n], c);
        re[m][n] = __fadd_rn(re[m][n], __fmul_rn(d, c));
      }
  }

#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = i0 + ty + 16 * m;
    if (i >= s_i) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int j = j0 + tx + 16 * n;
      if (j >= s_j) continue;
      const long long o = (long long)i * s_j + j;
      if (accumulate) {
        c_fwd[o] = __fadd_rn(c_fwd[o], rf[m][n]);
        cnt[o] = __fadd_rn(cnt[o], rn[m][n]);
        err[o] = __fadd_rn(err[o], re[m][n]);
      } else {
        c_fwd[o] = rf[m][n];
        cnt[o] = rn[m][n];
        err[o] = re[m][n];
      }
    }
  }
}

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
template <bool SUMS>
constexpr int smem_bytes() {
  return SUMS ? RING + 2 * CHANNEL : (RING > CHANNEL ? RING : CHANNEL);
}

template <bool SUMS>
__global__ void __launch_bounds__(THREADS, SUMS ? 1 : 2)
copyscore_tc_kernel(const int8_t* __restrict__ v_rows,
                    const int8_t* __restrict__ v_cols,
                    const float* __restrict__ acc_rows,
                    const float* __restrict__ acc_cols,
                    const float* __restrict__ p_blk,
                    float* __restrict__ c_fwd, float* __restrict__ cnt,
                    int s_i, int s_j, int n_blocks, int block_e,
                    int accumulate, int vec16, int vec_out, float s,
                    float one_m_s, float n_false) {
  extern __shared__ float4 smem_f4[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem_f4);
  float* sums = reinterpret_cast<float*>(ring + (SUMS ? RING : 0));

  // this block's tile, in raster groups of GROUP tile rows
  const int n_tm = (s_i + TM - 1) / TM;
  const int n_tn = (s_j + TN - 1) / TN;
  const int per_group = GROUP * n_tn;
  const int first = (int)blockIdx.x / per_group * GROUP;
  const int rows_here = min(n_tm - first, GROUP);
  const int in_group = (int)blockIdx.x % per_group;
  const int i0 = (first + in_group % rows_here) * TM;
  const int j0 = (in_group / rows_here) * TN;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 2) * WM;              // the warp's rows in the tile
  const int wn = (warp & 3) * WN;               // ... and columns
  const long long row_bytes = (long long)n_blocks * block_e;
  const int spb = (block_e + KS - 1) / KS;      // K-slices an entry block
  const int total = n_blocks * spb;

  auto load = [&](int it) {
    const int sl = it % spb;
    const long long k0 = (long long)(it / spb) * block_e + sl * KS;
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

  // The Eq. 6 epilogue of entry block b from this thread's counts: C→ (f·c)
  // into Sc and n (c) into Sn, each added to what the slot holds with
  // `add`, else to 0; a null channel is skipped. Slots are this thread's
  // own: rows wm + 16·mi + g (+ 8), columns wn + 8·ni + 2t (+ 1).
  auto put = [&](int b, float* Sc, float* Sn, bool add) {
    const float p = p_blk[b];
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
          if (Sn != nullptr) {
            const float2 was = add ? *reinterpret_cast<const float2*>(Sn + o)
                                   : make_float2(0.f, 0.f);
            *reinterpret_cast<float2*>(Sn + o) =
                make_float2(__fadd_rn(was.x, c0), __fadd_rn(was.y, c1));
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
    const int8_t* Bs = As + TM * PB;
#pragma unroll
    for (int kk = 0; kk < KS / 32; ++kk) {
      if (sl * KS + kk * 32 >= block_e) break;  // past the block: all zero
      uint32_t bf[NT / 2][4];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        cm::ldsm_x4(bf[np], Bs + (wn + 16 * np + (lane & 7) + ((lane >> 4) << 3)) * PB +
                                kk * 32 + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        uint32_t af[4];
        cm::ldsm_x4(af, As + (wm + 16 * mi + (lane & 15)) * PB + kk * 32 +
                            (lane >> 4) * 16);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          cm::mma(count[mi][2 * np], af, bf[np][0], bf[np][1]);
          cm::mma(count[mi][2 * np + 1], af, bf[np][2], bf[np][3]);
        }
      }
    }
    if (SUMS && sl == spb - 1) put(it / spb, sums, sums + TM * SP, it >= spb);
  }
  fm::cp_async_wait<0>();

  // out: one staged channel, into rows i0.., columns j0.. of `out`, in
  // coalesced 16-byte read-modify-writes (4-byte ones unless vec_out)
  auto write_out = [&](const float* St, float* out) {
    for (int idx = threadIdx.x; idx < TM * TN / 4; idx += THREADS) {
      const int r = idx / (TN / 4);
      const int c = (idx % (TN / 4)) * 4;
      const int i = i0 + r;
      const int j = j0 + c;
      if (i >= s_i || j >= s_j) continue;
      const float4 x = *reinterpret_cast<const float4*>(St + r * SP + c);
      float* o = out + (long long)i * s_j + j;
      if (vec_out) {
        float4 y = x;
        if (accumulate) {
          const float4 a = *reinterpret_cast<const float4*>(o);
          y = make_float4(__fadd_rn(a.x, x.x), __fadd_rn(a.y, x.y),
                          __fadd_rn(a.z, x.z), __fadd_rn(a.w, x.w));
        }
        *reinterpret_cast<float4*>(o) = y;
      } else {
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j + e < s_j) o[e] = accumulate ? __fadd_rn(o[e], xs[e]) : xs[e];
      }
    }
  };

  if (SUMS) {
    __syncthreads();                            // every thread's sums are in
    write_out(sums, c_fwd);
    write_out(sums + TM * SP, cnt);
  } else {
    float* St = reinterpret_cast<float*>(ring);
    __syncthreads();                            // every warp is done with the ring
    put(0, St, nullptr, false);
    __syncthreads();
    write_out(St, c_fwd);
    __syncthreads();
    put(0, nullptr, St, false);
    __syncthreads();
    write_out(St, cnt);
  }
}

template <bool SUMS>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(copyscore_tc_kernel<SUMS>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<SUMS>());
}

template <bool SUMS>
cudaError_t launch(const int8_t* v_rows, const int8_t* v_cols,
                   const float* acc_rows, const float* acc_cols,
                   const float* p_blk, float* c_fwd, float* cnt, int s_i,
                   int s_j, int n_blocks, int block_e, int accumulate,
                   float s, float one_m_s, float n_false,
                   cudaStream_t stream) {
  const long long tiles =
      (long long)((s_i + TM - 1) / TM) * ((s_j + TN - 1) / TN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<SUMS>();
  if (err != cudaSuccess) return err;
  const bool vec16 = block_e % 16 == 0 && (uintptr_t)v_rows % 16 == 0 &&
                     (uintptr_t)v_cols % 16 == 0;
  const bool vec_out = s_j % 4 == 0 && (uintptr_t)c_fwd % 16 == 0 &&
                       (uintptr_t)cnt % 16 == 0;
  copyscore_tc_kernel<SUMS><<<(unsigned)tiles, THREADS, smem_bytes<SUMS>(),
                              stream>>>(
      v_rows, v_cols, acc_rows, acc_cols, p_blk, c_fwd, cnt, s_i, s_j,
      n_blocks, block_e, accumulate, (int)vec16, (int)vec_out, s, one_m_s,
      n_false);
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
// float32, row-major. err == null selects B3 (copyscore_tc_kernel), else
// B2 (copyscore_err_kernel). accumulate != 0 adds the block's sums to the
// outputs instead of writing them. one_m_s is 1 − s rounded to float from
// double, as the host-side expression gives it.
int copyscore_launch(const void* v_rows, const void* v_cols,
                     const void* acc_rows, const void* acc_cols,
                     const void* p_blk, const void* delta_blk, void* c_fwd,
                     void* cnt, void* err, int s_i, int s_j, int n_blocks,
                     int block_e, int accumulate, float s, float one_m_s,
                     float n_false, void* stream) {
  if (s_i <= 0 || s_j <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (err != nullptr) {
    dim3 grid((unsigned)((s_j + BM - 1) / BM), (unsigned)((s_i + BM - 1) / BM));
    copyscore_err_kernel<<<grid, THREADS, 0, st>>>(
        (const int8_t*)v_rows, (const int8_t*)v_cols, (const float*)acc_rows,
        (const float*)acc_cols, (const float*)p_blk, (const float*)delta_blk,
        (float*)c_fwd, (float*)cnt, (float*)err, s_i, s_j, n_blocks, block_e,
        accumulate, s, one_m_s, n_false);
    return (int)cudaGetLastError();
  }
  const int8_t* vr = (const int8_t*)v_rows;
  const int8_t* vc = (const int8_t*)v_cols;
  const float* ar = (const float*)acc_rows;
  const float* ac = (const float*)acc_cols;
  const float* pb = (const float*)p_blk;
  if (n_blocks > 1)
    return (int)tc::launch<true>(vr, vc, ar, ac, pb, (float*)c_fwd,
                                 (float*)cnt, s_i, s_j, n_blocks, block_e,
                                 accumulate, s, one_m_s, n_false, st);
  return (int)tc::launch<false>(vr, vc, ar, ac, pb, (float*)c_fwd,
                                (float*)cnt, s_i, s_j, n_blocks, block_e,
                                accumulate, s, one_m_s, n_false, st);
}

// B3's dynamic shared memory and resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) with one entry block a
// launch, as the store path launches it.
int copyscore_info(int* smem_bytes, int* blocks_per_sm) {
  cudaError_t err = tc::allow_smem<false>();
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = tc::smem_bytes<false>();
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, tc::copyscore_tc_kernel<false>, THREADS,
      tc::smem_bytes<false>());
}

const char* copyscore_single_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
