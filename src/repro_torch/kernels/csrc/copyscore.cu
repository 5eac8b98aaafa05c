// Single-direction copyscore over one rectangular pair block, for Hopper
// (sm_90a).
//
// Replaces two TPU kernels of the JAX package, reached there through
// copyscore_pallas (kernels/copyscore.py):
//   _copyscore_kernel      (C→, n)       — ops.copyscore, ops.copyscore_store,
//                                           ops.copyscore_tile without δ;
//   _copyscore_err_kernel  (C→, n, err)  — ops.copyscore_tile with δ.
// One template covers both: WITH_ERR adds the error channel.
//
// Rows copy from columns. For every pair (i, j) of the S_i × S_j block and
// every entry block b of width block_e (one p̂_b, and δ_b with WITH_ERR):
//   count = V_rows[i, b] · V_cols[j, b]               int8 -> exact int32
//   f→    = Eq. 6 from (a_i, a_j, p̂_b)                a_j the copied source
//   C→ += f→·count    n += count    err += δ_b·count
// The sums start from zero and run over the entry blocks in order, in
// registers; each output is then written once — or, with `accumulate`, added
// once to what the output already holds (the store path sums its chunks on
// the device that way, one launch per chunk, in chunk order).
//
// What bounds it on this card. Per pair and entry block: 2·block_e int8
// operations and ~21 float32 operations (one logf and two divisions among
// them). Bytes: each incidence row read once, the outputs written once (read
// and written with `accumulate`). For the store's full square at S = 16384
// and one 4096-wide chunk a launch that is 2.2e12 int8 operations (1.1 ms at
// the int8 tensor-core peak) against 4.3 GB of accumulators read and written
// (1.3 ms at 3.35 TB/s): bytes bound it. This first version computes the
// count product with __dp4a on the CUDA cores (4 multiply-adds an
// instruction), far below the tensor cores' int8 rate, so in practice its dp4a
// instruction rate bounds it; wgmma s8·s8→s32 with TMA staging is left for
// later.
//
// Design. Grid (ceil(S_j/64), ceil(S_i/64)); a block owns 64×64 pairs with
// 256 threads, each holding a 4×4 piece of every channel in registers plus
// 16 int32 counts. K-slices of 64 entries of the block's 64 rows and 64
// columns are staged through shared memory as 32-bit words (4 entries each:
// block_e must be a multiple of 4, and the rows start on 4-byte boundaries);
// words past the entry block's end and rows past S_i / S_j are zero-filled,
// and zero entries are inert, so ragged S_i, S_j and narrow blocks need no
// padding from the caller. The staging and the dp4a loop are B1's
// (copyscore_fused.cu), with the row pitch of 20 words that keeps the
// 16-byte shared reads free of bank conflicts.
//
// Numerics. Every floating-point step is an explicit IEEE-rounded intrinsic
// and logf is the accurate one (no --use_fast_math): nothing is contracted
// into an FMA. pr_independent and pair_score are B1's functions, copied
// unchanged (a1·a2 first), so on one entry block this kernel's C→ equals, bit
// for bit, the grid that B1's C→ and C← stacks scatter into.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // block edge (pairs)
constexpr int KW = 16;        // K-slice in 32-bit words (64 int8 entries)
constexpr int PITCH = KW + 4; // shared-memory row pitch in words
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

template <bool WITH_ERR>
__global__ void __launch_bounds__(THREADS)
copyscore_kernel(const int8_t* __restrict__ v_rows,
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
    const float d = WITH_ERR ? delta_blk[b] : 0.0f;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float c = (float)count[m][n];
        const float pr = pr_independent(p, ai[m], aj[n], n_false);
        const float f = pair_score(p, aj[n], pr, s, one_m_s);
        rf[m][n] = __fadd_rn(rf[m][n], __fmul_rn(f, c));
        rn[m][n] = __fadd_rn(rn[m][n], c);
        if (WITH_ERR) re[m][n] = __fadd_rn(re[m][n], __fmul_rn(d, c));
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
        if (WITH_ERR) err[o] = __fadd_rn(err[o], re[m][n]);
      } else {
        c_fwd[o] = rf[m][n];
        cnt[o] = rn[m][n];
        if (WITH_ERR) err[o] = re[m][n];
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches one pair block on `stream` and returns cudaGetLastError() right
// after the launch (cudaSuccess with nothing launched when S_i or S_j is 0).
// Shapes: v_rows (S_i, n_blocks·block_e) and v_cols (S_j, n_blocks·block_e)
// int8, row-major, block_e % 4 == 0, both starting on a 4-byte boundary;
// acc_rows (S_i,), acc_cols (S_j,), p_blk (n_blocks,), and delta_blk
// (n_blocks,) when err is not null, float32; c_fwd, cnt and err (S_i, S_j)
// float32, row-major. err == null selects the kernel without the error
// channel. accumulate != 0 adds the block's sums to the outputs instead of
// writing them. one_m_s is 1 − s rounded to float from double, as the
// host-side expression gives it.
int copyscore_launch(const void* v_rows, const void* v_cols,
                     const void* acc_rows, const void* acc_cols,
                     const void* p_blk, const void* delta_blk, void* c_fwd,
                     void* cnt, void* err, int s_i, int s_j, int n_blocks,
                     int block_e, int accumulate, float s, float one_m_s,
                     float n_false, void* stream) {
  if (s_i <= 0 || s_j <= 0) return (int)cudaSuccess;
  dim3 grid((unsigned)((s_j + BM - 1) / BM), (unsigned)((s_i + BM - 1) / BM));
  cudaStream_t st = (cudaStream_t)stream;
  if (err != nullptr)
    copyscore_kernel<true><<<grid, THREADS, 0, st>>>(
        (const int8_t*)v_rows, (const int8_t*)v_cols, (const float*)acc_rows,
        (const float*)acc_cols, (const float*)p_blk, (const float*)delta_blk,
        (float*)c_fwd, (float*)cnt, (float*)err, s_i, s_j, n_blocks, block_e,
        accumulate, s, one_m_s, n_false);
  else
    copyscore_kernel<false><<<grid, THREADS, 0, st>>>(
        (const int8_t*)v_rows, (const int8_t*)v_cols, (const float*)acc_rows,
        (const float*)acc_cols, (const float*)p_blk, nullptr, (float*)c_fwd,
        (float*)cnt, nullptr, s_i, s_j, n_blocks, block_e, accumulate, s,
        one_m_s, n_false);
  return (int)cudaGetLastError();
}

const char* copyscore_single_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
