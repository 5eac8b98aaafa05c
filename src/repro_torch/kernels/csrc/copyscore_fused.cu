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
// the group's chunks in registers, from zero and in chunk order, then adds
// that sum to the stack with one read-modify-write. That is the association
// of the JAX engine's `stacks + outs` (core/engine.py:974-975), where `outs`
// is the kernel's per-group sum. A (-1, -1) tile slot returns at once and
// leaves its stack rows untouched.
//
// What bounds it on this card. Per live tile and chunk: 2·T²·w int8
// operations (T²·w multiply-adds), two logf and two divisions per pair.
// Bytes per group: the (S_pad, Gc, w) slab read once, plus 5 × 4 B × T² per
// live tile read and written. With the engine's default of one chunk per
// group that is about 40 B per pair per chunk against 2·w int8 operations:
// below the int8 tensor cores' ridge (~590 op/B), so the roofline is the
// stack traffic unless groups grow. This first version does not reach it:
// it computes the count product with __dp4a on the CUDA cores (4
// multiply-adds per instruction, far below the tensor-core int8 rate), so in
// practice it is bound by its dp4a issue rate. wgmma, TMA staging, larger
// groups and a persistent schedule are left for later work.
//
// Design. Grid (n_tiles, ceil(T/64), ceil(T/64)); a block owns a 64×64 piece
// of one tile with 256 threads, each holding a 4×4 piece of all five
// channels in registers (80 floats) plus 16 int32 counts. Five 128×128 float
// accumulators would need 320 KiB, more than an SM's register file, so the
// block is 64×64. K-slices of 64 entries of the block's 64 rows and 64
// columns are staged through shared memory as 32-bit words (4 entries each;
// w is a multiple of 8, so rows are whole words, and a ragged last slice is
// zero-filled: zero entries are inert). Each thread reads its rows and
// columns as 16-byte vectors; the row pitch of 20 words keeps those reads
// free of bank conflicts.
//
// Numerics. Every floating-point step is an explicit IEEE-rounded intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn) and logf is the accurate
// one (build without --use_fast_math), so nothing is contracted into an FMA
// and the kernel follows the plain PyTorch version's separately rounded
// steps. pr_ind multiplies a_i·a_j first, which is symmetric in the two
// accuracies, and f→ and f← come from one __device__ function: on a diagonal
// tile C← equals C→ᵀ bit for bit, which the engine's scatter relies on.

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

__global__ void __launch_bounds__(THREADS)
copyscore_fused_kernel(const int8_t* __restrict__ v,
                       const float* __restrict__ acc,
                       const float* __restrict__ p_hat,
                       const float* __restrict__ delta,
                       const float* __restrict__ nout,
                       const int32_t* __restrict__ coords,
                       float* __restrict__ c_fwd, float* __restrict__ c_bwd,
                       float* __restrict__ cnt, float* __restrict__ cnt_out,
                       float* __restrict__ err, int tile, int gc, int w,
                       float s, float one_m_s, float n_false) {
  const int t = blockIdx.x;
  const int rb = coords[2 * t];
  const int cb = coords[2 * t + 1];
  if (rb < 0 || cb < 0) return;

  __shared__ __align__(16) int32_t As[BM][PITCH];
  __shared__ __align__(16) int32_t Bs[BM][PITCH];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int i0 = blockIdx.y * BM;   // rows of the tile this block owns
  const int j0 = blockIdx.z * BM;   // columns of the tile this block owns
  const long long r0 = (long long)rb * tile;
  const long long c0 = (long long)cb * tile;
  const long long row_bytes = (long long)gc * w;
  const int words = w >> 2;

  float ai[4], aj[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = i0 + ty + 16 * m;
    ai[m] = i < tile ? acc[r0 + i] : 0.5f;
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int j = j0 + tx + 16 * n;
    aj[n] = j < tile ? acc[c0 + j] : 0.5f;
  }

  float rf[4][4], rbw[4][4], rn[4][4], ro[4][4], re[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
      rf[m][n] = rbw[m][n] = rn[m][n] = ro[m][n] = re[m][n] = 0.0f;

  for (int g = 0; g < gc; ++g) {
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
          if (i0 + row < tile)
            va = reinterpret_cast<const int32_t*>(
                v + (r0 + i0 + row) * row_bytes + (long long)g * w)[k];
          if (j0 + row < tile)
            vb = reinterpret_cast<const int32_t*>(
                v + (c0 + j0 + row) * row_bytes + (long long)g * w)[k];
        }
        As[row][kw] = va;
        Bs[row][kw] = vb;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KW; kk += 4) {
        int4 a[4], b[4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          a[m] = *reinterpret_cast<const int4*>(&As[ty + 16 * m][kk]);
#pragma unroll
        for (int n = 0; n < 4; ++n)
          b[n] = *reinterpret_cast<const int4*>(&Bs[tx + 16 * n][kk]);
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            int32_t c = count[m][n];
            c = __dp4a(a[m].x, b[n].x, c);
            c = __dp4a(a[m].y, b[n].y, c);
            c = __dp4a(a[m].z, b[n].z, c);
            c = __dp4a(a[m].w, b[n].w, c);
            count[m][n] = c;
          }
      }
      __syncthreads();
    }

    const float p = p_hat[g];
    const float d = delta[g];
    const float mo = nout[g];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float c = (float)count[m][n];
        const float pr = pr_independent(p, ai[m], aj[n], n_false);
        const float f_fwd = pair_score(p, aj[n], pr, s, one_m_s);
        const float f_bwd = pair_score(p, ai[m], pr, s, one_m_s);
        rf[m][n] = __fadd_rn(rf[m][n], __fmul_rn(f_fwd, c));
        rbw[m][n] = __fadd_rn(rbw[m][n], __fmul_rn(f_bwd, c));
        rn[m][n] = __fadd_rn(rn[m][n], c);
        ro[m][n] = __fadd_rn(ro[m][n], __fmul_rn(mo, c));
        re[m][n] = __fadd_rn(re[m][n], __fmul_rn(d, c));
      }
  }

  const long long base = (long long)t * tile * tile;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = i0 + ty + 16 * m;
    if (i >= tile) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int j = j0 + tx + 16 * n;
      if (j >= tile) continue;
      const long long o = base + (long long)i * tile + j;
      c_fwd[o] = __fadd_rn(c_fwd[o], rf[m][n]);
      c_bwd[o] = __fadd_rn(c_bwd[o], rbw[m][n]);
      cnt[o] = __fadd_rn(cnt[o], rn[m][n]);
      cnt_out[o] = __fadd_rn(cnt_out[o], ro[m][n]);
      err[o] = __fadd_rn(err[o], re[m][n]);
    }
  }
}

}  // namespace

extern "C" {

// Launches one chunk group over `n_tiles` tile slots on `stream` and returns
// cudaGetLastError() right after the launch (cudaSuccess when n_tiles is 0:
// nothing is launched). Shapes: v (S_pad, gc, w) int8 with w % 8 == 0 and the
// base 16-byte aligned; acc (S_pad,); p_hat, delta, nout (gc,); coords
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
  const int nb = (tile + BM - 1) / BM;
  dim3 grid((unsigned)n_tiles, (unsigned)nb, (unsigned)nb);
  copyscore_fused_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)v, (const float*)acc, (const float*)p_hat,
      (const float*)delta, (const float*)nout, (const int32_t*)coords,
      (float*)c_fwd, (float*)c_bwd, (float*)cnt, (float*)cnt_out, (float*)err,
      tile, gc, w, s, one_m_s, n_false);
  return (int)cudaGetLastError();
}

const char* copyscore_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
