// Tensor-core building blocks shared by the bf16 flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu), for Hopper (sm_90a):
// asynchronous global→shared copies (cp.async with wait_group), 8×8 matrix
// loads from shared memory (ldmatrix, plain and transposed), the bf16
// m16n8k16 product with float32 accumulators (mma.sync), and the bf16
// hi + lo split of a float32 operand.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16×16, row-major), four 32-bit registers of two bf16 each:
//     a0 = A[g][2t..2t+1], a1 = A[g+8][2t..2t+1],
//     a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9];
//   B (16×8, k × n), two registers: b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g];
//   C (16×8 float32): c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1].
// So the accumulators of two neighbouring n-tiles of one product are, as
// they stand, the A operand of the next product over those 16 columns:
//   a0 = (c0, c1) of tile 2k, a1 = (c2, c3) of tile 2k,
//   a2 = (c0, c1) of tile 2k+1, a3 = (c2, c3) of tile 2k+1.
//
// The split. A float32 x enters the tensor cores as the unevaluated sum of
// two bf16 values, hi = bf16(x) and lo = bf16(x − hi) (both round to
// nearest even, 8 significant bits). x − hi is exact in float32 and at most
// half an ulp of hi, and lo rounds it once more, so |x − (hi + lo)| ≤
// 2⁻¹⁷·|x| (attained near x = 1 + 2⁻⁹; every float32 of [1, 2) is checked
// in tests/test_torch_flash_bwd.py). Each of hi·y and lo·y for a bf16 y is
// exact in the float32 accumulator, so two passes give Σ x·y to float32
// summation round-off.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash_mma {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;              // the TPU kernel's finite −∞
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr uint32_t BF16_ONES = 0x3F803F80u;    // two bf16 1.0

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, asynchronously; `valid` false zero-fills the
// destination and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global → shared, asynchronously, zero-filled unless `valid`.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + R) of a row-major (n_rows, D) bf16 matrix into shared
// memory with row pitch D + 8 (16-byte aligned rows whose starts fall on
// distinct bank groups, so ldmatrix reads are conflict-free), by the block's
// NT threads; rows at or past n_rows are zero-filled.
template <int D, int R, int NT>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src, int row0,
                                        int n_rows) {
  constexpr int C = D / 8;                      // 16-byte chunks per row
#pragma unroll
  for (int j = 0; j < (R * C + NT - 1) / NT; ++j) {
    const int i = (int)threadIdx.x + j * NT;
    if (R * C % NT != 0 && i >= R * C) break;
    const int r = i / C;
    const int c = (i % C) * 8;
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + r * (D + 8) + c,
               src + (size_t)(ok ? row0 + r : 0) * D + c, ok);
  }
}

// Four 8×8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a·b, one m16n8k16 bf16 product with float32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) → hi = (bf16(x), bf16(y)) and lo = (bf16(x − hi.x), bf16(y − hi.y)),
// x in the low half of each register as the A fragment wants it.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// The A fragments (hi and lo) of the 16 columns [16k, 16k + 16) of a
// float32 accumulator tile held as n-tiles acc[2k], acc[2k + 1].
__device__ __forceinline__ void split_a(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

// Key c is visible from query r.
__device__ __forceinline__ bool visible(int r, int c, int Sq, int Sk,
                                        int causal, int window) {
  return r < Sq && c < Sk && (!causal || r >= c) &&
         (window <= 0 || r - c < window);
}

}  // namespace flash_mma
