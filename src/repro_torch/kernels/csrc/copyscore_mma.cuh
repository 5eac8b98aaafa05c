// Int8 tensor-core building blocks for the copyscore kernels (copyscore.cu,
// copyscore_fused.cu), for Hopper (sm_90a): the s8·s8 → s32 m16n8k32
// product (mma.sync), its fragments loaded from shared memory with
// ldmatrix, the staging of K-slices of int8 incidence rows into shared
// memory by cp.async (flash_mma.cuh's copies), 16 bytes a copy where rows
// and entry blocks sit on 16-byte boundaries and 4 bytes a copy otherwise,
// one K-slice of a warp's count tile, and the store of a staged float32
// tile into a row-major output.
//
// The count product. count = A·Bᵀ with A = V_rows (rows × entries) and B =
// V_cols (columns × entries), both row-major with the entries contiguous:
// the "TN" layout that mma.m16n8k32.row.col takes as it stands, B's
// fragments being rows of V_cols.
//
// Fragment layouts of mma.m16n8k32 with .s8 operands (g = lane / 4,
// t = lane % 4); each 32-bit register of A and B holds four int8 entries
// k..k+3, the lowest entry in the lowest byte:
//   A (16×32, row-major): a0 = A[g][4t..4t+3],       a1 = A[g+8][4t..4t+3],
//                         a2 = A[g][16+4t..16+4t+3], a3 = A[g+8][16+4t..];
//   B (32×8, k × n):      b0 = B[4t..4t+3][g] = V_cols row g, entries 4t..,
//                         b1 = B[16+4t..16+4t+3][g];
//   C (16×8 int32):       c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1].
// Byte for byte these are the bf16 m16n8k16 layouts of flash_mma.cuh, with
// a row of 32 int8 entries in place of 16 bf16 values. So ldmatrix, whose
// 8×8 b16 matrices are 8 rows of 16 bytes, loads them as it loads bf16
// fragments: in an x4 load lane l gives the address of row l % 8 of matrix
// l / 8, and every thread receives in register i the 4 bytes 4t..4t+3 of
// row g of matrix i. Hence:
//   A, rows m..m+15, entries k..k+31: lane l addresses row m + l % 16 at
//     byte k + 16·(l / 16); registers 0..3 are a0..a3.
//   B, columns n..n+15, entries k..k+31: lane l addresses row
//     n + l % 8 + 8·(l / 16) of V_cols at byte k + 16·((l / 8) % 2);
//     registers 0, 1 are (b0, b1) of columns n..n+7 and registers 2, 3
//     those of columns n+8..n+15.
// The accumulators are exact: an int32 count of 0/1 products.

#pragma once

#include <stdint.h>

#include "flash_mma.cuh"

namespace copyscore_mma {

// Four 8×8 b16 matrices (8 rows of 16 bytes each) from shared memory; lane
// l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const int8_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(flash_mma::smem_u32(p)));
}

// c += a·b, one m16n8k32 int8 product with int32 accumulators.
__device__ __forceinline__ void mma(int32_t (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes [k0, k0 + KS) of rows [row0, row0 + R) of a row-major int8 matrix
// of row_bytes bytes a row, into shared memory with row pitch KS + 16, by
// the block's NT threads, asynchronously (the caller commits the group).
// The pitch keeps rows 16-byte aligned and puts the starts of any 8
// consecutive rows on distinct 16-byte bank groups, so ldmatrix reads them
// without conflicts. Rows at or past n_rows and bytes at or past k0 +
// n_valid are zero-filled: zero entries add nothing to a count. vec16:
// 16-byte copies (row_bytes, k0 and n_valid multiples of 16, src 16-byte
// aligned); else 4-byte copies (the same on 4-byte boundaries).
template <int R, int KS, int NT>
__device__ __forceinline__ void cp_slice(int8_t* dst, const int8_t* src,
                                         int row0, int n_rows,
                                         long long row_bytes, long long k0,
                                         int n_valid, bool vec16) {
  constexpr int PB = KS + 16;
  if (vec16) {
    constexpr int C = KS / 16;                  // 16-byte chunks a row
#pragma unroll
    for (int j = 0; j < R * C / NT; ++j) {
      const int i = (int)threadIdx.x + j * NT;
      const int r = i / C;
      const int c = (i % C) * 16;
      const bool ok = row0 + r < n_rows && c < n_valid;
      flash_mma::cp_async16(
          dst + r * PB + c,
          src + (ok ? (long long)(row0 + r) * row_bytes + k0 + c : 0), ok);
    }
  } else {
    constexpr int C = KS / 4;                   // 4-byte words a row
#pragma unroll 4
    for (int j = 0; j < R * C / NT; ++j) {
      const int i = (int)threadIdx.x + j * NT;
      const int r = i / C;
      const int c = (i % C) * 4;
      const bool ok = row0 + r < n_rows && c < n_valid;
      flash_mma::cp_async4(
          dst + r * PB + c,
          src + (ok ? (long long)(row0 + r) * row_bytes + k0 + c : 0), ok);
    }
  }
}

// One K-slice of a warp's count tile: count += A·Bᵀ over the KS entries
// that cp_slice staged (row pitch KS + 16), A's rows wm .. wm + 16·MT − 1 at
// As and B's rows (the pair tile's columns) wn .. wn + 8·NT − 1 at Bs, 32
// entries an MMA; the 32-entry steps at or past n_k (the entry block's end)
// hold only zero-fill and are skipped. NT is even: B's fragments come 16
// columns an ldmatrix.
template <int MT, int NT, int KS>
__device__ __forceinline__ void count_slice(int32_t (&count)[MT][NT][4],
                                            const int8_t* As,
                                            const int8_t* Bs, int wm, int wn,
                                            int n_k) {
  constexpr int PB = KS + 16;
  const int lane = (int)threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KS / 32; ++kk) {
    if (kk * 32 >= n_k) break;
    uint32_t bf[NT / 2][4];
#pragma unroll
    for (int np = 0; np < NT / 2; ++np)
      ldsm_x4(bf[np], Bs + (wn + 16 * np + (lane & 7) + ((lane >> 4) << 3)) * PB +
                          kk * 32 + ((lane >> 3) & 1) * 16);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      uint32_t af[4];
      ldsm_x4(af, As + (wm + 16 * mi + (lane & 15)) * PB + kk * 32 +
                      (lane >> 4) * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        mma(count[mi][2 * np], af, bf[np][0], bf[np][1]);
        mma(count[mi][2 * np + 1], af, bf[np][2], bf[np][3]);
      }
    }
  }
}

// A staged R×C float32 tile (row pitch SP floats, rows 16-byte aligned) into
// rows 0 .. R − 1 and columns 0 .. C − 1 of `out` (row pitch ld floats), by
// the block's NTH threads, in coalesced accesses: out += x with `add`
// (float32, rounded once), else out = x. Rows at or past n_rows and columns
// at or past n_cols are not touched. vec: 16-byte accesses (out 16-byte
// aligned, ld and n_cols multiples of 4); else 4-byte ones.
template <int R, int C, int SP, int NTH>
__device__ __forceinline__ void store_tile(const float* St, float* out,
                                           long long ld, int n_rows,
                                           int n_cols, bool add, bool vec) {
  for (int idx = (int)threadIdx.x; idx < R * C / 4; idx += NTH) {
    const int r = idx / (C / 4);
    const int c = (idx % (C / 4)) * 4;
    if (r >= n_rows || c >= n_cols) continue;
    const float4 x = *reinterpret_cast<const float4*>(St + r * SP + c);
    float* o = out + r * ld + c;
    if (vec) {
      float4 y = x;
      if (add) {
        const float4 a = *reinterpret_cast<const float4*>(o);
        y = make_float4(__fadd_rn(a.x, x.x), __fadd_rn(a.y, x.y),
                        __fadd_rn(a.z, x.z), __fadd_rn(a.w, x.w));
      }
      *reinterpret_cast<float4*>(o) = y;
    } else {
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < n_cols) o[e] = add ? __fadd_rn(o[e], xs[e]) : xs[e];
    }
  }
}

}  // namespace copyscore_mma
