// Exact pair rescore, both directions, for Hopper (sm_90a).
//
// For each listed source pair (i, j), over all D items:
//   C→[i, j] = Σ_same f(p[i, d], A_i, A_j) + (n_shared − n_same)·ln(1 − s)
//   C→[j, i] = Σ_same f(p[j, d], A_j, A_i) + (n_shared − n_same)·ln(1 − s)
// with f Eq. 6 (the copier's accuracy first, the copied source's second),
// "shared" an item both provide (value ≥ 0) and "same" a shared item with
// equal values. The callers pass the finalize's near-boundary pairs, BOUND's
// still-active pairs, SAMPLE-THEN-VERIFY's candidates and INCREMENTAL's flip
// candidates, all through kernels/ops.py pair_scores.
//
// It replaces no TPU kernel: the JAX package leaves this function to XLA
// (core/scoring.py pair_scores_subset, which gathers (pairs, D) blocks and
// sums them). The plain version is kernels/ref.py pair_scores_torch, the
// port's former batched body, once per direction.
//
// What bounds it on this card: bytes. Per pair, the two int32 value rows
// (2·D·4 bytes) and, only where the values agree, p of each row; two logf a
// direction per agreeing item, and a pair shares few of its items. At
// Book-full (D = 20,000, ~712,000 pairs a pass) the rows read once a pair
// are 114 GB, 34 ms at 3.35 TB/s.
//
// Design. One warp per pair and eight consecutive pairs a block: the list
// comes row-major from torch.nonzero(triu(...)), so consecutive pairs share
// their first row, which then comes from L1 / L2 and not from device memory.
// Lane l takes the 4-item groups l, l + 32, l + 64, ... of both rows, four
// groups of each row in flight: one 16-byte load a group where D % 4 == 0
// and the values are 16-byte aligned, else four 4-byte loads. Either way a
// lane adds its items in the same order, so the two variants give the same
// bits. p is read only where the values agree. Nothing is written but the
// two (P,) outputs, which the wrapper allocates.
//
// Numerics. Per agreeing item each direction takes core/scoring.py
// score_same's float32 steps in its order (pr_ind = (p·A_cop)·A_src + ((1 −
// p)(1 − A_cop))(1 − A_src) / n; f = log((1 − s) + s·(pr_src / pr_ind))),
// every step an IEEE-rounded intrinsic and logf the accurate one (built
// without --use_fast_math), so no step is contracted into an FMA. The
// terms are summed in double: a lane's in item order, then the lanes in a
// fixed xor butterfly over the warp, and the different-value term (the
// integer count times the float32 ln(1 − s), exact in double) is added
// before the one rounding to float32. Near the decision boundary a pair's
// C→ is a small difference of large same- and different-value sums, which a
// float32 sum would round at their scale. There are no atomics, so two runs
// give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int WARPS = 8;   // pairs a block
constexpr int UNROLL = 4;  // 4-item groups of each row in flight a lane
constexpr unsigned FULL = 0xffffffffu;

// Eq. 6, C→ of a copier with accuracy a_cop on a source with accuracy a_src,
// for a shared value of truth probability p.
__device__ __forceinline__ float score_same(float p, float a_cop, float a_src,
                                            float s, float one_m_s,
                                            float n_false) {
  const float q = __fsub_rn(1.0f, p);
  const float pr_src = __fadd_rn(__fmul_rn(p, a_src),
                                 __fmul_rn(q, __fsub_rn(1.0f, a_src)));
  const float pr_ind = __fadd_rn(
      __fmul_rn(__fmul_rn(p, a_cop), a_src),
      __fdiv_rn(__fmul_rn(__fmul_rn(q, __fsub_rn(1.0f, a_cop)),
                          __fsub_rn(1.0f, a_src)),
                n_false));
  return logf(__fadd_rn(one_m_s, __fmul_rn(s, __fdiv_rn(pr_src, pr_ind))));
}

struct Sums {
  double f_ij, f_ji;
  int shared, same;
};

__device__ __forceinline__ void item(int x, int y, const float* p_i,
                                     const float* p_j, int64_t d, float a_i,
                                     float a_j, float s, float one_m_s,
                                     float n_false, Sums& t) {
  if (x < 0 || y < 0) return;
  ++t.shared;
  if (x != y) return;
  ++t.same;
  t.f_ij = __dadd_rn(t.f_ij, (double)score_same(__ldg(p_i + d), a_i, a_j, s,
                                                 one_m_s, n_false));
  t.f_ji = __dadd_rn(t.f_ji, (double)score_same(__ldg(p_j + d), a_j, a_i, s,
                                                 one_m_s, n_false));
}

// 4-item group g of a row: a 16-byte load (VEC) or four 4-byte ones; items
// at or past D read as -1 (not provided).
template <bool VEC>
__device__ __forceinline__ int4 load_group(const int32_t* row, int g,
                                           int groups, int d_items) {
  if (g >= groups) return make_int4(-1, -1, -1, -1);
  if (VEC) return __ldg(reinterpret_cast<const int4*>(row) + g);
  const int d = 4 * g;
  return make_int4(__ldg(row + d),
                   d + 1 < d_items ? __ldg(row + d + 1) : -1,
                   d + 2 < d_items ? __ldg(row + d + 2) : -1,
                   d + 3 < d_items ? __ldg(row + d + 3) : -1);
}

template <bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
pair_rescore_kernel(const int32_t* __restrict__ vals,
                    const float* __restrict__ p,
                    const float* __restrict__ acc,
                    const int64_t* __restrict__ pi,
                    const int64_t* __restrict__ pj,
                    float* __restrict__ c_ij, float* __restrict__ c_ji,
                    int64_t n_pairs, int n_rows, int d_items, float s,
                    float one_m_s, float n_false) {
  const int lane = threadIdx.x & 31;
  const int64_t k = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (k >= n_pairs) return;  // the whole warp: k is the warp's
  const int64_t i = pi[k], j = pj[k];
  if (i < 0 || i >= n_rows || j < 0 || j >= n_rows) {
    // a pair outside the rows reads nothing and scores NaN
    if (lane == 0) c_ij[k] = c_ji[k] = __int_as_float(0x7fffffff);
    return;
  }
  const int32_t* v_i = vals + i * d_items;
  const int32_t* v_j = vals + j * d_items;
  const float* p_i = p + i * d_items;
  const float* p_j = p + j * d_items;
  const float a_i = __ldg(acc + i), a_j = __ldg(acc + j);
  const int groups = (d_items + 3) / 4;
  Sums t = {0.0, 0.0, 0, 0};
  for (int g0 = lane; g0 < groups; g0 += 32 * UNROLL) {
    int4 x[UNROLL], y[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      x[u] = load_group<VEC>(v_i, g0 + 32 * u, groups, d_items);
      y[u] = load_group<VEC>(v_j, g0 + 32 * u, groups, d_items);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t d = 4 * (int64_t)(g0 + 32 * u);
      item(x[u].x, y[u].x, p_i, p_j, d, a_i, a_j, s, one_m_s, n_false, t);
      item(x[u].y, y[u].y, p_i, p_j, d + 1, a_i, a_j, s, one_m_s, n_false, t);
      item(x[u].z, y[u].z, p_i, p_j, d + 2, a_i, a_j, s, one_m_s, n_false, t);
      item(x[u].w, y[u].w, p_i, p_j, d + 3, a_i, a_j, s, one_m_s, n_false, t);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    t.f_ij = __dadd_rn(t.f_ij, __shfl_xor_sync(FULL, t.f_ij, off));
    t.f_ji = __dadd_rn(t.f_ji, __shfl_xor_sync(FULL, t.f_ji, off));
    t.shared += __shfl_xor_sync(FULL, t.shared, off);
    t.same += __shfl_xor_sync(FULL, t.same, off);
  }
  if (lane == 0) {
    // ln(1 − s) from the float32 1 − s, as core/scoring.py _ln_1ms; a count
    // below 2^29 times a float32 is exact in double
    const double diff =
        __dmul_rn((double)(t.shared - t.same), (double)logf(one_m_s));
    c_ij[k] = __double2float_rn(__dadd_rn(t.f_ij, diff));
    c_ji[k] = __double2float_rn(__dadd_rn(t.f_ji, diff));
  }
}

}  // namespace

extern "C" {

// Launches the rescore of `n_pairs` pairs on `stream` and returns
// cudaGetLastError() right after the launch (cudaSuccess when n_pairs is 0:
// nothing is launched). Shapes: vals (n_rows, d_items) int32 and p (n_rows,
// d_items) float32, both contiguous; acc (n_rows,) float32; pi, pj (n_pairs,)
// int64, contiguous; c_ij, c_ji (n_pairs,) float32, written. one_m_s is
// 1 − s rounded to float from double, as the host-side expression gives it.
int pair_rescore_launch(const void* vals, const void* p, const void* acc,
                        const void* pi, const void* pj, void* c_ij,
                        void* c_ji, long long n_pairs, int n_rows,
                        int d_items, float s, float one_m_s, float n_false,
                        void* stream) {
  if (n_pairs <= 0) return (int)cudaSuccess;
  const long long blocks = (n_pairs + WARPS - 1) / WARPS;
  if (blocks > INT_MAX || n_rows < 0 || d_items < 0)
    return (int)cudaErrorInvalidValue;
  const auto* v = (const int32_t*)vals;
  const auto* pp = (const float*)p;
  const auto* a = (const float*)acc;
  const auto* ii = (const int64_t*)pi;
  const auto* jj = (const int64_t*)pj;
  auto* out_ij = (float*)c_ij;
  auto* out_ji = (float*)c_ji;
  cudaStream_t st = (cudaStream_t)stream;
  if (d_items % 4 == 0 && (uintptr_t)vals % 16 == 0)
    pair_rescore_kernel<true><<<(unsigned)blocks, WARPS * 32, 0, st>>>(
        v, pp, a, ii, jj, out_ij, out_ji, n_pairs, n_rows, d_items, s,
        one_m_s, n_false);
  else
    pair_rescore_kernel<false><<<(unsigned)blocks, WARPS * 32, 0, st>>>(
        v, pp, a, ii, jj, out_ij, out_ji, n_pairs, n_rows, d_items, s,
        one_m_s, n_false);
  return (int)cudaGetLastError();
}

const char* pair_rescore_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
