// The per-pair scores of the copyscore kernels (copyscore.cu,
// copyscore_fused.cu): Eq. (3), the probability that two independent sources
// share a value, and Eq. (6), the same-value score of one source copying
// from another. One definition for every kernel, so that on one entry block
// B3's full square equals the grid that B1's C→ and C← stacks scatter into,
// bit for bit, by construction and not by two copies that happen to agree.
//
// Every step is an explicit IEEE-rounded intrinsic and logf is the accurate
// one (the kernels build without --use_fast_math): nothing is contracted
// into an FMA, and the steps follow the plain PyTorch version's separately
// rounded ones (kernels/ref.py).

#pragma once

namespace copyscore_eq6 {

// Eq. (3), a1·a2 first, so that it is bitwise symmetric in a1 and a2: on a
// diagonal tile C← == C→ᵀ exactly.
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

}  // namespace copyscore_eq6
