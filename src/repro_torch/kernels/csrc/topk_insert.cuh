// The top-k insertion body shared by knn_topk.cu and topk_merge.cu: the
// warp form of repro/kernels/topk_merge/kernel.py::insert_candidates.
//
// A warp holds one row's descending (score, id) k-state in registers, KS =
// ceil(k / 32) slots a lane: slot q of lane l is position q * 32 + l.
// Positions >= k hold (-inf, -1) and never take part.  Every function here
// is called by the whole warp with warp-uniform arguments.
#pragma once

#include <math.h>

namespace topk {

constexpr unsigned kFullMask = 0xffffffffu;

// The score at position q * 32 + lane, broadcast to the whole warp.
template <int KS>
__device__ __forceinline__ float slot(const float (&s)[KS], int q, int lane) {
  float v = s[0];
#pragma unroll
  for (int j = 1; j < KS; ++j)
    if (j == q) v = s[j];
  return __shfl_sync(kFullMask, v, lane);
}

// The row's k-th (last) score.
template <int KS>
__device__ __forceinline__ float kth(const float (&s)[KS], int k) {
  return slot<KS>(s, (k - 1) >> 5, (k - 1) & 31);
}

// Insert candidate (v, cid): pos = #{state >= v} (incumbents win ties),
// the candidate goes to pos and positions pos..k-2 shift right by one.
// With v <= the k-th score pos is k and nothing moves; callers skip such
// candidates before calling.
template <int KS>
__device__ __forceinline__ void insert(float (&s)[KS], int (&id)[KS], int k, float v, int cid,
                                       int lane) {
  int pos = 0;
#pragma unroll
  for (int q = 0; q < KS; ++q)
    pos += __popc(__ballot_sync(kFullMask, q * 32 + lane < k && s[q] >= v));
  float prev_s[KS];
  int prev_i[KS];
#pragma unroll
  for (int q = 0; q < KS; ++q) {
    const float up_s = __shfl_up_sync(kFullMask, s[q], 1);
    const int up_i = __shfl_up_sync(kFullMask, id[q], 1);
    const float wrap_s = __shfl_sync(kFullMask, s[q > 0 ? q - 1 : 0], 31);
    const int wrap_i = __shfl_sync(kFullMask, id[q > 0 ? q - 1 : 0], 31);
    prev_s[q] = lane > 0 ? up_s : wrap_s;
    prev_i[q] = lane > 0 ? up_i : wrap_i;
  }
#pragma unroll
  for (int q = 0; q < KS; ++q) {
    const int p = q * 32 + lane;
    if (p == pos) {
      s[q] = v;
      id[q] = cid;
    } else if (p > pos) {
      s[q] = prev_s[q];
      id[q] = prev_i[q];
    }
  }
}

}  // namespace topk
