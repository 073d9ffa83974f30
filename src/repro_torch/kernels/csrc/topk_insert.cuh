// The top-k insertion body shared by knn_topk.cu and topk_merge.cu: the
// warp form of repro/kernels/topk_merge/kernel.py::insert_candidates, and
// the walk of one row's candidate list built on it.
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

// Merge a row's m candidates (scores cs[0..m), ids ci[0..m)) into its
// state, in order: the walk of topk_merge.cu.  32 columns at a time, one a
// lane, the next chunk's load in flight.  The k-th score never falls, so
// testing a chunk against the k-th at its start is exact: only the columns
// that pass (a __ballot_sync) are inserted one by one, in column order,
// each checked again against the live k-th.  Ids are read only for those.
template <int KS>
__device__ __forceinline__ void merge_row(float (&s)[KS], int (&id)[KS], int k, const float* cs,
                                          const int* ci, int m, int lane) {
  float kth_v = kth<KS>(s, k);
  float v = lane < m ? cs[lane] : -INFINITY;
  for (int c0 = 0; c0 < m; c0 += 32) {
    const int next = c0 + 32 + lane;
    const float v_next = next < m ? cs[next] : -INFINITY;
    const bool pass = v > kth_v;
    const int cid = pass ? ci[c0 + lane] : -1;
    unsigned hits = __ballot_sync(kFullMask, pass);
    while (hits) {
      const int j = __ffs(hits) - 1;
      hits &= hits - 1;
      const float vj = __shfl_sync(kFullMask, v, j);
      const int idj = __shfl_sync(kFullMask, cid, j);
      if (!(vj > kth_v)) continue;  // pos would be k: nothing moves
      insert<KS>(s, id, k, vj, idj, lane);
      kth_v = kth<KS>(s, k);
    }
    v = v_next;
  }
}

}  // namespace topk
