// The top-k insertion body shared by knn_topk.cu and topk_merge.cu: the
// warp form of repro/kernels/topk_merge/kernel.py::insert_candidates, and
// two walks of a row's candidate list built on it (merge_row, a column a
// lane; merge_slice, four columns a lane).
//
// A warp holds one row's descending (score, id) k-state in registers, KS =
// ceil(k / 32) slots a lane: slot q of lane l is position q * 32 + l.
// Positions >= k hold (-inf, -1) and never take part.  Every function here
// is called by the whole warp with warp-uniform arguments.
#pragma once

#include <math.h>
#include <stdint.h>

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

// The k-th largest (k <= 32) of one value a lane, broadcast to the warp: a
// bitonic sort of the warp's 32 values, descending.
__device__ __forceinline__ float warp_kth_largest(float x, int k, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float y = __shfl_xor_sync(kFullMask, x, stride);
      const bool desc = (lane & size) == 0;  // blocks alternate; size 32: all descending
      const bool first = (lane & stride) == 0;
      x = first == desc ? fmaxf(x, y) : fminf(x, y);
    }
  }
  return __shfl_sync(kFullMask, x, k - 1);
}

// Merge the candidates of columns [lo, hi) of a row (scores cs[0..)) into
// the state, in column order, with the column index as the id (callers
// map columns to ids once, at the end, so no id load stalls the walk): the
// walk of topk_merge.cu's split kernel.  Four columns a lane, 128 a step,
// read as one 16-byte load a lane on the row's own 16-byte grid (cs need
// only be 4-byte aligned), with the next two steps' loads in flight.  A
// load may reach up to three columns before lo or past hi, inside the
// 16-byte block of a column in range; those columns read as -inf.  As in
// merge_row, a step's columns are tested against the k-th at its start
// and only those that pass are inserted, lane by lane and within a lane in
// column order.  When more than 2k pass (the first steps of a slice, whose
// state starts empty) and k <= 32, the step's own bound tightens the test
// first: tau, the k-th largest of the lanes' maxima.  A column below tau
// has at least k columns of the same step strictly above it (k lanes'
// maxima), so its rank is >= k and it never enters; ties with tau are kept.
template <int KS>
__device__ __forceinline__ void merge_slice(float (&s)[KS], int (&id)[KS], int k, const float* cs,
                                            int lo, int hi, int lane) {
  if (lo >= hi) return;
  const int mis = (int)((reinterpret_cast<uintptr_t>(cs) >> 2) & 3);
  const int g0 = lo - ((lo + mis) & 3);  // the aligned column at or before lo
  const int steps = (hi - g0 + 127) / 128;
  auto fetch = [&](int step) {
    const int c = g0 + 128 * step + 4 * lane;
    return step < steps && c < hi ? *reinterpret_cast<const float4*>(cs + c)
                                  : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
  };
  float kth_v = kth<KS>(s, k);
  float4 cur = fetch(0), nxt = fetch(1);
  for (int step = 0; step < steps; ++step) {
    const float4 later = fetch(step + 2);
    const int c = g0 + 128 * step + 4 * lane;
    float v[4] = {cur.x, cur.y, cur.z, cur.w};
    unsigned bits[4];
    unsigned any = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c + e < lo || c + e >= hi) v[e] = -INFINITY;
      bits[e] = __ballot_sync(kFullMask, v[e] > kth_v);
      any |= bits[e];
    }
    if constexpr (KS == 1) {
      if (__popc(bits[0]) + __popc(bits[1]) + __popc(bits[2]) + __popc(bits[3]) > 2 * k) {
        const float tau = warp_kth_largest(fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])), k, lane);
        any = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bits[e] = __ballot_sync(kFullMask, v[e] > kth_v && v[e] >= tau);
          any |= bits[e];
        }
      }
    }
    while (any) {
      const int j = __ffs(any) - 1;
      any &= any - 1;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!((bits[e] >> j) & 1u)) continue;
        const float vj = __shfl_sync(kFullMask, v[e], j);
        if (!(vj > kth_v)) continue;  // pos would be k: nothing moves
        insert<KS>(s, id, k, vj, __shfl_sync(kFullMask, c, j) + e, lane);
        kth_v = kth<KS>(s, k);
      }
    }
    cur = nxt;
    nxt = later;
  }
}

}  // namespace topk
