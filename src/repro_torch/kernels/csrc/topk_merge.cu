// Streaming top-k merge for Hopper (sm_90a).
//
// Replaces repro/kernels/topk_merge/kernel.py::topk_merge_pallas (the
// Pallas TPU kernel, body _merge_kernel around insert_candidates) and
// computes what it does, bit for bit: M insertion passes of a row's
// candidates, in column order, into its descending k-state; pos =
// #{state >= cand}, so incumbents win ties and a candidate that is <= the
// k-th score (-inf ones included) changes nothing.  Empty slots are (-inf,
// -1).  Scores are finite or -inf; a NaN candidate is outside the
// contract.  Any k >= 1, by three kernels:
//
// k <= 128 and M < kSplitMinM, topk_merge_kernel: one warp per row, its
// state in registers (k/32 slots a lane, topk_insert.cuh, shared with
// knn_topk.cu).  The warp walks the row's candidates with topk::merge_row:
// 32 columns at a time, one column a lane, the next chunk's load in
// flight; only the columns that beat the chunk-start k-th (a
// __ballot_sync) are inserted, in column order.  merge_topk_states' M = k
// takes it.
//
// k <= 128 and M >= kSplitMinM, topk_merge_split_kernel: one CTA of 8
// warps per row.  Warp w walks the w-th of eight contiguous slices of the
// row in column order (topk::merge_slice: 16-byte loads, 128 columns a
// step, two steps in flight) into a state of its own that starts empty,
// (-inf, -1), and holds column indices until the walk ends.  The eight
// partial states merge through shared memory (topk::merge_row) in a tree
// that keeps slice order, three levels deep, and the result into the
// incoming state: incumbents win ties, then the earlier slice, as in the
// S-order merge of knn_topk.cu's pass 2.
// It is exact: the insertion passes give the first k of a stable
// descending sort of [state, cand_0, ..., cand_{M-1}], and that is the
// in-order merge of each piece's own stable top-k.  Slice edges past the
// first lie on the row's 16-byte grid, so only warp 0 starts off it.
//
// k > 128, topk_merge_large_kernel: one CTA of 256 threads per row, the
// state in shared memory (two buffers of k, or global scratch beyond
// kLargeSmemMaxK).  The insertion passes give the first k entries of a
// stable descending sort of [state, cand_0, ..., cand_{M-1}], so an
// entry's slot is its rank #{greater} + #{equal and earlier}, and entries
// of rank >= k drop out.  The CTA takes 256 columns at a time: the columns
// that beat the chunk-start k-th are compacted in column order (the others
// have rank >= k, and they outrank no entry that stays), each survivor's
// rank is a binary search in the descending state plus a count over the
// survivors, each state entry's is its position plus the survivors above
// it, and every entry of rank < k is written to slot rank of the other
// buffer.
//
// Ragged N and M need no padding: rows past N have no warp or CTA, and
// columns past M read as -inf.
//
// Bound: bytes.  The candidate scores are read once (N * M * 4 B, 84 MB at
// N = 2048, M = 10,240), plus the ids of the passing columns and the
// state in and out: 0.025 ms at 3.35 TB/s.  A row's walk is serial, so
// with one warp per row the card holds N warps (2,048 at the engine's
// shapes, 16 a SM) with one 128-byte load each in flight, and latency,
// not bandwidth, is what it meets first.  The split kernel holds 8 N
// warps with two 512-byte loads each in flight (up to 64 warps an SM),
// enough to cover HBM's latency at 3.35 TB/s.  What it meets next is the
// instruction rate of the inserts: each slice starts from an empty state, so its
// first steps pass nearly every column, and merge_slice's bound from the
// step's own lane maxima keeps those inserts to about k a step.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "topk_insert.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLargeThreads = 256;
constexpr int kLargeWarps = kLargeThreads / 32;
constexpr int kLargeSmemMaxK = 4096;  // two (score, id) states of k in shared memory: 64 KB
constexpr int kSplitMinM = 512;       // k <= 128: from this M on, a CTA a row

struct Params {
  const float* state_s;  // (N, k)
  const int* state_i;    // (N, k)
  const float* cand_s;   // (N, M)
  const int* cand_i;     // (N, M), or (M,) shared by every row: ids_stride 0
  float* out_s;          // (N, k)
  int* out_i;            // (N, k)
  float* scratch_s;      // (N, k), the second state buffer when k > kLargeSmemMaxK
  int* scratch_i;
  int n, k, m, ids_stride;
};

template <int KS>
__global__ void __launch_bounds__(kThreads) topk_merge_kernel(Params p) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= p.n) return;  // a whole warp

  float s[KS];
  int id[KS];
#pragma unroll
  for (int q = 0; q < KS; ++q) {
    const int pos = q * 32 + lane;
    s[q] = pos < p.k ? p.state_s[(size_t)row * p.k + pos] : -INFINITY;
    id[q] = pos < p.k ? p.state_i[(size_t)row * p.k + pos] : -1;
  }
  topk::merge_row<KS>(s, id, p.k, p.cand_s + (size_t)row * p.m,
                      p.cand_i + (size_t)row * p.ids_stride, p.m, lane);

#pragma unroll
  for (int q = 0; q < KS; ++q) {
    const int pos = q * 32 + lane;
    if (pos < p.k) {
      p.out_s[(size_t)row * p.k + pos] = s[q];
      p.out_i[(size_t)row * p.k + pos] = id[q];
    }
  }
}

template <int KS>
__global__ void __launch_bounds__(kThreads) topk_merge_split_kernel(Params p) {
  __shared__ float part_s[kWarps][KS * 32];  // each slice's top-k, in slice order
  __shared__ int part_i[kWarps][KS * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row = blockIdx.x;
  const int k = p.k, m = p.m;

  float s[KS];
  int id[KS];
#pragma unroll
  for (int q = 0; q < KS; ++q) {
    s[q] = -INFINITY;
    id[q] = -1;
  }
  // slice edges: 0, then a0 + w * len, on the row's 16-byte grid
  const float* cs = p.cand_s + row * m;
  const int a0 = (4 - (int)((reinterpret_cast<uintptr_t>(cs) >> 2) & 3)) & 3;
  const int len = ((m + kWarps - 1) / kWarps + 3) & ~3;
  const int lo = warp == 0 ? 0 : min(m, a0 + warp * len);
  const int hi = warp == kWarps - 1 ? m : min(m, a0 + (warp + 1) * len);
  topk::merge_slice<KS>(s, id, k, cs, lo, hi, lane);  // ids: column indices
  const int* ci = p.cand_i + row * p.ids_stride;
#pragma unroll
  for (int q = 0; q < KS; ++q) {
    part_s[warp][q * 32 + lane] = s[q];
    part_i[warp][q * 32 + lane] = id[q] >= 0 ? ci[id[q]] : -1;
  }
  __syncthreads();
  // the slices' states merged pairwise in a tree that keeps slice order (the
  // earlier slice holds the state, the later one is merged in), so the
  // earlier slice wins ties; then into the incoming state, whose entries win
  // ties over every candidate
  for (int span = 1; span < kWarps; span *= 2) {
    const bool merges = warp % (2 * span) == 0;
    if (merges) {
#pragma unroll
      for (int q = 0; q < KS; ++q) id[q] = part_i[warp][q * 32 + lane];
      topk::merge_row<KS>(s, id, k, part_s[warp + span], part_i[warp + span], k, lane);
    }
    __syncthreads();
    if (merges) {
#pragma unroll
      for (int q = 0; q < KS; ++q) {
        part_s[warp][q * 32 + lane] = s[q];
        part_i[warp][q * 32 + lane] = id[q];
      }
    }
    __syncthreads();
  }
  if (warp != 0) return;
#pragma unroll
  for (int q = 0; q < KS; ++q) {
    const int pos = q * 32 + lane;
    s[q] = pos < k ? p.state_s[row * k + pos] : -INFINITY;
    id[q] = pos < k ? p.state_i[row * k + pos] : -1;
  }
  topk::merge_row<KS>(s, id, k, part_s[0], part_i[0], k, lane);
#pragma unroll
  for (int q = 0; q < KS; ++q) {
    const int pos = q * 32 + lane;
    if (pos < k) {
      p.out_s[row * k + pos] = s[q];
      p.out_i[row * k + pos] = id[q];
    }
  }
}

__global__ void __launch_bounds__(kLargeThreads) topk_merge_large_kernel(Params p) {
  extern __shared__ float4 smem4[];
  __shared__ float cv[kLargeThreads];  // the chunk's surviving candidates, in column order
  __shared__ int cid[kLargeThreads];
  __shared__ int warp_hits[kLargeWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = p.k;
  const size_t row = blockIdx.x;
  float* const out_s = p.out_s + row * k;
  int* const out_i = p.out_i + row * k;
  float *cur_s, *nxt_s;
  int *cur_i, *nxt_i;
  if (k <= kLargeSmemMaxK) {
    cur_s = reinterpret_cast<float*>(smem4);
    nxt_s = cur_s + k;
    cur_i = reinterpret_cast<int*>(nxt_s + k);
    nxt_i = cur_i + k;
  } else {
    cur_s = out_s;
    cur_i = out_i;
    nxt_s = p.scratch_s + row * k;
    nxt_i = p.scratch_i + row * k;
  }
  for (int j = tid; j < k; j += kLargeThreads) {
    cur_s[j] = p.state_s[row * k + j];
    cur_i[j] = p.state_i[row * k + j];
  }
  __syncthreads();

  const float* cs = p.cand_s + row * p.m;
  const int* ci = p.cand_i + row * p.ids_stride;
  float kth = cur_s[k - 1];
  for (int c0 = 0; c0 < p.m; c0 += kLargeThreads) {
    const int c = c0 + tid;
    const float v = c < p.m ? cs[c] : -INFINITY;
    const bool pass = v > kth;  // v <= the k-th: rank >= k
    const unsigned hits = __ballot_sync(topk::kFullMask, pass);
    if (lane == 0) warp_hits[warp] = __popc(hits);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kLargeWarps; ++w) {
      before += w < warp ? warp_hits[w] : 0;
      total += warp_hits[w];
    }
    if (pass) {
      const int slot = before + __popc(hits & ((1u << lane) - 1u));
      cv[slot] = v;
      cid[slot] = ci[c];
    }
    __syncthreads();
    if (total == 0) continue;  // uniform: nothing enters

    if (tid < total) {  // a survivor: state entries >= it, then survivors above it
      const float x = cv[tid];
      int lo = 0, hi = k;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cur_s[mid] >= x) lo = mid + 1;
        else hi = mid;
      }
      int rank = lo;
      for (int i = 0; i < total; ++i) rank += cv[i] > x || (cv[i] == x && i < tid);
      if (rank < k) {
        nxt_s[rank] = x;
        nxt_i[rank] = cid[tid];
      }
    }
    for (int j = tid; j < k; j += kLargeThreads) {  // an incumbent: survivors strictly above it
      const float x = cur_s[j];
      int rank = j;
      for (int i = 0; i < total; ++i) rank += cv[i] > x;
      if (rank < k) {
        nxt_s[rank] = x;
        nxt_i[rank] = cur_i[j];
      }
    }
    __syncthreads();
    float* ts = cur_s;
    cur_s = nxt_s;
    nxt_s = ts;
    int* ti = cur_i;
    cur_i = nxt_i;
    nxt_i = ti;
    kth = cur_s[k - 1];
  }

  if (cur_s != out_s) {
    for (int j = tid; j < k; j += kLargeThreads) {
      out_s[j] = cur_s[j];
      out_i[j] = cur_i[j];
    }
  }
}

}  // namespace

// scratch_s, scratch_i: (N, k) buffers apart from out_s, out_i when k > 128;
// used when k > kLargeSmemMaxK.
extern "C" int topk_merge_launch(const float* state_s, const int* state_i, const float* cand_s,
                                 const int* cand_i, float* out_s, int* out_i, float* scratch_s,
                                 int* scratch_i, int n, int k, int m, int ids_stride,
                                 void* stream) {
  if (n < 1 || k < 1 || m < 0 || ids_stride < 0 ||
      (k > 128 && (scratch_s == out_s || scratch_i == out_i)))
    return (int)cudaErrorInvalidValue;
  const Params p{state_s, state_i, cand_s, cand_i, out_s, out_i, scratch_s, scratch_i,
                 n, k, m, ids_stride};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k > 128) {
    const int smem = k <= kLargeSmemMaxK ? 2 * k * (int)(sizeof(float) + sizeof(int)) : 0;
    const cudaError_t err = cudaFuncSetAttribute(
        topk_merge_large_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        2 * kLargeSmemMaxK * (int)(sizeof(float) + sizeof(int)));
    if (err != cudaSuccess) return (int)err;
    topk_merge_large_kernel<<<(unsigned)n, kLargeThreads, smem, st>>>(p);
    return (int)cudaGetLastError();
  }
  if (m >= kSplitMinM) {
    switch ((k + 31) / 32) {
      case 1: topk_merge_split_kernel<1><<<(unsigned)n, kThreads, 0, st>>>(p); break;
      case 2: topk_merge_split_kernel<2><<<(unsigned)n, kThreads, 0, st>>>(p); break;
      case 3: topk_merge_split_kernel<3><<<(unsigned)n, kThreads, 0, st>>>(p); break;
      default: topk_merge_split_kernel<4><<<(unsigned)n, kThreads, 0, st>>>(p); break;
    }
    return (int)cudaGetLastError();
  }
  const unsigned grid = (unsigned)((n + kWarps - 1) / kWarps);
  switch ((k + 31) / 32) {
    case 1: topk_merge_kernel<1><<<grid, kThreads, 0, st>>>(p); break;
    case 2: topk_merge_kernel<2><<<grid, kThreads, 0, st>>>(p); break;
    case 3: topk_merge_kernel<3><<<grid, kThreads, 0, st>>>(p); break;
    default: topk_merge_kernel<4><<<grid, kThreads, 0, st>>>(p); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* topk_merge_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
