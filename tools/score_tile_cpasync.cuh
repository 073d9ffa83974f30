// One fp32 score-tile mainloop for Hopper (sm_90a), shared by knn_score.cu
// and knn_topk.cu.
//
// A CTA of 256 threads computes a kTile x kTile (128 x 128) tile of scores:
// rows of one R block against columns of one S block,
//
//   acc[r][c] = sum over the pair's active tiles t, in list order, and the
//               dims d of a tile, in order, of r_tiles[t, r, d] * s_tiles[t, c, d]
//
// as one fmaf chain per output from +0.  That is the order in which the
// first CUDA designs of both kernels summed, so the results are bit for bit
// theirs and do not move between runs (no split of the list, no atomics).
//
// Design:
//   * Each thread owns an 8 x 8 register micro-tile: rows ty + 16 i and
//     columns tx + 16 j (ty = tid / 16, tx = tid % 16, i, j < 8).
//   * The active list is one long reduction axis of a_live * tile dims,
//     staged kDepth = 16 dims at a time in the global layout, row-major
//     ([row][d], row pitch kPitch = 20 floats), by cp.async: 16-byte
//     copies straight from global to shared memory, no registers, kStages
//     buffers in flight.  A thread reads 4 dims of one of its rows or
//     columns with one 16-byte shared load: 8 for its rows, then one per
//     column, each feeding 32 FMAs (16 loads to 256 FMAs).  The pitch of 5
//     16-byte units puts 8 consecutive columns on 8 distinct bank groups.
//   * Rows past nrow and columns past ncol, and dims past the tile, are
//     zero-filled by cp.async (source size 0: nothing is read), tile % 4 ==
//     0; fmaf(0, x, acc) == acc, so the chain is unchanged.
//
// Resources: kStages x 2 x 128 x 20 floats of shared memory (dynamic; the
// caller may reuse it once accumulate returns).  Bound: operations, 2 *
// 128 * 128 * tile flops per active tile, at the card's fp32 FMA rate (67
// TFLOP/s on an H100 SXM): no TF32, fp32 parity is the bar.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace score_tile {

constexpr int kThreads = 256;
constexpr int kTile = 128;                          // rows and columns of a CTA's tile
constexpr int kDepth = 16;                          // dims per pipeline step
constexpr int kPitch = kDepth + 4;                  // row pitch of a staged slice
constexpr int kSlice = kTile * kPitch;              // floats in one staged slice
constexpr int kStages = 3;
constexpr int kStageBytes = kStages * 2 * kSlice * 4;
constexpr int kChunks = kTile * kDepth / 4 / kThreads;  // 16-byte copies a thread, per operand
constexpr int kScorePitch = kTile + 16;             // a staged score tile's row pitch
static_assert(kChunks * kThreads * 4 == kTile * kDepth, "copies cover a slice");

// The tile row of a thread's micro-tile row i, and the column of column j.
__device__ __forceinline__ int tile_row(int i, int tid) { return (tid >> 4) + 16 * i; }
__device__ __forceinline__ int tile_col(int j, int tid) { return (tid & 15) + 16 * j; }

// The number of live entries of an active list staged in shared memory:
// entries up to the first one outside [0, sentinel).
__device__ __forceinline__ int live_tiles(const int* alist, int a_len, int sentinel) {
  int n = 0;
  while (n < a_len && (unsigned)alist[n] < (unsigned)sentinel) ++n;
  return n;
}

struct Operands {
  const float* r_tiles;  // (T+1, n_r, tile)
  const float* s_tiles;  // n_s columns of a (T+1, s_ld, tile) stack
  int n_r, n_s, tile;
  int s_ld;              // the S stack's rows between consecutive tiles (>= n_s)
};

__device__ __forceinline__ void copy16(float* dst, const float* src, bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// acc = the CTA's tile of rows row0 .. row0 + nrow - 1 against columns
// col0 .. col0 + ncol - 1 over the first a_live tiles of alist (shared
// memory).  Called by all kThreads threads; stage holds kStageBytes, 16-byte
// aligned.  Ends with no copy in flight and __syncthreads(), so stage may
// be reused.
__device__ __forceinline__ void accumulate(float (&acc)[8][8], float* stage, const int* alist,
                                           int a_live, const Operands& op, int row0, int nrow,
                                           int col0, int ncol) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int slices = (op.tile + kDepth - 1) / kDepth;
  const int steps = a_live * slices;
  if (steps == 0) return;  // uniform

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t r_stride = (size_t)op.n_r * op.tile, s_stride = (size_t)op.s_ld * op.tile;

  int fa = 0, fd = 0;  // the next slice to fetch: list entry, first dim
  auto fetch = [&](int buf) {
    float* rs = stage + buf * 2 * kSlice;
    float* ss = rs + kSlice;
    const size_t t = (size_t)alist[fa];
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int c = tid + q * kThreads, row = c / (kDepth / 4), d = fd + 4 * (c % (kDepth / 4));
      const bool d_in = d < op.tile;
      const bool r_in = d_in && row < nrow, s_in = d_in && row < ncol;
      copy16(rs + row * kPitch + 4 * (c % (kDepth / 4)),
             r_in ? op.r_tiles + t * r_stride + (size_t)(row0 + row) * op.tile + d : op.r_tiles,
             r_in);
      copy16(ss + row * kPitch + 4 * (c % (kDepth / 4)),
             s_in ? op.s_tiles + t * s_stride + (size_t)(col0 + row) * op.tile + d : op.s_tiles,
             s_in);
    }
    fd += kDepth;
    if (fd >= op.tile) {
      fd = 0;
      ++fa;
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) fetch(st);
    copy_commit();
  }
  for (int s = 0; s < steps; ++s) {
    copy_wait<kStages - 2>();
    __syncthreads();  // slice s is in; every thread is done with slice s - 1
    if (s + kStages - 1 < steps) fetch((s + kStages - 1) % kStages);
    copy_commit();
    const float* rs = stage + (s % kStages) * 2 * kSlice;
    const float* ss = rs + kSlice;
#pragma unroll
    for (int d4 = 0; d4 < kDepth; d4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(rs + (ty + 16 * i) * kPitch + d4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(ss + (tx + 16 * j) * kPitch + d4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
      }
    }
  }
  copy_wait<0>();
  __syncthreads();
}

}  // namespace score_tile
