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
//   * Each thread owns an 8 x 8 register micro-tile: rows ty*4 + {0..3} and
//     64 + ty*4 + {0..3}, columns tx*4 + {0..3} and 64 + tx*4 + {0..3}
//     (ty = tid / 16, tx = tid % 16; tile_row and tile_col below).
//   * The active list is one long reduction axis of a_live * tile dims,
//     staged kDepth = 8 dims at a time in a k-major layout ([d][row],
//     [d][col], row pitch kPitch = 132).  A thread's 8 row values and 8
//     column values for one dim are then four 16-byte shared loads, which
//     feed 64 FMAs.
//   * Software pipeline across tile boundaries: while the FMAs run on one
//     shared buffer, each thread holds the next slice in registers (one
//     16-byte global load of R and one of S: row tid / 2, dims (tid % 2) * 4
//     + {0..3}, with an L2 256-byte prefetch hint) and stores it transposed
//     into the other buffer afterwards.
//     cp.async and TMA cannot transpose 4-byte elements, so the copy goes
//     through registers.  The pitch 132 keeps the transposed stores free of
//     bank conflicts (threads 2i and 2i+1 land 16 banks apart).
//   * Rows past nrow and columns past ncol load as zeros; dims past the tile
//     too (tile % 4 == 0, so a 16-byte load is all in or all out), and
//     fmaf(0, x, acc) == acc, so the chain is unchanged.  Nothing is read
//     out of bounds.
//
// Chosen by measurement (tools/sweep_score_tile.py, PERF.md) over 16-dim
// slices, one CTA an SM with more registers, and cp.async into a padded
// row-major layout (tools/score_tile_cpasync.cuh): none was faster.
//
// Resources: 2 x 2 x 8 x 132 floats = 16,896 B of shared memory (the
// caller's, dynamic; it may reuse it once accumulate returns); the aim is
// <= 128 registers at 256 threads, two CTAs an SM.  Bound: operations, 2 *
// 128 * 128 * tile flops per active tile, at the card's fp32 FMA rate (67
// TFLOP/s on an H100 SXM): no TF32, fp32 parity is the bar.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace score_tile {

constexpr int kThreads = 256;
constexpr int kTile = 128;                    // rows and columns of a CTA's tile
constexpr int kDepth = 8;                     // dims per pipeline step
constexpr int kPitch = kTile + 4;             // row pitch of a staged slice
constexpr int kSlice = kDepth * kPitch;       // floats in one staged slice
constexpr int kStageBytes = 2 * 2 * kSlice * 4;  // R and S slices, double-buffered
constexpr int kLoads = kDepth / 8;            // 16-byte loads a thread, per operand and slice
constexpr int kScorePitch = kTile + 4;        // a staged score tile's row pitch (16-byte rows)
static_assert(kDepth % 8 == 0, "a slice is loaded 8 dims a row pair at a time");

// The tile row of thread tid's micro-tile row i, and the column of column j.
__device__ __forceinline__ int tile_row(int i, int tid) {
  return (i < 4 ? 0 : 60) + (tid >> 4) * 4 + i;
}
__device__ __forceinline__ int tile_col(int j, int tid) {
  return (j < 4 ? 0 : 60) + (tid & 15) * 4 + j;
}

// The number of live entries of an active list staged in shared memory:
// entries up to the first one outside [0, sentinel).
__device__ __forceinline__ int live_tiles(const int* alist, int a_len, int sentinel) {
  int n = 0;
  while (n < a_len && (unsigned)alist[n] < (unsigned)sentinel) ++n;
  return n;
}

// A 16-byte read-only global load that asks L2 to fetch the whole 256-byte
// segment around it: the row's next slices in that segment are L2 hits.
__device__ __forceinline__ float4 load16(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

struct Operands {
  const float* r_tiles;  // (T+1, n_r, tile)
  const float* s_tiles;  // n_s columns of a (T+1, s_ld, tile) stack
  int n_r, n_s, tile;
  int s_ld;              // the S stack's rows between consecutive tiles (>= n_s)
};

// acc = the CTA's tile of rows row0 .. row0 + nrow - 1 against columns
// col0 .. col0 + ncol - 1 over the first a_live tiles of alist (shared
// memory).  Called by all kThreads threads; stage holds kStageBytes, 16-byte
// aligned.  Ends with __syncthreads(), so stage may be reused.
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
  const int lrow = tid >> 1, ld = (tid & 1) * 4;  // this thread's loads: dims ld + 8q
  const bool r_in = lrow < nrow, s_in = lrow < ncol;
  const float* r_base = op.r_tiles + ((size_t)row0 + lrow) * op.tile + ld;
  const float* s_base = op.s_tiles + ((size_t)col0 + lrow) * op.tile + ld;
  const size_t r_stride = (size_t)op.n_r * op.tile, s_stride = (size_t)op.s_ld * op.tile;

  int fa = 0, fd = 0;  // the next slice to fetch: list entry, first dim
  float4 ra[kLoads], sa[kLoads];
  auto fetch = [&]() {
    const size_t t = (size_t)alist[fa];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      ra[q] = sa[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (fd + ld + 8 * q < op.tile) {
        if (r_in) ra[q] = load16(r_base + t * r_stride + fd + 8 * q);
        if (s_in) sa[q] = load16(s_base + t * s_stride + fd + 8 * q);
      }
    }
    fd += kDepth;
    if (fd >= op.tile) {
      fd = 0;
      ++fa;
    }
  };
  auto stash = [&](float* buf) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      float* rs = buf + (ld + 8 * q) * kPitch + lrow;
      float* ss = rs + kSlice;
      rs[0] = ra[q].x;
      rs[kPitch] = ra[q].y;
      rs[2 * kPitch] = ra[q].z;
      rs[3 * kPitch] = ra[q].w;
      ss[0] = sa[q].x;
      ss[kPitch] = sa[q].y;
      ss[2 * kPitch] = sa[q].z;
      ss[3 * kPitch] = sa[q].w;
    }
  };

  fetch();
  stash(stage);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const float* rs = stage + (s & 1) * 2 * kSlice;
    const float* ss = rs + kSlice;
    const bool more = s + 1 < steps;
    if (more) fetch();
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const float4 a0 = *reinterpret_cast<const float4*>(rs + d * kPitch + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(rs + d * kPitch + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(ss + d * kPitch + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(ss + d * kPitch + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) stash(stage + ((s + 1) & 1) * 2 * kSlice);
    __syncthreads();
  }
}

}  // namespace score_tile
