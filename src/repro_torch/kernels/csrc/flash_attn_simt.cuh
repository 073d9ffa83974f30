// Flash attention (online softmax) in fp32 FMAs: the first design of
// flash_attn.cu's f32 and bf16 paths, which its two tensor-core kernels
// (3xTF32 and bf16 mma.sync) replaced; built only into
// csrc/legacy/flash_attn_v1.cu, on no path of the port.
//
// Replaces repro/kernels/flash_attn/kernel.py::flash_attention_pallas (the
// Pallas TPU kernel, body _flash_kernel at :36) and computes what it does:
// per query row, softmax(q k^T * sm_scale) v over the keys it sees, with a
// causal mask (k_pos <= q_pos) and a sliding window (k_pos > q_pos -
// window), masked scores at NEG, p masked to 0 after the exp, f32 running
// max m, sum l and accumulator, and out = acc / max(l, 1e-30), so a row
// with no visible key gives 0.  f32 or bf16 inputs, f32 arithmetic; in
// bf16, p is rounded to bf16 before the PV product, as the Pallas kernel's
// p.astype(v.dtype).  The output is in the input type.
//
// Design: one CTA of 256 threads per (bh, 64-row q tile).  The TPU's
// sequential kv grid axis becomes a loop inside the CTA; m, l and the
// (64, hd) accumulator stay in registers for the whole walk.  Each kv tile
// of 64 keys is staged in shared memory (q once, k and v per tile, p
// reusing k's buffer), and a thread owns 4 query rows: a 4 x 4 block of
// the score tile and a 4 x hd/16 block of the accumulator, so the row
// statistics are shared by the 16 lanes of a half-warp and reduced with
// shuffles.  kv tiles that are fully masked for the whole q tile (above
// the causal diagonal, behind the window, past Skv) are skipped, which is
// exact: such a tile leaves acc and l alone, and the m it would set is
// wiped by the next real tile's alpha.  Ragged Sq and Skv need no padding:
// rows past Sq are never stored, keys past Skv never count.  GQA without
// a copy: query head bh reads kv head bh / group.  Causal q tiles are
// launched heaviest first.
//
// Bound: operations.  At qwen3-0.6b's train shape (B 2, H 16, S 4096,
// hd 128, causal) the visible pairs need 1.37e11 flop, 2.05 ms at the
// 67 TFLOP/s fp32 rate, against 2.0e8 B of q, k, v and out (0.06 ms at
// 3.35 TB/s).  The products are fp32 FMAs written here (no TF32, no
// tensor cores); shared-memory traffic is kept at one 16-byte load per
// 8 FMAs in the score product and one per ~10 in PV, and skipped tiles
// halve the causal work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "bf16_io.cuh"

namespace flash_simt {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float round_p(float p, float) { return p; }
__device__ __forceinline__ float round_p(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(p));
}

// rows x HD of a (rows_total, HD) matrix into shared memory (row stride
// LD floats), as f32; rows at or past n_valid read as zeros.
template <int HD, int LD, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0, int n_rows, int n_valid) {
  constexpr int kVecs = HD / 4;
  for (int idx = threadIdx.x; idx < n_rows * kVecs; idx += kThreads) {
    const int r = idx / kVecs, c = (idx % kVecs) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_valid) x = load4(src + (size_t)(row0 + r) * HD + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = x;
  }
}

template <int HD>
struct Shape {
  static constexpr int LD = HD + 4;                 // q, k, v row stride (floats)
  static constexpr int LDP = kBK + 4;               // p row stride
  static constexpr int KP = (kBK * LD > kBQ * LDP) ? kBK * LD : kBQ * LDP;  // k / p buffer
  static constexpr int DPT = HD / 16;               // accumulator columns a thread
  static constexpr int VEC = DPT >= 4 ? 4 : DPT;    // of which contiguous
  static constexpr int NJ = DPT / VEC;
  static constexpr size_t kSmem = sizeof(float) * (size_t)(kBQ * LD + KP + kBK * LD);
};

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, HD <= 128 ? 2 : 1)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ out, int sq, int skv, int group, int causal, int window,
                  float sm_scale) {
  using S = Shape<HD>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBQ * S::LD;   // k tile, then p tile
  float* vs = ks + S::KP;

  const int n_qt = gridDim.x;
  const int qt = causal ? n_qt - 1 - (int)blockIdx.x : (int)blockIdx.x;  // heavy first
  const int bh = blockIdx.y;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qh = q + (size_t)bh * sq * HD;
  const T* kh = k + (size_t)(bh / group) * skv * HD;
  const T* vh = v + (size_t)(bh / group) * skv * HD;

  // kv tiles that can hold a visible key for some row of this q tile
  const int q_last = min(q0 + kBQ, sq) - 1;
  int k_end = skv;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  const int kt_begin = k_begin / kBK;
  const int kt_end = k_end > k_begin ? (k_end + kBK - 1) / kBK : kt_begin;

  stage<HD, S::LD>(qs, qh, q0, kBQ, sq);

  float acc[4][S::DPT];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < S::DPT; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's p and v are no longer read
    stage<HD, S::LD>(ks, kh, k0, kBK, skv);
    stage<HD, S::LD>(vs, vh, k0, kBK, skv);
    __syncthreads();

    // scores: rows ty*4 + i, keys tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * S::LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * S::LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // mask, online softmax; the 16 lanes of a half-warp share a row
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      bool vis[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        vis[j] = kp < skv && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
        s[i][j] = vis[j] ? s[i][j] * sm_scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p[i][j];
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < S::DPT; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done with the k tile: p takes its place
    float* ps = ks;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty * 4 + i) * S::LDP + tx + 16 * j] = round_p(p[i][j], T());
    __syncthreads();

    // acc += p v: rows ty*4 + i, columns jj*16*VEC + tx*VEC + e
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * S::LDP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = vs + (c + cc) * S::LD;
#pragma unroll
        for (int jj = 0; jj < S::NJ; ++jj) {
          float vv[S::VEC];
          const float* src = vrow + jj * 16 * S::VEC + tx * S::VEC;
          if constexpr (S::VEC == 4) {
            const float4 t = *reinterpret_cast<const float4*>(src);
            vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(src);
            vv[0] = t.x; vv[1] = t.y;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pc = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int e = 0; e < S::VEC; ++e)
              acc[i][jj * S::VEC + e] = fmaf(pc, vv[e], acc[i][jj * S::VEC + e]);
          }
        }
      }
    }
  }

  T* oh = out + (size_t)bh * sq * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < S::NJ; ++jj)
#pragma unroll
      for (int e = 0; e < S::VEC; ++e)
        store1(oh + (size_t)qp * HD + jj * 16 * S::VEC + tx * S::VEC + e,
               acc[i][jj * S::VEC + e] / denom);
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int sq, int skv,
           int group, int causal, int window, float sm_scale, cudaStream_t st) {
  const size_t smem = Shape<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_attn_kernel<HD, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)bh);
  flash_attn_kernel<HD, T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, skv, group, causal, window, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* out, int bh, int sq,
             int skv, int group, int causal, int window, float sm_scale, cudaStream_t st) {
  switch (hd) {
    case 32: return launch<32, T>(q, k, v, out, bh, sq, skv, group, causal, window, sm_scale, st);
    case 64: return launch<64, T>(q, k, v, out, bh, sq, skv, group, causal, window, sm_scale, st);
    case 128: return launch<128, T>(q, k, v, out, bh, sq, skv, group, causal, window, sm_scale, st);
    case 256: return launch<256, T>(q, k, v, out, bh, sq, skv, group, causal, window, sm_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace flash_simt
