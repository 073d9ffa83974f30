// Chunked RWKV6 time mixing (WKV) for Hopper (sm_90a).
//
// Replaces repro/kernels/wkv/kernel.py::wkv_pallas (the Pallas TPU
// kernel, body _wkv_kernel at :37) and computes what it does, chunk by
// chunk, with the (K, K) f32 state carried from one chunk to the next:
//
//   lcum_inc = cumsum(lw) over time (inclusive), lcum = lcum_inc - lw,
//   ltot = lcum_inc[C-1]
//   ri = r e^{lcum},  kj = k e^{clip(-lcum_inc, -30, 30)}
//   intra = mask_{col<row}(ri kj^T) v + sum(r k u) v
//   inter = ri S                          (the state before the update)
//   S     = S diag(e^{ltot}) + k_carry^T v,  k_carry = k e^{min(ltot - lcum_inc, 30)}
//   out   = intra + inter
//
// f32 or bf16 inputs, f32 arithmetic, output in the input type.
//
// Design: the carry is sequential in chunks, so one CTA of 256 threads
// per (b h) walks its chunks in order, the state in shared memory (16 KB
// at K = 64).  A chunk's r, k, v and lw tiles are staged in shared memory
// and turned in place into ri, kj and k_carry by one thread per channel,
// which walks the chunk's C tokens in order (the cumsum is sequential, so
// ltot is bit for bit the last inclusive sum).  The four products run on
// a 16 x 16 thread grid with register micro-tiles: scores and the state
// apply first (both read the old state), then, after a barrier, intra and
// the state update.  The strictly causal mask is a triangle of 16-row
// blocks: blocks above the diagonal are never computed.  Ragged T needs no
// padding: tokens past T read as zeros (no decay, no key, no value), which
// is what the reference's zero padding gives, and are never stored.
//
// Bound: operations.  At rwkv6-3b's width (B 2, T 4096, H 40, K 64,
// chunk 128) the products need ~4.2e6 flop a chunk-head once the causal
// triangle is skipped, 1.1e10 in all: 0.16 ms at 67 TFLOP/s, against
// 4.2e8 B moved (0.125 ms).  This first kernel fills only 80 of 132 SMs
// (one CTA per b h, one CTA a SM for its ~212 KB of shared memory); the
// split of the intra-chunk work from the carry is left to a later design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "bf16_io.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kClamp = 30.f;

template <int C, int K>
struct Shape {
  static constexpr int LDK = K + 1;   // odd strides: 16 rows of one column
  static constexpr int LDC = C + 1;   // fall in 16 different banks
  static constexpr int MA = C / 16;   // token rows a thread
  static constexpr int NB = K / 16;   // channel columns a thread
  static constexpr int kFloats = 4 * C * LDK + C * LDC + K * LDK + C + 2 * K;
  static constexpr size_t kSmem = sizeof(float) * (size_t)kFloats;
};

// One (C, K) tile of a (T, K) sequence into shared memory (row stride
// LDK), as f32; tokens at or past t read as zeros.
template <int C, int K, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int t0, int t) {
  using S = Shape<C, K>;
  for (int idx = threadIdx.x; idx < C * K / 4; idx += kThreads) {
    const int i = idx / (K / 4), c = (idx % (K / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + i < t) x = load4(src + (size_t)(t0 + i) * K + c);
    float* d = dst + i * S::LDK + c;
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  }
}

template <int C, int K, typename T>
__global__ void __launch_bounds__(kThreads, 1)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ lw, const float* __restrict__ u, T* __restrict__ out, int t) {
  using S = Shape<C, K>;
  extern __shared__ float smem[];
  float* rs = smem;                 // r, then ri
  float* ks = rs + C * S::LDK;      // k, then kj
  float* vs = ks + C * S::LDK;      // v
  float* ls = vs + C * S::LDK;      // lw, then k_carry
  float* sc = ls + C * S::LDK;      // masked scores (C, C)
  float* st = sc + C * S::LDC;      // state (K, K)
  float* dg = st + K * S::LDK;      // sum(r k u) per token
  float* lt = dg + C;               // ltot per channel
  float* us = lt + K;               // u

  const int bh = blockIdx.x;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = (size_t)bh * t * K;
  for (int i = tid; i < K * S::LDK; i += kThreads) st[i] = 0.f;
  for (int c = tid; c < K; c += kThreads) us[c] = u[(size_t)bh * K + c];

  for (int t0 = 0; t0 < t; t0 += C) {
    __syncthreads();  // the previous chunk is done with every buffer
    stage<C, K>(rs, r + base, t0, t);
    stage<C, K>(ks, k + base, t0, t);
    stage<C, K>(vs, v + base, t0, t);
    stage<C, K>(ls, lw + base, t0, t);
    __syncthreads();

    // the u diagonal from the raw r and k; ltot per channel
    for (int i = tid; i < C; i += kThreads) {
      float d = 0.f;
      for (int c = 0; c < K; ++c) d += rs[i * S::LDK + c] * (ks[i * S::LDK + c] * us[c]);
      dg[i] = d;
    }
    if (tid < K) {
      float acc = 0.f;
      for (int i = 0; i < C; ++i) acc += ls[i * S::LDK + tid];
      lt[tid] = acc;
    }
    __syncthreads();

    // in place: r -> ri, k -> kj, lw -> k_carry; the same sequential sum as ltot
    if (tid < K) {
      const int c = tid;
      const float ltot = lt[c];
      float acc = 0.f;
      for (int i = 0; i < C; ++i) {
        const float lwv = ls[i * S::LDK + c];
        acc += lwv;
        const float kv = ks[i * S::LDK + c];
        rs[i * S::LDK + c] *= expf(acc - lwv);
        ks[i * S::LDK + c] = kv * expf(fminf(fmaxf(-acc, -kClamp), kClamp));
        ls[i * S::LDK + c] = kv * expf(fminf(ltot - acc, kClamp));
      }
    }
    __syncthreads();

    // scores (rows ty + 16a, cols tx + 16b, b <= a) and inter = ri S
    {
      float s[S::MA][S::MA];
#pragma unroll
      for (int a = 0; a < S::MA; ++a)
#pragma unroll
        for (int b = 0; b < S::MA; ++b) s[a][b] = 0.f;
#pragma unroll 2
      for (int c = 0; c < K; ++c) {
        float ra[S::MA], kb[S::MA];
#pragma unroll
        for (int a = 0; a < S::MA; ++a) ra[a] = rs[(ty + 16 * a) * S::LDK + c];
#pragma unroll
        for (int b = 0; b < S::MA; ++b) kb[b] = ks[(tx + 16 * b) * S::LDK + c];
#pragma unroll
        for (int a = 0; a < S::MA; ++a)
#pragma unroll
          for (int b = 0; b <= a; ++b) s[a][b] = fmaf(ra[a], kb[b], s[a][b]);
      }
#pragma unroll
      for (int a = 0; a < S::MA; ++a)
#pragma unroll
        for (int b = 0; b < S::MA; ++b) {
          const bool keep = b < a || (b == a && tx < ty);
          sc[(ty + 16 * a) * S::LDC + tx + 16 * b] = keep ? s[a][b] : 0.f;
        }
    }
    float inter[S::MA][S::NB];
#pragma unroll
    for (int a = 0; a < S::MA; ++a)
#pragma unroll
      for (int b = 0; b < S::NB; ++b) inter[a][b] = 0.f;
#pragma unroll 2
    for (int c = 0; c < K; ++c) {
      float sb[S::NB];
#pragma unroll
      for (int b = 0; b < S::NB; ++b) sb[b] = st[c * S::LDK + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < S::MA; ++a) {
        const float ra = rs[(ty + 16 * a) * S::LDK + c];
#pragma unroll
        for (int b = 0; b < S::NB; ++b) inter[a][b] = fmaf(ra, sb[b], inter[a][b]);
      }
    }
    __syncthreads();

    // intra = scores v over the causal triangle, plus the u diagonal
    float intra[S::MA][S::NB];
#pragma unroll
    for (int a = 0; a < S::MA; ++a)
#pragma unroll
      for (int b = 0; b < S::NB; ++b) intra[a][b] = 0.f;
    for (int jb = 0; jb < S::MA; ++jb) {
      for (int jj = 0; jj < 16; ++jj) {
        const int j = 16 * jb + jj;
        float vb[S::NB];
#pragma unroll
        for (int b = 0; b < S::NB; ++b) vb[b] = vs[j * S::LDK + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < S::MA; ++a) {
          if (a < jb) continue;  // rows of block a see no column of a later block
          const float sa = sc[(ty + 16 * a) * S::LDC + j];
#pragma unroll
          for (int b = 0; b < S::NB; ++b) intra[a][b] = fmaf(sa, vb[b], intra[a][b]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < S::MA; ++a) {
      const int i = ty + 16 * a;
      if (t0 + i >= t) continue;
      const float d = dg[i];
#pragma unroll
      for (int b = 0; b < S::NB; ++b) {
        const int c = tx + 16 * b;
        const float o = (intra[a][b] + d * vs[i * S::LDK + c]) + inter[a][b];
        store1(out + base + (size_t)(t0 + i) * K + c, o);
      }
    }

    // S = S diag(e^{ltot}) + k_carry^T v: rows ty + 16a, cols tx + 16b
    {
      float upd[S::NB][S::NB];
#pragma unroll
      for (int a = 0; a < S::NB; ++a)
#pragma unroll
        for (int b = 0; b < S::NB; ++b) upd[a][b] = 0.f;
#pragma unroll 2
      for (int i = 0; i < C; ++i) {
        float ka[S::NB], vb[S::NB];
#pragma unroll
        for (int a = 0; a < S::NB; ++a) ka[a] = ls[i * S::LDK + ty + 16 * a];
#pragma unroll
        for (int b = 0; b < S::NB; ++b) vb[b] = vs[i * S::LDK + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < S::NB; ++a)
#pragma unroll
          for (int b = 0; b < S::NB; ++b) upd[a][b] = fmaf(ka[a], vb[b], upd[a][b]);
      }
#pragma unroll
      for (int a = 0; a < S::NB; ++a) {
        const int c = ty + 16 * a;
        const float decay = expf(lt[c]);
#pragma unroll
        for (int b = 0; b < S::NB; ++b) {
          float* cell = st + c * S::LDK + tx + 16 * b;
          *cell = *cell * decay + upd[a][b];
        }
      }
    }
  }
}

template <int C, int K, typename T>
int launch(const void* r, const void* k, const void* v, const void* lw, const float* u,
           void* out, int bh, int t, cudaStream_t st) {
  const size_t smem = Shape<C, K>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(wkv_kernel<C, K, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv_kernel<C, K, T><<<bh, kThreads, smem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(lw), u, static_cast<T*>(out), t);
  return (int)cudaGetLastError();
}

template <int K, typename T>
int by_chunk(int chunk, const void* r, const void* k, const void* v, const void* lw,
             const float* u, void* out, int bh, int t, cudaStream_t st) {
  switch (chunk) {
    case 16: return launch<16, K, T>(r, k, v, lw, u, out, bh, t, st);
    case 32: return launch<32, K, T>(r, k, v, lw, u, out, bh, t, st);
    case 64: return launch<64, K, T>(r, k, v, lw, u, out, bh, t, st);
    case 128: return launch<128, K, T>(r, k, v, lw, u, out, bh, t, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int by_head(int kk, int chunk, const void* r, const void* k, const void* v, const void* lw,
            const float* u, void* out, int bh, int t, cudaStream_t st) {
  switch (kk) {
    case 16: return by_chunk<16, T>(chunk, r, k, v, lw, u, out, bh, t, st);
    case 32: return by_chunk<32, T>(chunk, r, k, v, lw, u, out, bh, t, st);
    case 64: return by_chunk<64, T>(chunk, r, k, v, lw, u, out, bh, t, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  r, k, v, lw, out (bh, t, kk); u (bh, kk) f32.
extern "C" int wkv_launch(const void* r, const void* k, const void* v, const void* lw,
                          const float* u, void* out, int dtype, int bh, int t, int kk,
                          int chunk, void* stream) {
  if (bh < 1 || t < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_head<float>(kk, chunk, r, k, v, lw, u, out, bh, t, st);
  if (dtype == 1) return by_head<__nv_bfloat16>(kk, chunk, r, k, v, lw, u, out, bh, t, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* wkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
