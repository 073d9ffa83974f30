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
//   inter = ri S_n                        (S_n: the state before chunk n)
//   S_{n+1} = S_n diag(e^{ltot}) + U_n,   U_n = k_carry^T v,
//             k_carry = k e^{min(ltot - lcum_inc, 30)}
//   out   = intra + inter
//
// f32 or bf16 inputs, f32 arithmetic, output in the input type.
//
// Design: only the carry is sequential, and it is elementwise: each of
// the K^2 entries of a head's state is its own linear recurrence over the
// chunks, S_{n+1}[c,d] = S_n[c,d] e^{ltot_n[c]} + U_n[c,d].  Everything
// else in a chunk is independent of the other chunks once S_n is known.
// So a call launches three kernels over the BH x N chunks (2,560 at
// rwkv6-3b B 2, so the card fills at any batch):
//
//   1. wkv_state_kernel: every chunk's ltot and U_n into scratch ((BH, N,
//      K) and (BH, N, K, K) f32).  512 threads, two buffers of (k, v, lw)
//      tiles (~192 KB at C 128, K 64), one CTA an SM, persistent;
//   2. wkv_carry_kernel, a thread per (b h, c, four d): walks n = 0..N-1
//      and overwrites U_n with S_n in place (an exclusive scan from 0);
//   3. wkv_out_kernel: every chunk's ri, kj, strictly causal scores, intra
//      + diag v and inter = ri S_n, then the output.  512 threads (16
//      warps), ~215 KB, one CTA an SM, persistent.
//
// Both chunk kernels walk chunks b, b + grid, ... and copy the next
// chunk's tiles in with cp.async while this one computes (bf16 tiles land
// raw and are widened to f32 in shared memory), so their loads hide
// behind the products.  In the output kernel the scores and inter share
// one pass over the channels (register micro-tiles of 4 tokens x 4
// channels, 8 score columns, only blocks below the diagonal), and intra
// reads the score tile in steps of four columns.
//
// The arithmetic is the first design's (legacy/wkv_v1.cu) in the same
// order, so the outputs equal its outputs bit for bit: the cumsum walks a
// channel's tokens in order (one thread a channel), every product sums
// over its inner index in ascending order with fmaf from 0, the state
// update is s * e^{ltot} + upd, and the output is (intra + d v) + inter.
// Intra sums over the columns j < i in steps of four; the masked scores
// of a step hold +0, and an fmaf with a zero score leaves the sum as it
// is (the sum is never -0), which is why the first design's extra zero
// terms change nothing.  Ragged T needs no padding: tokens past T read as
// zeros (no decay, no key, no value), as the reference's zero padding
// gives, and are never stored.
//
// Bound: operations.  At rwkv6-3b's width (B 2, T 4096, H 40, K 64,
// chunk 128) the products need ~4.2e6 flop a chunk-head once the causal
// triangle is skipped, 1.07e10 in all: 0.16 ms at 67 TFLOP/s, against
// 4.2e8 B of inputs and outputs (0.125 ms).  The scratch adds U_n written,
// read and overwritten by the carry, and read by the output kernel: 4 x
// 42 MB at B 2 (0.05 ms at 3.35 TB/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "bf16_io.cuh"

namespace {

constexpr float kClamp = 30.f;
constexpr int kStateThreads = 512;
constexpr int kCarryThreads = 256;
constexpr int kCarryBatch = 8;   // chunks whose U_n loads a carry thread keeps in flight

__device__ __forceinline__ float lane4(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// cp.async: 16 bytes from global to shared memory, zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Where a bf16 tile waits in a (C, LD) f32 region before widen: its last
// C * K * 2 bytes.
template <int C, int K, int LD>
__device__ __forceinline__ __nv_bfloat16* raw_of(float* region) {
  return reinterpret_cast<__nv_bfloat16*>(region + C * LD) - C * K;
}

// Start copying a (C, K) tile of a (T, K) sequence into shared memory with
// cp.async (one commit group is the caller's): f32 straight into its rows
// (stride LD, a multiple of 4), bf16 as it is into raw_of(dst), for widen.
// Tokens at or past t read as zeros.
template <int C, int K, int LD, int NT, typename T>
__device__ __forceinline__ void copy_tile(float* dst, const T* src, int t0, int t) {
  constexpr int E = 16 / (int)sizeof(T);   // elements a copy
  for (int idx = threadIdx.x; idx < C * K / E; idx += NT) {
    const int i = idx / (K / E), c = (idx % (K / E)) * E;
    const bool valid = t0 + i < t;
    const T* from = src + (size_t)(valid ? t0 + i : 0) * K + c;
    if constexpr (sizeof(T) == 4)
      cp_async16(dst + i * LD + c, from, valid);
    else
      cp_async16(raw_of<C, K, LD>(dst) + i * K + c, from, valid);
  }
}

// bf16 only: the raw tiles that copy_tile left in the N regions become f32
// rows (stride LD), in place.  Every thread of the CTA calls it; it holds
// one barrier between reading the raw tiles and writing the rows.
template <int C, int K, int LD, int NT, int N>
__device__ __forceinline__ void widen(float* const (&dst)[N]) {
  constexpr int G = C * K / 8;              // 16-byte groups of 8 elements
  constexpr int P = (G + NT - 1) / NT;
  uint4 raw[N][P];
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int idx = threadIdx.x + NT * p;
      if (idx < G) raw[n][p] = reinterpret_cast<const uint4*>(raw_of<C, K, LD>(dst[n]))[idx];
    }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int idx = threadIdx.x + NT * p;
      if (idx >= G) continue;
      const int i = idx * 8 / K, c = idx * 8 % K;
      const unsigned w[4] = {raw[n][p].x, raw[n][p].y, raw[n][p].z, raw[n][p].w};
      float f[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
        f[2 * e] = x.x;
        f[2 * e + 1] = x.y;
      }
      *reinterpret_cast<float4*>(dst[n] + i * LD + c) = make_float4(f[0], f[1], f[2], f[3]);
      *reinterpret_cast<float4*>(dst[n] + i * LD + c + 4) = make_float4(f[4], f[5], f[6], f[7]);
    }
}

// ---- 1. chunk states: ltot and U_n = k_carry^T v ---------------------

template <int C, int K>
struct StateShape {
  static constexpr int CW = 2;            // U in blocks of 4 rows x CW columns
  static constexpr int NGY = K / 4;
  static constexpr int NGX = K / CW;
  static constexpr int NU = NGY * NGX;    // threads of the product
  static constexpr size_t kSmem = sizeof(float) * (size_t)(6 * C * K + K);
};

// Persistent: CTA b takes chunks b, b + gridDim.x, ... (chunk g is chunk
// g % N of head g / N), with two buffers of (k, v, lw) tiles: the next
// chunk's copies run while this one computes.
template <int C, int K, typename T>
__global__ void __launch_bounds__(kStateThreads, 1)
wkv_state_kernel(const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ lw,
                 float* __restrict__ states, float* __restrict__ ltot, int t, int n_chunks,
                 int n_work) {
  using S = StateShape<C, K>;
  constexpr int NT = kStateThreads;
  extern __shared__ float4 smem4[];
  float* const bufs = reinterpret_cast<float*>(smem4);  // 2 x (k, v, lw), each (C, K)
  float* const lt = bufs + 6 * C * K;                   // ltot per channel
  const int tid = threadIdx.x;

  auto start_copy = [&](int g, float* dst) {
    if (g < n_work) {
      const int t0 = (g % n_chunks) * C;
      const size_t base = (size_t)(g / n_chunks) * t * K;
      copy_tile<C, K, K, NT>(dst, k + base, t0, t);
      copy_tile<C, K, K, NT>(dst + C * K, v + base, t0, t);
      copy_tile<C, K, K, NT>(dst + 2 * C * K, lw + base, t0, t);
    }
    cp_async_commit();
  };
  start_copy(blockIdx.x, bufs);
  int it = 0;
  for (int g = blockIdx.x; g < n_work; g += gridDim.x, ++it) {
    float* const ks = bufs + (it & 1) * 3 * C * K;  // k, then k_carry
    float* const vs = ks + C * K;                   // v
    float* const ls = vs + C * K;                   // lw, then the inclusive cumsum
    start_copy(g + gridDim.x, bufs + ((it + 1) & 1) * 3 * C * K);
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (sizeof(T) == 2) {
      float* const tiles[3] = {ks, vs, ls};
      widen<C, K, K, NT>(tiles);
      __syncthreads();
    }

    if (tid < K) {  // the sequential cumsum, one thread a channel
      float acc = 0.f;
      for (int i = 0; i < C; ++i) {
        acc += ls[i * K + tid];
        ls[i * K + tid] = acc;
      }
      lt[tid] = acc;
      ltot[(size_t)g * K + tid] = acc;
    }
    __syncthreads();
    for (int idx = tid; idx < C * K; idx += NT)
      ks[idx] = ks[idx] * expf(fminf(lt[idx % K] - ls[idx], kClamp));
    __syncthreads();

    if (tid < S::NU) {  // U rows 4 gy.., cols CW gx..; the sum over tokens in order
      constexpr int CW = S::CW;
      const int gy = tid / S::NGX, gx = tid % S::NGX;
      float upd[4][CW];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < CW; ++b) upd[a][b] = 0.f;
#pragma unroll 4
      for (int i = 0; i < C; ++i) {
        const float4 ka = *reinterpret_cast<const float4*>(ks + i * K + 4 * gy);
        float vb[CW];
#pragma unroll
        for (int b = 0; b < CW; b += 2) {
          const float2 x = *reinterpret_cast<const float2*>(vs + i * K + CW * gx + b);
          vb[b] = x.x;
          vb[b + 1] = x.y;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < CW; ++b) upd[a][b] = fmaf(lane4(ka, a), vb[b], upd[a][b]);
      }
      float* dst = states + (size_t)g * K * K;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < CW; b += 2)
          *reinterpret_cast<float2*>(dst + (4 * gy + a) * K + CW * gx + b) =
              make_float2(upd[a][b], upd[a][b + 1]);
    }
    __syncthreads();  // this buffer is refilled two chunks on
  }
  cp_async_wait<0>();
}

// ---- 2. the carry: U_n -> S_n in place, S_0 = 0 ------------------------

__global__ void __launch_bounds__(kCarryThreads)
wkv_carry_kernel(float* __restrict__ states, const float* __restrict__ ltot, int n_chunks,
                 int kk, long long n_threads) {
  const long long g = (long long)blockIdx.x * kCarryThreads + threadIdx.x;
  if (g >= n_threads) return;
  const int per_head = kk * kk / 4;               // float4 entries of one state
  const long long bh = g / per_head;
  const int e = (int)(g % per_head), c = 4 * e / kk;
  float4* st = reinterpret_cast<float4*>(states) + bh * n_chunks * per_head + e;
  const float* lt = ltot + bh * n_chunks * kk + c;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int n0 = 0; n0 < n_chunks; n0 += kCarryBatch) {
    float4 upd[kCarryBatch];
    float l[kCarryBatch];
#pragma unroll
    for (int j = 0; j < kCarryBatch; ++j) {
      if (n0 + j < n_chunks) {
        upd[j] = st[(size_t)(n0 + j) * per_head];
        l[j] = lt[(size_t)(n0 + j) * kk];
      }
    }
#pragma unroll
    for (int j = 0; j < kCarryBatch; ++j) {
      if (n0 + j < n_chunks) {
        const float decay = expf(l[j]);
        st[(size_t)(n0 + j) * per_head] = s;
        s.x = s.x * decay + upd[j].x;
        s.y = s.y * decay + upd[j].y;
        s.z = s.z * decay + upd[j].z;
        s.w = s.w * decay + upd[j].w;
      }
    }
  }
}

// ---- 3. the output of a chunk ------------------------------------------

template <int C, int K>
struct OutShape {
  static constexpr int NT = C * K / 4 < 512 ? C * K / 4 : 512;  // threads
  static constexpr int NX = K / 4;       // column groups: channels 4 tx .. 4 tx + 3
  static constexpr int NY = NT / NX;     // row groups: tokens ty + NY a
  static constexpr int MR = C / NY;      // token rows a thread
  static constexpr int NJ = (C + NX - 1) / NX;  // score columns a thread: tx + NX b < C
  static constexpr int LDK = K + 4;      // r and k rows: the rows a warp reads as float4
  static constexpr int LDC = C + 4;      // lie in different banks
  static constexpr int kScores = C * LDC > C * K ? C * LDC : C * K;  // scores or li
  static constexpr int kFloats = 2 * C * LDK + 2 * C * K + K * K + kScores + C + K;
  static constexpr size_t kSmem = sizeof(float) * (size_t)kFloats;
  static constexpr bool kAllCols = NX * NJ == C;  // else (C 8, K 64) threads tx >= C own no column
  static_assert(NY % 4 == 0 && NY * MR == C && (kAllCols || NJ == 1), "thread grid");
};

// Persistent: CTA b takes chunks b, b + gridDim.x, ... (chunk g is chunk g %
// N of head g / N).  The next chunk's tiles are copied in with cp.async as
// their buffers free up: lw once ri and kj are made, r, k and S_n once the
// scores are, v once the output is written; each copy is waited for only
// where it is read.
template <int C, int K, typename T>
__global__ void __launch_bounds__(OutShape<C, K>::NT, 1)
wkv_out_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ lw, const float* __restrict__ u,
               const float* __restrict__ states, T* __restrict__ out, int t, int n_chunks,
               int n_work) {
  using S = OutShape<C, K>;
  constexpr int NT = S::NT, NX = S::NX, NY = S::NY, MR = S::MR, NJ = S::NJ;
  extern __shared__ float4 smem4[];
  float* const rs = reinterpret_cast<float*>(smem4);  // r, then ri (C, LDK)
  float* const ks = rs + C * S::LDK;                  // k, then kj (C, LDK)
  float* const vs = ks + C * S::LDK;                  // v (C, K)
  float* const st = vs + C * K;                       // S_n (K, K)
  float* const sc = st + K * K;                       // the inclusive cumsum (C, K),
  float* const li = sc;                               //   then the scores (C, LDC)
  float* const lx = sc + S::kScores;                  // lw, then the exclusive cumsum
  float* const dg = lx + C * K;                       // sum(r k u) per token
  float* const us = dg + C;                           // u
  const int tid = threadIdx.x;

  auto copy_lw = [&](int g) {
    if (g < n_work)
      copy_tile<C, K, K, NT>(lx, lw + (size_t)(g / n_chunks) * t * K, (g % n_chunks) * C, t);
    cp_async_commit();
  };
  auto copy_rks = [&](int g) {
    if (g < n_work) {
      const size_t base = (size_t)(g / n_chunks) * t * K;
      const int t0 = (g % n_chunks) * C;
      copy_tile<C, K, S::LDK, NT>(rs, r + base, t0, t);
      copy_tile<C, K, S::LDK, NT>(ks, k + base, t0, t);
      const float* sn = states + (size_t)g * K * K;
      for (int idx = tid; idx < K * K / 4; idx += NT) cp_async16(st + 4 * idx, sn + 4 * idx, true);
    }
    cp_async_commit();
  };
  auto copy_v = [&](int g) {
    if (g < n_work)
      copy_tile<C, K, K, NT>(vs, v + (size_t)(g / n_chunks) * t * K, (g % n_chunks) * C, t);
    cp_async_commit();
  };
  auto load_u = [&](int g) {
    if (g < n_work)
      for (int c = tid; c < K; c += NT) us[c] = u[(size_t)(g / n_chunks) * K + c];
  };

  int g = blockIdx.x;
  copy_lw(g);
  copy_rks(g);
  copy_v(g);
  load_u(g);
  for (; g < n_work; g += gridDim.x) {
    const int t0 = (g % n_chunks) * C;
    const size_t base = (size_t)(g / n_chunks) * t * K;
    const int gn = g + gridDim.x;
    cp_async_wait<1>();  // lw, r, k and S_n are in; v may not be
    __syncthreads();
    if constexpr (sizeof(T) == 2) {
      float* const rk[2] = {rs, ks};
      float* const l[1] = {lx};
      widen<C, K, S::LDK, NT>(rk);
      widen<C, K, K, NT>(l);
      __syncthreads();
    }

    if (tid < K) {  // the sequential cumsum, one thread a channel
      float acc = 0.f;
      for (int i = 0; i < C; ++i) {
        const float lwv = lx[i * K + tid];
        acc += lwv;
        lx[i * K + tid] = acc - lwv;
        li[i * K + tid] = acc;
      }
    } else {  // meanwhile the u diagonal from the raw r and k, a thread a token
      for (int i = tid - K; i < C; i += NT - K) {
        float d = 0.f;
        for (int c = 0; c < K; c += 4) {
          const float4 r4 = *reinterpret_cast<const float4*>(rs + i * S::LDK + c);
          const float4 k4 = *reinterpret_cast<const float4*>(ks + i * S::LDK + c);
          const float4 u4 = *reinterpret_cast<const float4*>(us + c);
          d += r4.x * (k4.x * u4.x);
          d += r4.y * (k4.y * u4.y);
          d += r4.z * (k4.z * u4.z);
          d += r4.w * (k4.w * u4.w);
        }
        dg[i] = d;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < C * K; idx += NT) {  // in place: r -> ri, k -> kj
      const int at = idx / K * S::LDK + idx % K;
      rs[at] *= expf(lx[idx]);
      ks[at] = ks[at] * expf(fminf(fmaxf(-li[idx], -kClamp), kClamp));
    }
    __syncthreads();
    copy_lw(gn);

    // scores (rows ty + NY a, cols tx + NX b, only blocks that reach below the
    // diagonal) and inter = ri S_n (rows ty + NY a, cols 4 tx ..), one pass over c
    const int ty = tid / NX, tx = tid % NX;
    float inter[MR][4], s[MR][NJ];
#pragma unroll
    for (int a = 0; a < MR; ++a) {
#pragma unroll
      for (int e = 0; e < 4; ++e) inter[a][e] = 0.f;
#pragma unroll
      for (int b = 0; b < NJ; ++b) s[a][b] = 0.f;
    }
#pragma unroll 1
    for (int c = 0; c < K; c += 4) {
      float4 ra[MR], sb[4];
#pragma unroll
      for (int a = 0; a < MR; ++a)
        ra[a] = *reinterpret_cast<const float4*>(rs + (ty + NY * a) * S::LDK + c);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sb[e] = *reinterpret_cast<const float4*>(st + (c + e) * K + 4 * tx);
#pragma unroll
      for (int a = 0; a < MR; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = lane4(ra[a], e);
          inter[a][0] = fmaf(x, sb[e].x, inter[a][0]);
          inter[a][1] = fmaf(x, sb[e].y, inter[a][1]);
          inter[a][2] = fmaf(x, sb[e].z, inter[a][2]);
          inter[a][3] = fmaf(x, sb[e].w, inter[a][3]);
        }
#pragma unroll
      for (int b = 0; b < NJ; ++b) {
        if (!S::kAllCols && tx + NX * b >= C) continue;
        const float4 kb = *reinterpret_cast<const float4*>(ks + (tx + NX * b) * S::LDK + c);
#pragma unroll
        for (int a = 0; a < MR; ++a) {
          if (NX * b >= NY * (a + 1)) continue;  // every column of block b is >= every row
          s[a][b] = fmaf(ra[a].x, kb.x, s[a][b]);
          s[a][b] = fmaf(ra[a].y, kb.y, s[a][b]);
          s[a][b] = fmaf(ra[a].z, kb.z, s[a][b]);
          s[a][b] = fmaf(ra[a].w, kb.w, s[a][b]);
        }
      }
    }
    // the scores, strictly causal, with +0 above the diagonal; every step of
    // four columns that intra reads (j0 < i) lies in a block written here
#pragma unroll
    for (int a = 0; a < MR; ++a)
#pragma unroll
      for (int b = 0; b < NJ; ++b) {
        if (NX * b >= NY * (a + 1)) continue;
        const int i = ty + NY * a, j = tx + NX * b;
        if (!S::kAllCols && j >= C) continue;
        sc[i * S::LDC + j] = j < i ? s[a][b] : 0.f;
      }
    __syncthreads();
    copy_rks(gn);        // ri, kj and S_n are spent
    cp_async_wait<2>();   // this chunk's v is in
    __syncthreads();
    if constexpr (sizeof(T) == 2) {
      float* const vt[1] = {vs};
      widen<C, K, K, NT>(vt);
      __syncthreads();
    }

    // intra = scores v, columns in order, steps of four that start before the row
    float intra[MR][4];
#pragma unroll
    for (int a = 0; a < MR; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) intra[a][e] = 0.f;
    const int last = ty + NY * (MR - 1);
#pragma unroll 1
    for (int j0 = 0; j0 < last; j0 += 4) {
      float4 vb[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        vb[e] = *reinterpret_cast<const float4*>(vs + (j0 + e) * K + 4 * tx);
#pragma unroll
      for (int a = 0; a < MR; ++a) {
        const int i = ty + NY * a;
        if (j0 >= i) continue;
        const float4 sa = *reinterpret_cast<const float4*>(sc + i * S::LDC + j0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = lane4(sa, e);
          intra[a][0] = fmaf(x, vb[e].x, intra[a][0]);
          intra[a][1] = fmaf(x, vb[e].y, intra[a][1]);
          intra[a][2] = fmaf(x, vb[e].z, intra[a][2]);
          intra[a][3] = fmaf(x, vb[e].w, intra[a][3]);
        }
      }
    }

#pragma unroll
    for (int a = 0; a < MR; ++a) {
      const int i = ty + NY * a;
      if (t0 + i >= t) continue;
      const float d = dg[i];
      const float4 vi = *reinterpret_cast<const float4*>(vs + i * K + 4 * tx);
      float4 o;
      o.x = (intra[a][0] + d * vi.x) + inter[a][0];
      o.y = (intra[a][1] + d * vi.y) + inter[a][1];
      o.z = (intra[a][2] + d * vi.z) + inter[a][2];
      o.w = (intra[a][3] + d * vi.w) + inter[a][3];
      store4(out + base + (size_t)(t0 + i) * K + 4 * tx, o);
    }
    __syncthreads();
    copy_v(gn);          // v and u are spent
    load_u(gn);
  }
  cp_async_wait<0>();
}

// ---- launch -------------------------------------------------------------

// CTAs of ``kernel`` that fit on the card at once: the grid of a persistent kernel.
template <typename F>
cudaError_t resident(F kernel, int threads, size_t smem, long long* out) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  *out = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
  return err;
}

template <int C, int K, typename T>
int launch(const void* r, const void* k, const void* v, const void* lw, const float* u,
           void* out, float* states, float* ltot, int bh, int t, cudaStream_t st) {
  using O = OutShape<C, K>;
  using SS = StateShape<C, K>;
  const int n_chunks = (t + C - 1) / C;
  const long long ctas = (long long)bh * n_chunks;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  long long fit_state = 0, fit_out = 0;
  cudaError_t err = cudaFuncSetAttribute(wkv_state_kernel<C, K, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SS::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv_out_kernel<C, K, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)O::kSmem);
  if (err == cudaSuccess)
    err = resident(wkv_state_kernel<C, K, T>, kStateThreads, SS::kSmem, &fit_state);
  if (err == cudaSuccess) err = resident(wkv_out_kernel<C, K, T>, O::NT, O::kSmem, &fit_out);
  if (err != cudaSuccess) return (int)err;
  wkv_state_kernel<C, K, T>
      <<<(unsigned)(ctas < fit_state ? ctas : fit_state), kStateThreads, SS::kSmem, st>>>(
          static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(lw), states,
          ltot, t, n_chunks, (int)ctas);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long carry_threads = (long long)bh * K * K / 4;
  wkv_carry_kernel<<<(unsigned)((carry_threads + kCarryThreads - 1) / kCarryThreads),
                     kCarryThreads, 0, st>>>(states, ltot, n_chunks, K, carry_threads);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wkv_out_kernel<C, K, T><<<(unsigned)(ctas < fit_out ? ctas : fit_out), O::NT, O::kSmem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(lw), u, states, static_cast<T*>(out), t, n_chunks, (int)ctas);
  return (int)cudaGetLastError();
}

// {CTAs, threads, shared memory bytes} of the state, carry and output
// kernels of one f32 call at these sizes, as launch sets them.
template <int C, int K>
int shape(int bh, int t, int* dst) {
  using O = OutShape<C, K>;
  using SS = StateShape<C, K>;
  const long long ctas = (long long)bh * ((t + C - 1) / C);
  long long fit_state = 0, fit_out = 0;
  cudaError_t err = cudaFuncSetAttribute(wkv_state_kernel<C, K, float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SS::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv_out_kernel<C, K, float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)O::kSmem);
  if (err == cudaSuccess)
    err = resident(wkv_state_kernel<C, K, float>, kStateThreads, SS::kSmem, &fit_state);
  if (err == cudaSuccess) err = resident(wkv_out_kernel<C, K, float>, O::NT, O::kSmem, &fit_out);
  if (err != cudaSuccess) return (int)err;
  const long long carry_threads = (long long)bh * K * K / 4;
  const long long vals[9] = {ctas < fit_state ? ctas : fit_state, kStateThreads, (long long)SS::kSmem,
                             (carry_threads + kCarryThreads - 1) / kCarryThreads, kCarryThreads, 0,
                             ctas < fit_out ? ctas : fit_out, O::NT, (long long)O::kSmem};
  for (int i = 0; i < 9; ++i) dst[i] = (int)vals[i];
  return 0;
}

template <int K, typename T>
int by_chunk(int chunk, const void* r, const void* k, const void* v, const void* lw,
             const float* u, void* out, float* states, float* ltot, int bh, int t,
             cudaStream_t st, int* shape_out) {
  switch (chunk) {
    case 8: return shape_out ? shape<8, K>(bh, t, shape_out)
                             : launch<8, K, T>(r, k, v, lw, u, out, states, ltot, bh, t, st);
    case 16: return shape_out ? shape<16, K>(bh, t, shape_out)
                              : launch<16, K, T>(r, k, v, lw, u, out, states, ltot, bh, t, st);
    case 32: return shape_out ? shape<32, K>(bh, t, shape_out)
                              : launch<32, K, T>(r, k, v, lw, u, out, states, ltot, bh, t, st);
    case 64: return shape_out ? shape<64, K>(bh, t, shape_out)
                              : launch<64, K, T>(r, k, v, lw, u, out, states, ltot, bh, t, st);
    case 128: return shape_out ? shape<128, K>(bh, t, shape_out)
                               : launch<128, K, T>(r, k, v, lw, u, out, states, ltot, bh, t, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int by_head(int kk, int chunk, const void* r, const void* k, const void* v, const void* lw,
            const float* u, void* out, float* states, float* ltot, int bh, int t,
            cudaStream_t st, int* shape_out = nullptr) {
  switch (kk) {
    case 16: return by_chunk<16, T>(chunk, r, k, v, lw, u, out, states, ltot, bh, t, st, shape_out);
    case 32: return by_chunk<32, T>(chunk, r, k, v, lw, u, out, states, ltot, bh, t, st, shape_out);
    case 64: return by_chunk<64, T>(chunk, r, k, v, lw, u, out, states, ltot, bh, t, st, shape_out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  r, k, v, lw, out (bh, t, kk); u (bh, kk) f32;
// scratch: states (bh, ceil(t / chunk), kk, kk) and ltot (bh, ceil(t / chunk), kk) f32.
extern "C" int wkv_launch(const void* r, const void* k, const void* v, const void* lw,
                          const float* u, void* out, float* states, float* ltot, int dtype,
                          int bh, int t, int kk, int chunk, void* stream) {
  if (bh < 1 || t < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_head<float>(kk, chunk, r, k, v, lw, u, out, states, ltot, bh, t, st);
  if (dtype == 1)
    return by_head<__nv_bfloat16>(kk, chunk, r, k, v, lw, u, out, states, ltot, bh, t, st);
  return (int)cudaErrorInvalidValue;
}

// The launch shape of one f32 call: dst[0..9) = CTAs, threads and shared
// memory bytes of the state, carry and output kernels.
extern "C" int wkv_shape(int bh, int t, int kk, int chunk, int* dst) {
  if (bh < 1 || t < 1) return (int)cudaErrorInvalidValue;
  return by_head<float>(kk, chunk, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                        nullptr, nullptr, bh, t, nullptr, dst);
}

extern "C" const char* wkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
