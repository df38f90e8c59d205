// K8's split decode step (attn_decode_update.cu, a contiguous [B, Hkv, S, D]
// cache): insert each row's new K/V, then attend over the slots that row
// sees, with the slots cut into splits of `ps` that run in parallel
// (flash-decoding).  A row's new K/V goes at min(pos, S - 1), as zllm's
// dynamic_update_slice clamps, so a trash row (pos == S) writes slot S - 1
// and attends all S.
//
// q[B, 1, Hq, D] (roped, not rounded to the cache dtype) and the new rows
// k/v_new[B, 1, Hkv, D] (roped K); the new rows are cast to the cache dtype.
// GQA attention over slots <= pos (and > pos - window), logit softcap, f32
// scores and softmax; the output is in q's dtype.  The probabilities are
// normalized, then cast to the cache dtype before P.V (f32 accumulate), as
// zllm's `_attn_decode_kernel` does.
//
// Bound on the H100: the bytes of the K/V slots each row sees, 2 * Hkv *
// (visible slots) * D * sizeof(cache) a row, over 3.35 TB/s; the work is a
// few FLOPs a byte.  Design, in three launches:
//   1. scores, grid (split, kv head x query-group chunk, row): a thread per
//      slot of the split dots its K row (16-byte loads) with the chunk's <= 8
//      query rows (shared memory), writes the scores to a global f32 scratch
//      row and the split's per-head max and sum of exponentials to a stats
//      scratch;
//   2. P.V, same grid: each split's block combines the splits' stats into
//      the row's max and denominator, forms the probabilities rounded to the
//      cache dtype, and sums P.V over its split's V rows (staged through
//      shared memory) into a per-split partial;
//   3. the partials of a row's splits are summed in split order.
// The insert: the blocks of the split that holds the insert slot dot it from
// their shared copy of the new K row (rounded to the cache dtype), and the
// chunk-0 block writes the row in launch 1; launch 2 reads V from the cache.
// No block writes any other slot, and no other block reads the insert slot
// in launch 1.  Query groups wider than 8 run as chunks of 8 on more blocks.

#pragma once

#include "attn_tile.cuh"

namespace zt_split {

using zt_attn::from_f;
using zt_attn::to_f;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int MAXG = 8;   // query rows a block takes (a chunk of the group)
constexpr int KT = 64;    // V rows a P.V sub-tile stages through shared memory
constexpr unsigned kFull = 0xffffffffu;

// the G query rows (f32, shared, row stride D) . one cache row, the row
// read as 16-byte loads first
template <int D>
__device__ __forceinline__ void dot_rows(const float* q, const float* row, int G, float* acc) {
  float4 buf[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) buf[i] = reinterpret_cast<const float4*>(row)[i];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    const float* qg = q + g * D;
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      a += qg[4 * i] * buf[i].x;
      a += qg[4 * i + 1] * buf[i].y;
      a += qg[4 * i + 2] * buf[i].z;
      a += qg[4 * i + 3] * buf[i].w;
    }
    acc[g] = a;
  }
}
template <int D>
__device__ __forceinline__ void dot_rows(const float* q, const __nv_bfloat16* row, int G,
                                         float* acc) {
  uint4 buf[D / 8];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) buf[i] = reinterpret_cast<const uint4*>(row)[i];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    const float* qg = q + g * D;
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&buf[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h2[j]);
        a += qg[8 * i + 2 * j] * f.x;
        a += qg[8 * i + 2 * j + 1] * f.y;
      }
    }
    acc[g] = a;
  }
}

// block-wide reduction of one value per head; every thread gets the results
template <bool MAX>
__device__ void block_reduce(float* v, int G, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    float x = v[g];
    for (int o = 16; o; o >>= 1) {
      const float w = __shfl_xor_sync(kFull, x, o);
      x = MAX ? fmaxf(x, w) : x + w;
    }
    v[g] = x;
  }
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) red[g * kWarps + warp] = v[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    float t = red[g * kWarps];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) t = MAX ? fmaxf(t, red[g * kWarps + i]) : t + red[g * kWarps + i];
    v[g] = t;
  }
}

// the slots of row b a query at pos attends: [lo, hi]
struct Span {
  int lo, hi;
  __device__ Span(int pos, int S, int window) {
    hi = pos < S - 1 ? pos : S - 1;
    lo = window > 0 ? pos - window + 1 : 0;
    lo = lo < 0 ? 0 : lo;
  }
};

struct Args {
  const int* pos;
  float* scores;  // [B, Hq, S]
  float* stats;   // [B, Hq, NP, 2]: the split's max and sum of exp(score - max)
  float* part;    // [B, Hq, NP, D]: the split's P.V
  int Hq, Hkv, S, NP, ps;  // S slots a row, NP = ceil(S / ps) splits of ps
  float scale, softcap;
  int window;
};

// K8's contiguous caches [B, Hkv, S, D]: split j is slots j*ps .. j*ps+ps-1
struct ContigAddr {
  int Hkv, S;
  __device__ size_t split_base(int b, int h, int j, int ps, int D) const {
    return (((size_t)b * Hkv + h) * S + (size_t)j * ps) * D;
  }
};

// launch 1: grid (NP, Hkv * GC, B), GC = ceil(G / MAXG) chunks of the group
template <typename TQ, typename TP, int D, typename Addr>
__global__ void __launch_bounds__(kThreads) split_scores(const TQ* __restrict__ q,
                                                         const TQ* __restrict__ k_new,
                                                         const TQ* __restrict__ v_new,
                                                         TP* __restrict__ k_cache,
                                                         TP* __restrict__ v_cache, const Args a,
                                                         const Addr addr) {
  __shared__ float qsh[MAXG * D];
  __shared__ float knew[D];
  __shared__ float red[MAXG * kWarps];
  const int G = a.Hq / a.Hkv, GC = (G + MAXG - 1) / MAXG;
  const int j = blockIdx.x, h = blockIdx.y / GC, c = blockIdx.y % GC, b = blockIdx.z;
  const int tid = threadIdx.x, g0 = c * MAXG, Gc = min(MAXG, G - g0);
  const int head0 = h * G + g0, S = a.S, NP = a.NP;
  const int pos = a.pos[b];
  const int pw = min(pos, S - 1);  // the insert slot
  const bool ins_here = pw / a.ps == j;
  const size_t base = addr.split_base(b, h, j, a.ps, D);
  if (ins_here) {  // this block's head row of the insert split
    for (int i = tid; i < D; i += kThreads) {
      const TP kv = from_f<TP>(to_f(k_new[((size_t)b * a.Hkv + h) * D + i]));
      knew[i] = to_f(kv);
      if (c == 0) {
        k_cache[base + (size_t)(pw % a.ps) * D + i] = kv;
        v_cache[base + (size_t)(pw % a.ps) * D + i] =
            from_f<TP>(to_f(v_new[((size_t)b * a.Hkv + h) * D + i]));
      }
    }
  }
  const Span sp(pos, S, a.window);
  const int s0 = max(j * a.ps, sp.lo), s1 = min(j * a.ps + a.ps - 1, sp.hi);
  if (s0 > s1) return;  // a split the row does not see (its stats are never read)
  float* st = a.stats + ((size_t)(b * a.Hq + head0) * NP + j) * 2;  // head g at + g * NP * 2

  for (int e = tid; e < Gc * D; e += kThreads) qsh[e] = to_f(q[((size_t)b * a.Hq + head0) * D + e]);
  __syncthreads();

  const TP* kh = k_cache + base;
  float* srow = a.scores + ((size_t)b * a.Hq + head0) * S;  // Gc rows of S
  float mx[MAXG], acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) mx[g] = -INFINITY;
  for (int s = s0 + tid; s <= s1; s += kThreads) {
    if (ins_here && s == pw) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= Gc) break;
        float x = 0.f;
#pragma unroll 8
        for (int i = 0; i < D; ++i) x += qsh[g * D + i] * knew[i];
        acc[g] = x;
      }
    } else {
      dot_rows<D>(qsh, kh + (size_t)(s % a.ps) * D, Gc, acc);
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= Gc) break;
      float sc = acc[g] * a.scale;
      if (a.softcap > 0.f) sc = tanhf(sc / a.softcap) * a.softcap;
      srow[(size_t)g * S + s] = sc;
      mx[g] = fmaxf(mx[g], sc);
    }
  }
  block_reduce<true>(mx, Gc, red);
  float l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) l[g] = 0.f;
  for (int s = s0 + tid; s <= s1; s += kThreads) {  // the scores this thread wrote
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= Gc) break;
      l[g] += expf(srow[(size_t)g * S + s] - mx[g]);
    }
  }
  block_reduce<false>(l, Gc, red);
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= Gc) break;
      st[(size_t)g * NP * 2] = mx[g];
      st[(size_t)g * NP * 2 + 1] = l[g];
    }
  }
}

// launch 2: grid (NP, Hkv * GC, B)
template <typename TP, int D, typename Addr>
__global__ void __launch_bounds__(kThreads) split_pv(const TP* __restrict__ v_cache, const Args a,
                                                     const Addr addr) {
  constexpr int kOut = MAXG * D / kThreads;  // outputs (g, d) a thread holds, at most
  __shared__ float psh[MAXG * KT];
  __shared__ __align__(16) float vsh[KT * D];
  __shared__ float m_row[MAXG], l_row[MAXG];
  const int G = a.Hq / a.Hkv, GC = (G + MAXG - 1) / MAXG;
  const int j = blockIdx.x, h = blockIdx.y / GC, c = blockIdx.y % GC, b = blockIdx.z;
  const int tid = threadIdx.x, Gc = min(MAXG, G - c * MAXG), head0 = h * G + c * MAXG;
  const int S = a.S, NP = a.NP;
  const Span sp(a.pos[b], S, a.window);
  const int s0 = max(j * a.ps, sp.lo), s1 = min(j * a.ps + a.ps - 1, sp.hi);
  if (s0 > s1) return;
  if (tid < Gc) {  // the row's max and denominator from every visible split's stats
    const float* st = a.stats + (size_t)(b * a.Hq + head0 + tid) * NP * 2;
    const int j0 = sp.lo / a.ps, j1 = sp.hi / a.ps;
    float m = -INFINITY;
    for (int jj = j0; jj <= j1; ++jj) m = fmaxf(m, st[2 * jj]);
    float l = 0.f;
    for (int jj = j0; jj <= j1; ++jj)
      if (st[2 * jj + 1] > 0.f) l += st[2 * jj + 1] * expf(st[2 * jj] - m);
    m_row[tid] = m;
    l_row[tid] = l;
  }
  const float* srow = a.scores + ((size_t)b * a.Hq + head0) * S;
  const TP* vh = v_cache + addr.split_base(b, h, j, a.ps, D);
  float acc[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = 0.f;
  __syncthreads();

  for (int t0 = s0; t0 <= s1; t0 += KT) {
    const int n = min(KT, s1 - t0 + 1);
    for (int e = tid; e < Gc * KT; e += kThreads) {
      const int g = e / KT, i = e % KT;
      const float l = l_row[g];
      float p = 0.f;
      if (i < n && l > 0.f) {
        p = expf(srow[(size_t)g * S + t0 + i] - m_row[g]) / l;
        p = to_f(from_f<TP>(p));
      }
      psh[e] = p;
    }
    // the sub-tile's V rows, 16 bytes a load; rows past s1 are zeros
    constexpr int kVec = 16 / sizeof(TP);
    const TP* vt = vh + (size_t)(t0 % a.ps) * D;
    for (int e = tid; e < KT * D / kVec; e += kThreads) {
      const int i = e * kVec / D;
      float* dst = vsh + e * kVec;
      if (i < n) {
        const uint4 raw = reinterpret_cast<const uint4*>(vt)[e];
        const TP* x = reinterpret_cast<const TP*>(&raw);
#pragma unroll
        for (int cc = 0; cc < kVec; ++cc) dst[cc] = to_f(x[cc]);
      } else {
#pragma unroll
        for (int cc = 0; cc < kVec; ++cc) dst[cc] = 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      const int e = tid + k * kThreads, g = e / D, d = e % D;
      if (g < Gc) {
        float x = acc[k];
#pragma unroll 8
        for (int i = 0; i < KT; ++i) x += psh[g * KT + i] * vsh[i * D + d];
        acc[k] = x;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int e = tid + k * kThreads, g = e / D, d = e % D;
    if (g < Gc) a.part[((size_t)(b * a.Hq + head0 + g) * NP + j) * D + d] = acc[k];
  }
}

// launch 3: grid (Hq, B), D threads: out = the sum of the visible splits' P.V
template <typename TQ, int D>
__global__ void __launch_bounds__(D) split_sum(TQ* __restrict__ out, const Args a) {
  const int head = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const Span sp(a.pos[b], a.S, a.window);
  const int j0 = sp.lo / a.ps, j1 = sp.hi / a.ps;
  const float* p = a.part + (size_t)(b * a.Hq + head) * a.NP * D + d;
  float o = 0.f;
  for (int jj = j0; jj <= j1; ++jj) o += p[(size_t)jj * D];
  out[((size_t)b * a.Hq + head) * D + d] = from_f<TQ>(o);
}

template <typename TQ, typename TP, typename Addr>
int launch(const void* q, const void* k_new, const void* v_new, void* k_cache, void* v_cache,
           void* out, int B, int D, const Args& a, const Addr& addr, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  const dim3 grid(a.NP, a.Hkv * ((G + MAXG - 1) / MAXG), B);
#define ZT_LAUNCH(DD)                                                                         \
  split_scores<TQ, TP, DD, Addr><<<grid, kThreads, 0, stream>>>(                              \
      static_cast<const TQ*>(q), static_cast<const TQ*>(k_new), static_cast<const TQ*>(v_new), \
      static_cast<TP*>(k_cache), static_cast<TP*>(v_cache), a, addr);                         \
  split_pv<TP, DD, Addr><<<grid, kThreads, 0, stream>>>(static_cast<const TP*>(v_cache), a,   \
                                                        addr);                                \
  split_sum<TQ, DD><<<dim3(a.Hq, B), DD, 0, stream>>>(static_cast<TQ*>(out), a)
  if (D == 64) {
    ZT_LAUNCH(64);
  } else if (D == 128) {
    ZT_LAUNCH(128);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef ZT_LAUNCH
  return (int)cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16 (q, k_new, v_new share one; the
// cache another).  The scratch is f32 [B, Hq, S + NP * (D + 2)].
template <typename Addr>
int dispatch(const void* q, const void* k_new, const void* v_new, int q_dtype, void* k_cache,
             void* v_cache, int c_dtype, const int* pos, void* out, float* scratch, int B, int Hq,
             int Hkv, int D, int S, int ps, float scale, float softcap, int window,
             const Addr& addr, void* stream) {
  if ((D != 64 && D != 128) || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || ps <= 0)
    return (int)cudaErrorInvalidValue;
  const int np = (S + ps - 1) / ps;
  const size_t rows = (size_t)B * Hq;
  const Args a{pos, scratch, scratch + rows * S, scratch + rows * (S + 2 * (size_t)np),
               Hq, Hkv, S, np, ps, scale, softcap, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZT_ARGS q, k_new, v_new, k_cache, v_cache, out, B, D, a, addr, st
  if (q_dtype == 0 && c_dtype == 0) return launch<float, float>(ZT_ARGS);
  if (q_dtype == 0 && c_dtype == 1) return launch<float, __nv_bfloat16>(ZT_ARGS);
  if (q_dtype == 1 && c_dtype == 0) return launch<__nv_bfloat16, float>(ZT_ARGS);
  if (q_dtype == 1 && c_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(ZT_ARGS);
#undef ZT_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace zt_split
