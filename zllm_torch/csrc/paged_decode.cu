// K9: the paged decode step of one layer: insert the new K/V row into its
// page, then attend over the page table.
//
// Replaces zllm/ops/attention.py::_paged_decode_kernel (launched by
// paged_attn_decode_update): q[B, 1, Hq, D] (roped) and the new rows
// k/v_new[B, 1, Hkv, D] (roped K) of every slot; per-layer pools
// [Hkv, P * ps, D] (token-major: slot s of row b is pool row
// table[b, s / ps] * ps + s % ps); table int32 [B, LP + 1]; pos int32 [B].
// A row with pos < LP * ps (the horizon) writes its new K/V, cast to the
// pool dtype, at its position; a row at or past the horizon (the engine's
// trash rows) writes nothing.  Then GQA attention over slots <= pos (and
// > pos - window), logit softcap, f32 scores and softmax, probabilities
// normalized and cast to the pool dtype before P.V (f32 accumulate), as
// K6 and K10 do.  Pages past pos and outside the window are never read.
//
// Bound on the H100: the bytes of the pages it must read, 2 * Hkv *
// (visible slots) * D * sizeof(pool) a row, over 3.35 TB/s; the work is a
// few FLOPs a byte.  Design: where the TPU kernel walks one page a grid
// step, here every (logical page, kv head, slot) is a block, so a row's
// pages are read in parallel (flash-decoding), in three launches:
//   1. scores: a thread per slot of the page dots its K row (16-byte loads)
//      with the G query rows of the group (shared memory), writes the
//      scores to a global f32 scratch row and the page's per-head max and
//      sum of exponentials to a stats scratch;
//   2. P.V: each page's block combines every page's stats into the row's
//      max and denominator, forms the normalized probabilities rounded to
//      the pool dtype, and sums P.V over its page's V rows (staged through
//      shared memory) into a per-page partial;
//   3. the partials of a row's pages are summed in page order.
// The insert: the block of the page that holds pos writes its head's row
// in launch 1 and dots pos's K from its shared copy; launch 2 reads the
// row from the pool.  No block writes any other page, and other slots read
// only full prefix pages, which are never an insert page.

#include "attn_tile.cuh"

namespace {

using zt_attn::from_f;
using zt_attn::to_f;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int MAXG = 8;
constexpr int KT = 64;  // V rows a P.V sub-tile stages through shared memory
constexpr unsigned kFull = 0xffffffffu;

// the G query rows (f32, shared, row stride D) . one pool row, the row
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
  const int* table;
  const int* pos;
  float* scores;  // [B, Hq, S]
  float* stats;   // [B, Hq, NP, 2]: the page's max and sum of exp(score - max)
  float* part;    // [B, Hq, NP, D]: the page's P.V
  int Hq, Hkv, n_rows, TW, ps;
  float scale, softcap;
  int window;
};

// launch 1: grid (NP, Hkv, B)
template <typename TQ, typename TP, int D>
__global__ void __launch_bounds__(kThreads) k9_scores(const TQ* __restrict__ q,
                                                      const TQ* __restrict__ k_new,
                                                      const TQ* __restrict__ v_new,
                                                      TP* __restrict__ k_pool,
                                                      TP* __restrict__ v_pool, const Args a) {
  __shared__ float qsh[MAXG * D];
  __shared__ float knew[D];
  __shared__ float red[MAXG * kWarps];
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int G = a.Hq / a.Hkv, NP = a.TW - 1, S = NP * a.ps;
  const int pos = a.pos[b];
  const bool ins = pos < S;
  const Span sp(pos, S, a.window);
  const int s0 = max(j * a.ps, sp.lo), s1 = min(j * a.ps + a.ps - 1, sp.hi);
  if (s0 > s1) return;  // a page the row does not see (its stats are never read)
  float* st = a.stats + ((size_t)(b * a.Hq + h * G) * NP + j) * 2;  // head g at + g * NP * 2
  const int* trow = a.table + (size_t)b * a.TW;
  const size_t head_off = (size_t)h * a.n_rows * D;
  const bool ins_here = ins && pos / a.ps == j;

  for (int e = tid; e < G * D; e += kThreads)
    qsh[e] = to_f(q[((size_t)b * a.Hq + h * G) * D + e]);
  if (ins_here) {  // this block's head row of the insert page
    const size_t row = ((size_t)trow[j] * a.ps + pos % a.ps) * D;
    for (int i = tid; i < D; i += kThreads) {
      const TP kv = from_f<TP>(to_f(k_new[((size_t)b * a.Hkv + h) * D + i]));
      knew[i] = to_f(kv);
      k_pool[head_off + row + i] = kv;
      v_pool[head_off + row + i] = from_f<TP>(to_f(v_new[((size_t)b * a.Hkv + h) * D + i]));
    }
  }
  __syncthreads();

  const TP* kh = k_pool + head_off + (size_t)__ldg(trow + j) * a.ps * D;
  float* srow = a.scores + ((size_t)b * a.Hq + h * G) * S;  // G rows of S
  float mx[MAXG], acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) mx[g] = -INFINITY;
  for (int s = s0 + tid; s <= s1; s += kThreads) {
    if (ins_here && s == pos) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        float x = 0.f;
#pragma unroll 8
        for (int i = 0; i < D; ++i) x += qsh[g * D + i] * knew[i];
        acc[g] = x;
      }
    } else {
      dot_rows<D>(qsh, kh + (size_t)(s % a.ps) * D, G, acc);
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float sc = acc[g] * a.scale;
      if (a.softcap > 0.f) sc = tanhf(sc / a.softcap) * a.softcap;
      srow[(size_t)g * S + s] = sc;
      mx[g] = fmaxf(mx[g], sc);
    }
  }
  block_reduce<true>(mx, G, red);
  float l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) l[g] = 0.f;
  for (int s = s0 + tid; s <= s1; s += kThreads) {  // the scores this thread wrote
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      l[g] += expf(srow[(size_t)g * S + s] - mx[g]);
    }
  }
  block_reduce<false>(l, G, red);
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      st[(size_t)g * NP * 2] = mx[g];
      st[(size_t)g * NP * 2 + 1] = l[g];
    }
  }
}

// launch 2: grid (NP, Hkv, B)
template <typename TP, int D>
__global__ void __launch_bounds__(kThreads) k9_pv(const TP* __restrict__ v_pool, const Args a) {
  constexpr int kOut = MAXG * D / kThreads;  // outputs (g, d) a thread holds, at most
  __shared__ float psh[MAXG * KT];
  __shared__ __align__(16) float vsh[KT * D];
  __shared__ float m_row[MAXG], l_row[MAXG];
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int G = a.Hq / a.Hkv, NP = a.TW - 1, S = NP * a.ps;
  const Span sp(a.pos[b], S, a.window);
  const int s0 = max(j * a.ps, sp.lo), s1 = min(j * a.ps + a.ps - 1, sp.hi);
  if (s0 > s1) return;
  if (tid < G) {  // the row's max and denominator from every visible page's stats
    const float* st = a.stats + (size_t)(b * a.Hq + h * G + tid) * NP * 2;
    const int j0 = sp.lo / a.ps, j1 = sp.hi / a.ps;
    float m = -INFINITY;
    for (int jj = j0; jj <= j1; ++jj) m = fmaxf(m, st[2 * jj]);
    float l = 0.f;
    for (int jj = j0; jj <= j1; ++jj)
      if (st[2 * jj + 1] > 0.f) l += st[2 * jj + 1] * expf(st[2 * jj] - m);
    m_row[tid] = m;
    l_row[tid] = l;
  }
  const float* srow = a.scores + ((size_t)b * a.Hq + h * G) * S;
  const TP* vh = v_pool + (size_t)h * a.n_rows * D +
                 (size_t)__ldg(a.table + (size_t)b * a.TW + j) * a.ps * D;
  float acc[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = 0.f;
  __syncthreads();

  for (int t0 = s0; t0 <= s1; t0 += KT) {
    const int n = min(KT, s1 - t0 + 1);
    for (int e = tid; e < G * KT; e += kThreads) {
      const int g = e / KT, i = e % KT;
      const float l = l_row[g];
      psh[e] = (i < n && l > 0.f)
                   ? to_f(from_f<TP>(expf(srow[(size_t)g * S + t0 + i] - m_row[g]) / l))
                   : 0.f;
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
        for (int c = 0; c < kVec; ++c) dst[c] = to_f(x[c]);
      } else {
#pragma unroll
        for (int c = 0; c < kVec; ++c) dst[c] = 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      const int e = tid + k * kThreads, g = e / D, d = e % D;
      if (g < G) {
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
    if (g < G) a.part[((size_t)(b * a.Hq + h * G + g) * NP + j) * D + d] = acc[k];
  }
}

// launch 3: grid (Hq, B), D threads: out = the sum of the visible pages' P.V
template <typename TQ, int D>
__global__ void __launch_bounds__(D) k9_sum(TQ* __restrict__ out, const Args a) {
  const int head = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int NP = a.TW - 1;
  const Span sp(a.pos[b], NP * a.ps, a.window);
  const float* p = a.part + (size_t)(b * a.Hq + head) * NP * D + d;
  float o = 0.f;
  for (int jj = sp.lo / a.ps; jj <= sp.hi / a.ps; ++jj) o += p[(size_t)jj * D];
  out[((size_t)b * a.Hq + head) * D + d] = from_f<TQ>(o);
}

template <typename TQ, typename TP>
int launch(const void* q, const void* k_new, const void* v_new, void* k_pool, void* v_pool,
           void* out, int B, int D, const Args& a, cudaStream_t stream) {
  const dim3 grid(a.TW - 1, a.Hkv, B);
#define ZT_LAUNCH(DD)                                                                         \
  k9_scores<TQ, TP, DD><<<grid, kThreads, 0, stream>>>(                                       \
      static_cast<const TQ*>(q), static_cast<const TQ*>(k_new), static_cast<const TQ*>(v_new), \
      static_cast<TP*>(k_pool), static_cast<TP*>(v_pool), a);                                 \
  k9_pv<TP, DD><<<grid, kThreads, 0, stream>>>(static_cast<const TP*>(v_pool), a);            \
  k9_sum<TQ, DD><<<dim3(a.Hq, B), DD, 0, stream>>>(static_cast<TQ*>(out), a)
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

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k_new, v_new share one; the
// pools another).  Pools [Hkv, n_rows, D]; table int32 [B, TW]; pos int32
// [B]; out [B, Hq, D]; scratch f32 [B, Hq, S + NP * (D + 2)] with
// NP = TW - 1 and S = NP * ps.
extern "C" int zt_paged_attn_decode_update(const void* q, const void* k_new, const void* v_new,
                                           int q_dtype, void* k_pool, void* v_pool, int p_dtype,
                                           const int* table, const int* pos, void* out,
                                           float* scratch, int B, int Hq, int Hkv, int D,
                                           int n_rows, int TW, int ps, float scale,
                                           float softcap, int window, void* stream) {
  if ((D != 64 && D != 128) || Hq % Hkv != 0 || Hq / Hkv > MAXG || TW < 2 || ps <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t np = TW - 1, s = np * ps, rows = (size_t)B * Hq;
  const Args a{table, pos, scratch, scratch + rows * s, scratch + rows * (s + 2 * np),
               Hq, Hkv, n_rows, TW, ps, scale, softcap, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZT_ARGS q, k_new, v_new, k_pool, v_pool, out, B, D, a, st
  if (q_dtype == 0 && p_dtype == 0) return launch<float, float>(ZT_ARGS);
  if (q_dtype == 0 && p_dtype == 1) return launch<float, __nv_bfloat16>(ZT_ARGS);
  if (q_dtype == 1 && p_dtype == 0) return launch<__nv_bfloat16, float>(ZT_ARGS);
  if (q_dtype == 1 && p_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(ZT_ARGS);
#undef ZT_ARGS
  return (int)cudaErrorInvalidValue;
}
