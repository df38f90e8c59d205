// K2: the whole decode (T = 1) attention block of one layer.
//
// Replaces zllm/ops/attention.py::_attn_decode_qkv_kernel (launched by
// attn_decode_qkv): split the fused [B, Hq+2Hkv, D] projection row into
// q / new k / new v, optional per-head RMS norms of q and k, rope (here a
// per-row cos/sin table; it computes what the Pallas kernel's [D, D]
// rotation matmul computes), write the new K/V row into the cache in place
// at row pw = min(pos, S-1), then GQA attention over slots <= pos (and
// > pos - window) with optional logit softcap and, in the sinks form,
// per-head sink logits s_h (gpt-oss's): s_h joins the row's softmax as a
// logit of its own that attends to nothing, the row max max(m, s_h) and
// the denominator plus exp(s_h - max), as zllm's attention_ref takes it
// (zllm runs no kernel there).  The sinks form is the same kernel: each
// chunk's max takes s_h, and the row's denominator gains its term once,
// so a sink above every score, or a span with no visible slot, still
// counts; with no sinks every value keeps its bits.
//
// Rounding points kept from the Pallas kernel: the roped q and the new
// K/V rows are cast to the cache dtype (rope's products and sums rounded
// separately, so the k row has apply_rope's bits); scores are f32; p =
// exp(s - M) / l (IEEE division) is cast to the cache dtype before P.V,
// with M and l over the row's whole visible span; P.V accumulates in f32.
//
// Bound on the H100: the cache bytes it must read, 2 * Hkv * (pos+1) * D *
// sizeof(cache) per row, over 3.35 TB/s (a TinyLlama layer at pos 331:
// 85 KB, 0.03 us); the work is a few FLOPs a byte.  So what paces it is
// latency: the earlier form (a block a query head, three sweeps over a
// global f32 scratch row, eight block barriers, no programmatic launch)
// took 9.9 us a launch (python -m zllm_torch.k1_ablation --kernel k2,
// PERF.md §6).
//
// Design.  Grid (splits, Hkv * ceil(G / 8), B): a block serves one (row b,
// kv head h, group of up to 8 query heads of its GQA group) and one chunk
// of the row's visible span [lo, hi]: the span is cut from lo into chunks
// of CH slots (512 for a bf16 cache at D 64; 64 KB of K a chunk), so the
// split reads only the row's position, the window and S -- never B or
// another row -- and a row's bits are the same alone and in any batch.
//   * Loads: each block stages its chunk's K and V rows in shared memory by
//     16-byte cp.async, issued at its start; every K/V byte is read once a
//     query group.  q and the new rows come from the projection row.
//   * Programmatic dependent launch: the launch sets programmatic stream
//     serialization, and a block calls launch_dependents at its start, so
//     the K1 after it (wo) has its weights in flight while K2 runs.  Before
//     griddepcontrol.wait a block reads only its row's position and the
//     cache slots s != pw of its own row and layer, which nothing but this
//     launch writes within a step: so the staged chunk is in flight while
//     the K1 before it (wqkv) drains.  After the wait: the projection row,
//     the norms, rope, the insert, the dots and every store.
//   * Scores: a bf16 or f16 cache on the tensor cores, mma.sync m16n8k16
//     (bf16 x bf16 or f16 x f16, the same rate) with the chunk's slots as M
//     (a warp a tile of 16), the (up to) 8 query rows as N and D as K: q,
//     rounded to the cache dtype as zllm rounds it, is one exact part (an
//     f16 q overflows where zllm's does); an f32 cache on the CUDA cores, a
//     thread a slot.  Kept in shared memory.
//   * Each chunk's per-row max m (the warps' maxima, taken with the scores)
//     and sum l of e = exp(s - m) (each thread one row's share, then the
//     warps' sums in warp order); the row's M = max m_j and l = sum_j l_j
//     exp(m_j - M) in chunk order (one chunk: m and l, and e stays in
//     place of the scores); p = e / l is rounded as P.V's fragments are
//     built.
//   * P.V: p written over the scores, then (P.V)^T = V^T P^T on the tensor
//     cores (D as M, the rows as N, 16 slots as K; p one exact part of the
//     cache dtype, f16 subnormals kept) or on the CUDA cores (f32), summed
//     per warp in chunk order, then over the warps in order.
//   * A span of more than one chunk (the engine's trash row at S 2176, a
//     long context): every block writes its chunk's scores and statistics
//     to a global scratch, then takes a ticket on the (row, head, group)'s
//     counter; the last block to arrive resets the counter, reads every
//     chunk's statistics, and runs P.V over every chunk in chunk order
//     (its own from shared memory, the others' V and scores reloaded), so
//     the output does not depend on which block is last.  A span of one
//     chunk (a live row at pos < 512) touches no scratch and no counter.
//
// Head dims 64, 128 and 256 (Gemma's).  At D 256 a chunk is 128 slots of a
// bf16 or f16 cache (64 of an f32 one), 165 KB of shared memory (159 KB
// f32); q's B fragments (32 registers) live only through the scores and
// the P.V accumulators (64) only through phase 2, under the 128 a thread
// of a 512-thread block.
//
// Where trouble lies:
//   * The insert in one launch: only the (chunk 0, query group 0) block
//     writes the cache row pw; no block reads it from the cache -- the
//     block whose chunk holds pw puts k_new / v_new (rounded) in its staged
//     rows instead, and the last block does the same for reloaded chunks.
//   * Nothing before the wait but the position and the cache slots != pw:
//     the projection row is the previous kernel's output (K1's y, or a
//     torch op's), and out comes from the caching allocator.  The position
//     is written by the host or a torch op before the step, never by a
//     kernel that triggers early.
//   * The counters are zero between launches (the last block resets its
//     own); they and the scratch are touched only after the wait, so two
//     K2 launches in a row never share them at once.
//   * hi = min(pos, S - 1) passes through an opaque register, as in
//     decode_cluster.cuh (the card gave wrong scores there without one).
//   * Dynamic shared memory above 48 KB needs cudaFuncSetAttribute once an
//     instantiation, outside graph capture (the wrapper's first call).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "matvec_common.cuh"
#include "mma_ptx.cuh"

namespace {

using zt::cp_async16;
using zt::cp_async_commit;
using zt::cp_async_wait_all;
using zt::grid_wait;
using zt::launch_dependents;
using zt::ldmatrix_x4;
using zt::ldmatrix_x4_trans;
using zt::Tc;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int RM = 8;  // query rows a block
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -INFINITY;
constexpr int kMaxSmem = 232448;  // an H100 block's shared memory

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }
// v rounded to the cache dtype, as f32
template <typename TC> __device__ __forceinline__ float round_c(float v) {
  return to_f(from_f<TC>(v));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// slots a chunk: 64 KB of K rows
template <typename TC, int D>
constexpr int kChunk = 65536 / (D * (int)sizeof(TC));

// a staged K/V row: padded by 16 bytes (no bank conflicts in the fragment reads)
template <typename TC, int D>
constexpr int kRowBytes = D * (int)sizeof(TC) + 16;

struct Params {
  const void* qkv3;     // [B, Hq + 2 Hkv, D]
  void* kc;             // [B, Hkv, S, D]
  void* vc;
  const int* pos;       // [B]
  const float* cosb;    // [B, R/2]
  const float* sinb;
  const float* qw;      // [D] or null (no q/k norm)
  const float* kw;
  const float* sinks;   // [Hq] or null: the sinks form (a logit of its own a head)
  void* out;            // [B, Hq, D] in qkv3's dtype
  float* gsc;           // [B, Y, RM, S] scores of multi-chunk rows
  float2* gst;          // [B, Y, splits, RM] their chunks' (max, sum of exp)
  int* counters;        // [B, Y], zero between launches
  int Hq, Hkv, S, R, neox, splits, window;
  float scale, softcap, eps;
};

// shared memory of one launch, in bytes (the kernel's carve-up, in order)
template <typename TC, int D>
constexpr size_t smem_bytes() {
  return (size_t)2 * kChunk<TC, D> * kRowBytes<TC, D>        // K, V of the own chunk
         + sizeof(float) * 2 * (size_t)kChunk<TC, D> * RM   // scores: own, reloaded
         + sizeof(float) * (size_t)(RM + 2) * D             // q (roped, rounded), k_new, v_new
         + sizeof(float) * (size_t)(RM + 2) * D             // the raw rows
         + sizeof(float) * 4 * RM                           // chunk m, l; row M, l
         + sizeof(float) * 2 * (size_t)kWarps * RM;         // the warps' maxima, sums
}

template <typename TQ, typename TC, int D>
__global__ void __launch_bounds__(kThreads) attn_decode_qkv_kernel(const Params p) {
  constexpr int CH = kChunk<TC, D>, RS = kRowBytes<TC, D>;
  constexpr int VPR = D * (int)sizeof(TC) / 16;  // 16-byte pieces a row
  constexpr bool kMma = sizeof(TC) == 2;
  constexpr int KS = D / 16, MT = D / 16, DPL = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kb = smem;                                   // [CH][RS]
  unsigned char* vb = kb + (size_t)CH * RS;                   // [CH][RS]
  float* sc = reinterpret_cast<float*>(vb + (size_t)CH * RS);  // [CH][RM]
  float* sc2 = sc + CH * RM;                                  // [CH][RM]
  float* qs = sc2 + CH * RM;                                  // [RM][D], then k_new, v_new
  float* knew = qs + RM * D;
  float* vnew = knew + D;
  float* raw = vnew + D;                                      // [RM + 2][D]
  float* cm = raw + (RM + 2) * D;                             // [RM] own chunk's max
  float* cl = cm + RM;                                        // [RM] its sum of exp
  float* row_m = cl + RM;
  float* row_l = row_m + RM;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.Hq / p.Hkv, GC = (G + RM - 1) / RM;
  const int j = blockIdx.x, y = blockIdx.y, h = y / GC, c = y % GC, b = blockIdx.z;
  const int r0 = c * RM, nr = min(RM, G - r0);
  const int S = p.S, pos = p.pos[b];
  const int pw = min(pos, S - 1);
  int hi = min(pos, S - 1);
  asm volatile("" : "+r"(hi));
  const int lo = p.window > 0 ? max(pos - p.window + 1, 0) : 0;
  const int nsp = hi >= lo ? (hi - lo) / CH + 1 : 1;  // chunks of the span (an empty span: one)
  launch_dependents();
  if (j >= nsp) return;
  const int c0 = lo + j * CH, n_c = max(0, min(CH, hi + 1 - c0));
  const size_t head = ((size_t)b * p.Hkv + h) * S;  // the (row, head)'s first cache row
  const TC* kc = static_cast<const TC*>(p.kc) + head * D;
  const TC* vc = static_cast<const TC*>(p.vc) + head * D;

  // rows [a0, a0 + n) of the cache into a staged buffer, slot pw left out
  auto stage = [&](unsigned char* dst, const TC* src, int a0, int n) {
    for (int e = tid; e < n * VPR; e += kThreads) {
      const int rr = e / VPR, v16 = e % VPR;
      if (a0 + rr != pw)
        cp_async16(dst + rr * RS + v16 * 16,
                   reinterpret_cast<const unsigned char*>(src + (size_t)(a0 + rr) * D) + v16 * 16,
                   16);
    }
  };
  // rows [n, the next multiple of 16) of a staged buffer to zero: the P.V
  // fragments read whole 16-slot tiles, and 0 * a stale NaN is NaN
  auto zero_tail = [&](unsigned char* dst, int n) {
    const int n16 = (n + 15) / 16 * 16;
    for (int e = tid; e < (n16 - n) * (RS / 4); e += kThreads)
      reinterpret_cast<uint32_t*>(dst + (size_t)n * RS)[e] = 0u;
  };
  // before the wait: the own chunk's K and V rows
  stage(kb, kc, c0, n_c);
  stage(vb, vc, c0, n_c);
  cp_async_commit();
  grid_wait();

  // ---- split, norms, rope, the insert
  // the projection row and the rope table are loaded together, one trip:
  // element e = tid + k * kThreads of [q rows | k_new | v_new]
  constexpr int NE = (RM + 2) * D, KE = (NE + kThreads - 1) / kThreads;
  const TQ* row = static_cast<const TQ*>(p.qkv3) + (size_t)b * (p.Hq + 2 * p.Hkv) * D;
  const float* cosr = p.cosb + (size_t)b * (p.R / 2);
  const float* sinr = p.sinb + (size_t)b * (p.R / 2);
  const int hr = p.R / 2;
  float cv[KE], sv[KE];
#pragma unroll
  for (int k = 0; k < KE; ++k) {
    const int e = tid + k * kThreads, i = e / D, d = e % D;
    if (e < NE) {
      float v = 0.f;
      if (i < nr) v = to_f(row[(size_t)(h * G + r0 + i) * D + d]);
      if (i == RM) v = to_f(row[(size_t)(p.Hq + h) * D + d]);
      if (i == RM + 1) v = to_f(row[(size_t)(p.Hq + p.Hkv + h) * D + d]);
      raw[e] = v;
      if (i <= RM && d < p.R) {
        const int jj = p.neox ? (d < hr ? d : d - hr) : (d >> 1);
        cv[k] = cosr[jj];
        sv[k] = sinr[jj];
      }
    }
  }
  __syncthreads();
  if (p.qw != nullptr) {  // per-head RMS before rope: (x * rsqrt(ms)) * w, a warp a head
    for (int i = warp; i <= RM; i += kWarps) {
      if (i < nr || i == RM) {
        float* x = raw + i * D;
        float s = 0.f;
        for (int d = lane; d < D; d += 32) s += x[d] * x[d];
        const float rs = rsqrtf(warp_sum(s) / (float)D + p.eps);
        const float* w = i == RM ? p.kw : p.qw;
        for (int d = lane; d < D; d += 32) x[d] = x[d] * rs * w[d];
      }
    }
    __syncthreads();
  }
  // rope (products and the sum rounded separately, no FMA contraction, as
  // the reference's x1*cos - x2*sin is), then the cache dtype; the new k and
  // v rows also go to the cache (one block of the (row, head)) and to the
  // staged row of slot pw (the block whose chunk holds it)
  TC* kw_ = static_cast<TC*>(p.kc) + (head + pw) * D;
  TC* vw_ = static_cast<TC*>(p.vc) + (head + pw) * D;
  const bool own_pw = pw >= c0 && pw < c0 + n_c;
#pragma unroll
  for (int k = 0; k < KE; ++k) {
    const int e = tid + k * kThreads, i = e / D, d = e % D;
    if (e < NE) {
      const float* x = raw + i * D;
      float o = x[d];
      if (i <= RM && d < p.R) {
        const bool first = p.neox ? d < hr : (d & 1) == 0;
        const int partner = p.neox ? (first ? d + hr : d - hr) : (first ? d + 1 : d - 1);
        const float a = __fmul_rn(x[d], cv[k]);
        const float bb = __fmul_rn(x[partner], sv[k]);
        o = first ? __fsub_rn(a, bb) : __fadd_rn(a, bb);
      }
      const TC oc = from_f<TC>(o);
      qs[e] = to_f(oc);  // qs, knew, vnew are one array
      if (i >= RM) {
        if (j == 0 && c == 0) (i == RM ? kw_ : vw_)[d] = oc;
        if (own_pw) reinterpret_cast<TC*>((i == RM ? kb : vb) + (pw - c0) * RS)[d] = oc;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- scores of the own chunk, and each warp's max of them a row
  float* wmax = row_l + RM;          // [kWarps][RM]
  float* wsum = wmax + kWarps * RM;  // [kWarps][RM]
  if constexpr (kMma) {
    uint32_t qb[KS][2];  // q as mma B fragments: row lane / 4, one exact part of TC
    const float* qn = qs + (lane / 4) * D + (lane % 4) * 2;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) qb[ks][hf] = Tc<TC>::pack(qn[ks * 16 + hf * 8],
                                                              qn[ks * 16 + hf * 8 + 1]);
    float mx[2] = {kNeg, kNeg};  // rows (lane % 4) * 2 and + 1
    for (int t = warp; t < (n_c + 15) / 16; t += kWarps) {
      const int sl = 16 * t + lane / 4;  // this lane's slots: sl and sl + 8
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      // the A fragments by ldmatrix: lane l gives row 16 t + l % 8 (+8 for
      // matrices 1, 3) at column 16 ks (+8 for matrices 2, 3)
      const unsigned char* ka =
          kb + (16 * t + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + (lane >> 4) * 16;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, ka + ks * 32);
        Tc<TC>::mma(acc, a, qb[ks]);
      }
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const int slot = sl + (e4 >> 1) * 8, r = (lane % 4) * 2 + (e4 & 1);
        float x = acc[e4] * p.scale;
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        x = slot < n_c && r < nr ? x : kNeg;
        sc[slot * RM + r] = x;
        mx[e4 & 1] = fmaxf(mx[e4 & 1], x);
      }
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      mx[0] = fmaxf(mx[0], __shfl_xor_sync(kFull, mx[0], o));
      mx[1] = fmaxf(mx[1], __shfl_xor_sync(kFull, mx[1], o));
    }
    if (lane < 4) {
      wmax[warp * RM + lane * 2] = mx[0];
      wmax[warp * RM + lane * 2 + 1] = mx[1];
    }
  } else {  // f32 cache: a thread a slot (CH <= kThreads)
    const int slot = tid;
    float acc[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) acc[r] = 0.f;
    if (slot < n_c) {
      const float4* kr = reinterpret_cast<const float4*>(kb + slot * RS);
#pragma unroll 4
      for (int c4 = 0; c4 < D / 4; ++c4) {
        const float4 k4 = kr[c4];
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float4 q4 = reinterpret_cast<const float4*>(qs + r * D)[c4];
          float a = acc[r];
          a += q4.x * k4.x;
          a += q4.y * k4.y;
          a += q4.z * k4.z;
          a += q4.w * k4.w;
          acc[r] = a;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      float x = acc[r] * p.scale;
      if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
      x = slot < n_c && r < nr ? x : kNeg;
      if (slot < CH) sc[slot * RM + r] = x;
      x = warp_max(x);
      if (lane == 0) wmax[warp * RM + r] = x;
    }
  }
  __syncthreads();

  // ---- the own chunk's statistics: its max m a row (the warps' maxima),
  // e = exp(s - m) and their sum l; a thread keeps one row, r = tid % RM
  {
    const int r = tid % RM;
    float m = kNeg;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wmax[w * RM + r]);
    // the sinks form: every chunk's max takes the row's sink logit, so the
    // row's max M is max(m, s_h) and e = exp(s - M) stays below 1
    if (p.sinks != nullptr && r < nr) m = fmaxf(m, p.sinks[h * G + r0 + r]);
    float l = 0.f;
    for (int e = tid; e < n_c * RM; e += kThreads) {
      const float x = sc[e];
      const float ev = x > kNeg ? expf(x - m) : 0.f;
      l += ev;
      if (nsp == 1) sc[e] = ev;  // one chunk: m is the row's max
    }
    if constexpr (kMma) zero_tail(vb, n_c);
    l += __shfl_xor_sync(kFull, l, 8);
    l += __shfl_xor_sync(kFull, l, 16);
    if (lane < RM) wsum[warp * RM + lane] = l;
    if (warp == 0 && lane < RM) cm[lane] = m;
  }
  __syncthreads();
  // the chunk's sum of exp for row r: the warps' sums in warp order
  auto chunk_l = [&](int r) -> float {
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w) l += wsum[w * RM + r];
    return l;
  };
  const size_t gy = (size_t)b * gridDim.y + y;  // this (row, head, group)
  if (nsp > 1) {  // publish the chunk's scores, then the last block of the row goes on
    if (tid < RM) cl[tid] = chunk_l(tid);
    __syncthreads();
    float* g = p.gsc + gy * RM * S;
    for (int e = tid; e < n_c * RM; e += kThreads) {
      const int r = e / n_c, s2 = e % n_c;
      g[(size_t)r * S + c0 + s2] = sc[s2 * RM + r];
    }
    if (tid < RM) p.gst[(gy * p.splits + j) * RM + tid] = make_float2(cm[tid], cl[tid]);
    __threadfence();
    __syncthreads();
    __shared__ int last;
    if (tid == 0) {
      last = atomicAdd(p.counters + gy, 1) == nsp - 1;
      if (last) p.counters[gy] = 0;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (tid < RM) {  // the row's max and denominator, in chunk order
      const int r = tid;
      float M = kNeg;
      for (int i = 0; i < nsp; ++i)
        M = fmaxf(M, i == j ? cm[r] : __ldcg(&p.gst[(gy * p.splits + i) * RM + r]).x);
      float l = 0.f;
      for (int i = 0; i < nsp; ++i) {
        const float2 st = i == j ? make_float2(cm[r], cl[r])
                                 : __ldcg(&p.gst[(gy * p.splits + i) * RM + r]);
        if (st.x > kNeg) l += st.y * expf(st.x - M);
      }
      if (p.sinks != nullptr && r < nr) l += expf(p.sinks[h * G + r0 + r] - M);
      row_m[r] = M;
      row_l[r] = l;
    }
    __syncthreads();
  }
  // row r's denominator in row_l: one chunk, its own l (its max is the
  // row's, so the chunk-order sum above would give these bits); more, the
  // combined one.  Read from shared memory where it is used (the f32 form's
  // P.V at D 256 has no registers to spare for a copy)
  if (nsp == 1) {
    if (tid < RM) {
      float l = chunk_l(tid);
      if (p.sinks != nullptr && tid < nr) l += expf(p.sinks[h * G + r0 + tid] - cm[tid]);
      row_l[tid] = l;
    }
    __syncthreads();
  }

  // ---- phase 2: P.V chunk by chunk in order, p = exp(s - M) / l rounded to
  // the cache dtype as the fragments are built (one chunk: e is in place)
  float tacc[kMma ? MT : 1][4];  // tensor cores: (P.V)^T fragments of this warp's slots
  float acc[kMma ? 1 : RM][DPL];  // CUDA cores: a lane D / 32 columns of the rows
#pragma unroll
  for (int mt = 0; mt < (kMma ? MT : 1); ++mt)
#pragma unroll
    for (int e4 = 0; e4 < 4; ++e4) tacc[mt][e4] = 0.f;
#pragma unroll
  for (int r = 0; r < (kMma ? 1 : RM); ++r)
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[r][d] = 0.f;
  auto prob = [&](float ev, float l) -> float {
    return ev > 0.f ? round_c<TC>(__fdiv_rn(ev, l)) : 0.f;
  };
  for (int i = 0; i < nsp; ++i) {
    const int ci = lo + i * CH, ni = max(0, min(CH, hi + 1 - ci));
    float* s_i = sc;
    const unsigned char* v_i = vb;
    if (i != j) {  // another block's chunk: its V rows and scores back into shared memory
      stage(kb, vc, ci, ni);
      cp_async_commit();
      if (pw >= ci && pw < ci + ni) {
        TC* r = reinterpret_cast<TC*>(kb + (pw - ci) * RS);
        for (int d = tid; d < D; d += kThreads) r[d] = from_f<TC>(vnew[d]);
      }
      if constexpr (kMma) zero_tail(kb, ni);
      const float* g = p.gsc + gy * RM * S;
      for (int e = tid; e < ni * RM; e += kThreads) {
        const int r = e / ni, s2 = e % ni;
        sc2[s2 * RM + r] = __ldcg(&g[(size_t)r * S + ci + s2]);
      }
      cp_async_wait_all();
      __syncthreads();
      s_i = sc2;
      v_i = kb;
    }
    if (nsp > 1) {  // e = exp(s - M) in place, M the row's max
      for (int e = tid; e < ni * RM; e += kThreads) {
        const float x = s_i[e];
        s_i[e] = x > kNeg ? expf(x - row_m[e % RM]) : 0.f;
      }
      __syncthreads();
    }
    if constexpr (kMma) {
      const int rq = lane / 4;
      const float lq = row_l[rq];
      for (int t = warp; t < (ni + 15) / 16; t += kWarps) {
        const int s0 = 16 * t + (lane % 4) * 2;  // k pairs s0, s0 + 1 and s0 + 8, s0 + 9
        const bool ok[4] = {s0 < ni, s0 + 1 < ni, s0 + 8 < ni, s0 + 9 < ni};
        uint32_t pb[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          pb[hf] = Tc<TC>::pack(ok[2 * hf] ? prob(s_i[(s0 + 8 * hf) * RM + rq], lq) : 0.f,
                                ok[2 * hf + 1] ? prob(s_i[(s0 + 8 * hf + 1) * RM + rq], lq) : 0.f);
        // (V^T) fragments by ldmatrix.trans: lane l gives V row 16 t + l % 8
        // (+8 for matrices 2, 3) at column 16 mt (+8 for matrices 1, 3)
        const unsigned char* va =
            v_i + (16 * t + (lane & 7) + (lane >> 4) * 8) * RS + ((lane >> 3) & 1) * 16;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t av[4];
          ldmatrix_x4_trans(av, va + mt * 32);
          Tc<TC>::mma(tacc[mt], av, pb);
        }
      }
    } else {  // f32 V
      const volatile float* den = row_l;  // loaded where used, never held (see above)
      for (int t = warp; t < ni; t += kWarps) {
        const float* v = reinterpret_cast<const float*>(v_i + t * RS) + lane * DPL;
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float pr = prob(s_i[t * RM + r], den[r]);
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[r][d] += pr * v[d];
        }
      }
    }
    __syncthreads();  // the buffers are free for the next chunk
  }

  // ---- the warps' partials, summed in warp order, then the output
  float* wp = reinterpret_cast<float*>(kb);  // [kWarps][RM][D]
  if constexpr (kMma) {
    const int rq = (lane % 4) * 2;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int dd = mt * 16 + lane / 4;
      wp[(warp * RM + rq) * D + dd] = tacc[mt][0];
      wp[(warp * RM + rq + 1) * D + dd] = tacc[mt][1];
      wp[(warp * RM + rq) * D + dd + 8] = tacc[mt][2];
      wp[(warp * RM + rq + 1) * D + dd + 8] = tacc[mt][3];
    }
  } else {
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int d = 0; d < DPL; ++d) wp[(warp * RM + r) * D + lane * DPL + d] = acc[r][d];
  }
  __syncthreads();
  TQ* out = static_cast<TQ*>(p.out) + ((size_t)b * p.Hq + h * G + r0) * D;
  for (int e = tid; e < nr * D; e += kThreads) {
    float o = wp[e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) o += wp[w * RM * D + e];
    out[e] = from_f<TQ>(o);
  }
}

template <typename TQ, typename TC, int D>
int launch(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t shmem = smem_bytes<TC, D>();
  static_assert(shmem <= (size_t)kMaxSmem, "K2's shared memory");
  // the warps' P.V partials reuse the staged K and V rows
  static_assert((size_t)kWarps * RM * D * 4 <= (size_t)2 * kChunk<TC, D> * kRowBytes<TC, D>,
                "K2's partials");
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_decode_qkv_kernel<TQ, TC, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, p.Hkv * ((p.Hq / p.Hkv + RM - 1) / RM), B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = shmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, attn_decode_qkv_kernel<TQ, TC, D>, p);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename TQ, typename TC>
int launch_d(const Params& p, int B, int D, cudaStream_t s) {
  if (D == 64) return launch<TQ, TC, 64>(p, B, s);
  if (D == 128) return launch<TQ, TC, 128>(p, B, s);
  if (D == 256) return launch<TQ, TC, 256>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// a cache element's bytes by dtype code (0 = float32, 1 = bfloat16, 3 =
// float16); 0 for a code the kernel does not take
static int cache_bytes(int c_dtype) {
  return c_dtype == 0 ? 4 : (c_dtype == 1 || c_dtype == 3) ? 2 : 0;
}

// slots a chunk for a cache dtype code and head dim (kChunk: 64 KB of K
// rows); 0 for a shape or code the kernel does not take.  The wrapper sizes
// the grid (ceil(S / chunk) splits) and the scratch.
extern "C" int zt_attn_decode_chunk(int c_dtype, int D) {
  if ((D != 64 && D != 128 && D != 256) || cache_bytes(c_dtype) == 0) return 0;
  return 65536 / (D * cache_bytes(c_dtype));
}

// dtype codes: q 0 = float32 or 1 = bfloat16; the caches 0, 1 or 3 =
// float16.  qw/kw may be null (no q/k norm); sinks f32 [Hq] may be null
// (no sinks).
// gsc [B, Hkv * ceil(G / 8), 8, S] f32 and gst [B, Hkv * ceil(G / 8),
// splits, 8] float2 are scratch (touched only by rows of more than one
// chunk); counters [B, Hkv * ceil(G / 8)] int32 must be zero and are left
// zero.
extern "C" int zt_attn_decode_qkv(const void* qkv3, int q_dtype, void* kc, void* vc,
                                  int c_dtype, const int* pos, const float* cosb,
                                  const float* sinb, const float* qw, const float* kw,
                                  const float* sinks, void* out, float* gsc, void* gst,
                                  int* counters, int B,
                                  int Hq, int Hkv, int S, int D, int R, int neox, float scale,
                                  float softcap, int window, float eps, void* stream) {
  const int chunk = zt_attn_decode_chunk(c_dtype, D);
  if (chunk == 0 || R > D || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  Params p{qkv3, kc, vc, pos, cosb, sinb, qw, kw, sinks, out, gsc, static_cast<float2*>(gst),
           counters, Hq, Hkv, S, R, neox, (S + chunk - 1) / chunk, window, scale, softcap, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && c_dtype == 0) return launch_d<float, float>(p, B, D, s);
  if (q_dtype == 0 && c_dtype == 1) return launch_d<float, __nv_bfloat16>(p, B, D, s);
  if (q_dtype == 1 && c_dtype == 0) return launch_d<__nv_bfloat16, float>(p, B, D, s);
  if (q_dtype == 1 && c_dtype == 1) return launch_d<__nv_bfloat16, __nv_bfloat16>(p, B, D, s);
  if (q_dtype == 0 && c_dtype == 3) return launch_d<float, __half>(p, B, D, s);
  if (q_dtype == 1 && c_dtype == 3) return launch_d<__nv_bfloat16, __half>(p, B, D, s);
  return (int)cudaErrorInvalidValue;
}
