// K7: blockwise GQA attention over a contiguous cache, bf16 K/V or the q8
// KV cache's int8 codes with one f32 scale per [D] vector.
//
// Replaces zllm/ops/attention.py::_attnb_kernel (launched by
// flash_attention_blockwise): queries q[B, T, Hq, D] at consecutive
// positions pos0[b] + t attend k/v[B, Hkv, S, D] over slots <= pos (and >
// pos - window), any S >= 1, with optional logit softcap and per-head sink
// logits in the softmax max and denominator.  With int8 K/V a slot's K scale
// multiplies its score and its V scale its probability; scores and
// probabilities are f32, and unlike K6/K10 the probabilities are never
// rounded to V's dtype.
//
// Bound on the H100: the bytes of the visible slots' codes and scales plus
// q/out over 3.35 TB/s (the serve decode step: 8 query rows a kv head, a
// few FLOPs a byte), or 4 * Hq * D FLOPs per visible (query, slot) pair
// over the 989 TFLOP/s tensor-core peak.  The TPU kernel walks a (batch,
// kv head)'s KV blocks one grid step after another with the running (max,
// sum, acc) in VMEM; here two forms, by the number R = T * G of query rows
// a kv head has:
//  * split, R <= 32 (the engine's decode step, R = 8): flash-decoding.
//    Launch 1, grid (ceil(S / 128), Hkv, B), a block per 128 slots of one
//    (slot row, kv head): a thread per slot reads its K row in 16-byte loads
//    (16 int8 codes a load) and dots it with the R query rows in shared
//    memory; the block forms each row's max, sum of exp and unnormalized
//    P.V (V staged through shared memory 64 slots at a time) and writes
//    them to scratch.  Blocks outside every row's causal/window band return
//    at once, so a row reads only the slots it sees, in parallel.  Launch
//    2, grid (R, Hkv, B), D threads: each row's splits combined at their
//    common max, the sink added, the sum divided.  Since the probabilities
//    are not rounded, the split is exact up to f32 reassociation.
//  * multi-row, R > 32 (a mixed prefill step, R = 1024; its own entry,
//    zt_attn_blockwise_mma): the one-pass tensor-core loop of attn_mma.cuh
//    (shared with K10) behind a contiguous addressor, in chunks of 128
//    slots: an f32 q split into three bf16 parts, int8 codes converted to
//    bf16 in shared memory (exact), K's scale on the f32 score, the
//    unrounded probability times V's scale split into three bf16 parts for
//    three P.V products, the sinks joined at the end.

#include "attn_mma.cuh"
#include "attn_tile.cuh"

namespace {

using zt_attn::from_f;
using zt_attn::to_f;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int SPL = kThreads;  // slots a split block takes: one a thread
constexpr int VT = 64;         // V rows a P.V sub-tile stages through shared memory
constexpr int MAXR = 32;       // query rows of a kv head the split form takes
constexpr unsigned kFull = 0xffffffffu;

// contiguous K/V [B, Hkv, S, D] for the multi-row loop; with kScaled the
// int8 codes' f32 scales [B, Hkv, S]
template <typename T, bool kScaled>
struct BlockKV {
  const T* k;
  const T* v;
  const float* ks;
  const float* vs;
  int Hkv, S, D;
  static constexpr bool kScales = kScaled;
  __device__ __forceinline__ size_t row(int b, int h, int s0) const {
    return ((size_t)b * Hkv + h) * S + s0;
  }
  __device__ __forceinline__ const T* k_rows(int b, int h, int s0) const { return k + row(b, h, s0) * D; }
  __device__ __forceinline__ const T* v_rows(int b, int h, int s0) const { return v + row(b, h, s0) * D; }
  __device__ __forceinline__ const float* k_scales(int b, int h, int s0) const { return ks + row(b, h, s0); }
  __device__ __forceinline__ const float* v_scales(int b, int h, int s0) const { return vs + row(b, h, s0); }
};

struct Args {
  const int* pos0;
  const float* ks;     // null: bf16 K/V
  const float* vs;
  const float* sinks;  // may be null
  float* part;         // [B, Hkv, NS, R, D + 2]: a split's max, sum of exp, P.V
  int T, Hq, Hkv, S, NS;
  float scale, softcap;
  int window;
};

// the slots some query row of (b, kv head) sees: [lo, hi]
struct Band {
  int lo, hi;
  __device__ Band(int p0, int T, int S, int window) {
    const int qp_max = p0 + T - 1;
    hi = qp_max < S - 1 ? qp_max : S - 1;
    lo = window > 0 ? p0 - window + 1 : 0;
    lo = lo < 0 ? 0 : lo;
  }
};

template <int D, int RM>
constexpr size_t split_smem() {
  return sizeof(float) * ((size_t)RM * D + (size_t)RM * SPL + (size_t)VT * D + 2 * RM);
}

// launch 1: grid (NS, Hkv, B); RM >= R query rows of a kv head
template <typename TQ, typename TKV, int D, int RM>
__global__ void __launch_bounds__(kThreads) k7_split(const TQ* __restrict__ q,
                                                     const TKV* __restrict__ k,
                                                     const TKV* __restrict__ v, const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* qsh = smem;              // [RM][D]
  float* psh = qsh + RM * D;      // [RM][SPL]: scores, then probabilities
  float* vsh = psh + RM * SPL;    // [VT][D]
  float* mrow = vsh + VT * D;     // [RM]
  float* lrow = mrow + RM;        // [RM]
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int G = a.Hq / a.Hkv, R = a.T * G;
  const int p0 = a.pos0[b];
  const Band band(p0, a.T, a.S, a.window);
  const int s_begin = j * SPL;
  if (s_begin > band.hi || s_begin + SPL - 1 < band.lo) return;  // never read by launch 2
  const size_t bh = (size_t)b * a.Hkv + h;

  for (int e = tid; e < RM * D; e += kThreads) {
    const int r = e / D, dd = e % D;
    float x = 0.f;
    if (r < R) x = to_f(q[(((size_t)b * a.T + r / G) * a.Hq + h * G + r % G) * D + dd]);
    qsh[e] = x;
  }
  __syncthreads();

  // scores: a thread per slot, its K row in 16-byte loads
  {
    const int s = s_begin + tid;
    const bool seen = s >= band.lo && s <= band.hi;
    float acc[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) acc[r] = 0.f;
    if (seen) {
      constexpr int kVec = 16 / sizeof(TKV);
      const uint4* row = reinterpret_cast<const uint4*>(k + (bh * a.S + s) * D);
#pragma unroll 2
      for (int c = 0; c < D / kVec; ++c) {
        const uint4 raw = __ldg(row + c);
        const TKV* x = reinterpret_cast<const TKV*>(&raw);
        float xf[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i) xf[i] = to_f(x[i]);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          if (r >= R) break;
          const float* qr = qsh + r * D + c * kVec;
          float t = acc[r];
#pragma unroll
          for (int i = 0; i < kVec; ++i) t += qr[i] * xf[i];
          acc[r] = t;
        }
      }
    }
    const float kscale = (seen && a.ks != nullptr) ? a.ks[bh * a.S + s] : 1.f;
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r >= R) break;
      const int qp = p0 + r / G;
      const bool ok = seen && s <= qp && (a.window <= 0 || s > qp - a.window);
      float sc = acc[r] * a.scale;
      if (a.ks != nullptr) sc *= kscale;
      if (a.softcap > 0.f) sc = tanhf(sc / a.softcap) * a.softcap;
      psh[r * SPL + tid] = ok ? sc : -INFINITY;
    }
  }
  __syncthreads();

  // each row's max and sum of exp over the split (a warp a row), then the
  // probabilities times the V scales in place
  const int lane = tid & 31, warp = tid >> 5;
  for (int r = warp; r < R; r += kWarps) {
    float* pr = psh + r * SPL;
    float m = -INFINITY;
    for (int i = lane; i < SPL; i += 32) m = fmaxf(m, pr[i]);
    for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    float l = 0.f;
    for (int i = lane; i < SPL; i += 32) {
      float p = 0.f;
      if (pr[i] > -INFINITY) {
        p = expf(pr[i] - m);
        l += p;
        if (a.vs != nullptr) p *= a.vs[bh * a.S + s_begin + i];
      }
      pr[i] = p;
    }
    for (int o = 16; o; o >>= 1) l += __shfl_xor_sync(kFull, l, o);
    if (lane == 0) {
      mrow[r] = m;
      lrow[r] = l;
    }
  }

  // P.V: each thread (row, dim) outputs tid + 128 k
  constexpr int kOut = RM * D / kThreads;
  float acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.f;
  for (int t0 = s_begin; t0 < s_begin + SPL; t0 += VT) {
    if (t0 > band.hi || t0 + VT - 1 < band.lo) continue;  // uniform over the block
    __syncthreads();  // the probabilities are in place / vsh is free
    constexpr int kVec = 16 / sizeof(TKV);
    const TKV* vt = v + (bh * a.S + t0) * D;
    for (int e = tid; e < VT * D / kVec; e += kThreads) {
      const int i = e * kVec / D;
      float* dst = vsh + e * kVec;
      if (t0 + i < a.S) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(vt) + e);
        const TKV* x = reinterpret_cast<const TKV*>(&raw);
#pragma unroll
        for (int c = 0; c < kVec; ++c) dst[c] = to_f(x[c]);
      } else {
#pragma unroll
        for (int c = 0; c < kVec; ++c) dst[c] = 0.f;
      }
    }
    __syncthreads();
    const float* pt = psh + (t0 - s_begin);
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      const int e = tid + o * kThreads, r = e / D, d = e % D;
      if (r < R) {
        float x = acc[o];
#pragma unroll 8
        for (int i = 0; i < VT; ++i) x += pt[r * SPL + i] * vsh[i * D + d];
        acc[o] = x;
      }
    }
  }
  __syncthreads();  // mrow/lrow of every warp
  float* part = a.part + ((bh * a.NS + j) * R) * (D + 2);
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    const int e = tid + o * kThreads, r = e / D, d = e % D;
    if (r < R) part[(size_t)r * (D + 2) + 2 + d] = acc[o];
  }
  if (tid < R) {
    part[(size_t)tid * (D + 2)] = mrow[tid];
    part[(size_t)tid * (D + 2) + 1] = lrow[tid];
  }
}

// launch 2: grid (R, Hkv, B), D threads
template <typename TQ, int D>
__global__ void __launch_bounds__(D) k7_combine(TQ* __restrict__ out, const Args a) {
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int G = a.Hq / a.Hkv, R = a.T * G;
  const Band band(a.pos0[b], a.T, a.S, a.window);
  const float* part = a.part + (((size_t)b * a.Hkv + h) * a.NS * R + r) * (D + 2);
  const size_t stride = (size_t)R * (D + 2);  // from one split to the next
  const int j0 = band.lo / SPL, j1 = band.hi / SPL;
  float m = -INFINITY;
  for (int jj = j0; jj <= j1; ++jj) m = fmaxf(m, part[jj * stride]);
  float l = 0.f, o = 0.f;
  for (int jj = j0; jj <= j1; ++jj) {
    const float mj = part[jj * stride];
    if (mj == -INFINITY) continue;  // no slot of this split is the row's
    const float w = expf(mj - m);
    l += part[jj * stride + 1] * w;
    o += part[jj * stride + 2 + d] * w;
  }
  if (a.sinks != nullptr) {
    const float sk = a.sinks[h * G + r % G];
    const float mf = fmaxf(m, sk);
    const float w = expf(m - mf);
    o *= w;
    l = l * w + expf(sk - mf);
  }
  out[(((size_t)b * a.T + r / G) * a.Hq + h * G + r % G) * D + d] = from_f<TQ>(l > 0.f ? o / l : 0.f);
}

template <typename TQ, typename TKV, int D, int RM>
int launch_split(const void* q, const void* k, const void* v, void* out, int B, const Args& a,
                 cudaStream_t stream) {
  constexpr size_t shmem = split_smem<D, RM>();
  auto kern = k7_split<TQ, TKV, D, RM>;
  static bool attr_set = false;  // once per instantiation, not inside graph captures
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int R = a.T * (a.Hq / a.Hkv);
  kern<<<dim3(a.NS, a.Hkv, B), kThreads, shmem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), a);
  k7_combine<TQ, D><<<dim3(R, a.Hkv, B), D, 0, stream>>>(static_cast<TQ*>(out), a);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B, const Args& a,
             cudaStream_t stream) {
  const int R = a.T * (a.Hq / a.Hkv);
  if (R <= 8) return launch_split<TQ, TKV, D, 8>(q, k, v, out, B, a, stream);
  return launch_split<TQ, TKV, D, MAXR>(q, k, v, out, B, a, stream);
}

template <typename TQ, typename TKV>
int launch(int D, const void* q, const void* k, const void* v, void* out, int B, const Args& a,
           cudaStream_t stream) {
  if (D == 64) return launch_d<TQ, TKV, 64>(q, k, v, out, B, a, stream);
  if (D == 128) return launch_d<TQ, TKV, 128>(q, k, v, out, B, a, stream);
  return (int)cudaErrorInvalidValue;
}

constexpr int kChunk = 128;  // slots a chunk of the multi-row loop

// int8 codes come with their scales (the entry checks), bf16 K/V without
template <typename TQ, typename TKV, int D>
int launch_mma_d(const void* k, const void* v, const float* ks, const float* vs,
                 const zt_mma::Params& p, cudaStream_t stream) {
  constexpr bool kScaled = sizeof(TKV) == 1;
  const BlockKV<TKV, kScaled> kv{static_cast<const TKV*>(k), static_cast<const TKV*>(v), ks, vs,
                                 p.Hkv, p.S, D};
  return zt_mma::launch_mma<TQ, TKV, D, kChunk, false>(kv, p, stream);
}

template <typename TQ, typename TKV>
int launch_mma(int D, const void* k, const void* v, const float* ks, const float* vs,
               const zt_mma::Params& p, cudaStream_t stream) {
  if (D == 64) return launch_mma_d<TQ, TKV, 64>(k, v, ks, vs, p, stream);
  if (D == 128) return launch_mma_d<TQ, TKV, 128>(k, v, ks, vs, p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The multi-row form (attn_mma.cuh), for R = T * Hq / Hkv > 32 query rows a
// kv head (it takes any R); dtype codes and shapes as zt_attn_blockwise,
// no scratch.
extern "C" int zt_attn_blockwise_mma(const void* q, int q_dtype, const void* k, const void* v,
                                     int kv_dtype, const float* ks, const float* vs,
                                     const int* pos0, const float* sinks, void* out, int B,
                                     int T, int Hq, int Hkv, int S, int D, float scale,
                                     float softcap, int window, void* stream) {
  if (Hq % Hkv != 0 || T <= 0 || S <= 0 || (kv_dtype == 2) != (ks != nullptr && vs != nullptr))
    return (int)cudaErrorInvalidValue;
  const zt_mma::Params p{q, out, pos0, sinks, B, T, Hq, Hkv, S, kChunk, scale, softcap, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZT_ARGS D, k, v, ks, vs, p, st
  if (q_dtype == 0 && kv_dtype == 1) return launch_mma<float, __nv_bfloat16>(ZT_ARGS);
  if (q_dtype == 0 && kv_dtype == 2) return launch_mma<float, int8_t>(ZT_ARGS);
  if (q_dtype == 1 && kv_dtype == 1) return launch_mma<__nv_bfloat16, __nv_bfloat16>(ZT_ARGS);
  if (q_dtype == 1 && kv_dtype == 2) return launch_mma<__nv_bfloat16, int8_t>(ZT_ARGS);
#undef ZT_ARGS
  return (int)cudaErrorInvalidValue;
}

// The split form, R = T * Hq / Hkv <= 32 query rows a kv head.  dtype
// codes: q 0 = float32, 1 = bfloat16; k/v 1 = bfloat16, 2 = int8 (then
// ks/vs are its f32 scales [B, Hkv, S], else null).  pos0 int32 [B]; sinks
// f32 [Hq] or null; out like q; scratch f32 [B * Hkv * ceil(S / 128) * R *
// (D + 2)].
extern "C" int zt_attn_blockwise(const void* q, int q_dtype, const void* k, const void* v,
                                 int kv_dtype, const float* ks, const float* vs, const int* pos0,
                                 const float* sinks, void* out, float* scratch, int B, int T,
                                 int Hq, int Hkv, int S, int D, float scale, float softcap,
                                 int window, void* stream) {
  if (Hq % Hkv != 0 || T <= 0 || S <= 0 || (kv_dtype == 2) != (ks != nullptr && vs != nullptr))
    return (int)cudaErrorInvalidValue;
  if (T * (Hq / Hkv) > MAXR || scratch == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{pos0, ks, vs, sinks, scratch, T, Hq, Hkv, S, (S + SPL - 1) / SPL,
               scale, softcap, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZT_ARGS D, q, k, v, out, B, a, st
  if (q_dtype == 0 && kv_dtype == 1) return launch<float, __nv_bfloat16>(ZT_ARGS);
  if (q_dtype == 0 && kv_dtype == 2) return launch<float, int8_t>(ZT_ARGS);
  if (q_dtype == 1 && kv_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(ZT_ARGS);
  if (q_dtype == 1 && kv_dtype == 2) return launch<__nv_bfloat16, int8_t>(ZT_ARGS);
#undef ZT_ARGS
  return (int)cudaErrorInvalidValue;
}
