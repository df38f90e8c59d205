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
//  * split, R <= 32 (the engine's decode step, R = 8): one thread-block-
//    cluster launch of decode_cluster.cuh behind a contiguous addressor
//    (int8 codes with their scales, or bf16 K/V): the 128-slot chunks of a
//    (slot row, kv head, group of 8 query rows)'s span are dealt to the
//    cluster's 8 blocks, each block's scores stay in its shared memory, the
//    row's max and denominator are read from the peers' chunk statistics
//    over distributed shared memory, and block 0 sums the partials and
//    adds the sinks.  The probabilities stay f32, so the split is exact up
//    to f32 reassociation.  At D 256 (Gemma-1's heads on the q8 cache) the
//    same launch, q's fragments in shared memory as K9's D 256 form keeps
//    them; an int8 chunk of 128 slots is half the bytes of a bf16 one, plus
//    its scales.
//  * multi-row, R > 32 (a mixed prefill step, R = 1024; its own entry,
//    zt_attn_blockwise_mma): the one-pass tensor-core loop of attn_mma.cuh
//    (shared with K10) behind a contiguous addressor, in chunks of 128
//    slots: an f32 q split into three bf16 parts, int8 codes converted to
//    bf16 in shared memory (exact), K's scale on the f32 score, the
//    unrounded probability times V's scale split into three bf16 parts for
//    three P.V products, the sinks joined at the end; at D 256 in chunks of
//    64 slots (see launch_mma).

#include "attn_mma.cuh"
#include "decode_cluster.cuh"

namespace {

constexpr int MAXR = 32;  // query rows of a kv head the split form takes

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

constexpr int kChunk = 128;  // slots a chunk of the multi-row loop

// int8 codes come with their scales (the entry checks), bf16 K/V without
template <typename TQ, typename TKV, int D, int CH>
int launch_mma_d(const void* k, const void* v, const float* ks, const float* vs,
                 const zt_mma::Params& p, cudaStream_t stream) {
  constexpr bool kScaled = sizeof(TKV) == 1;
  const BlockKV<TKV, kScaled> kv{static_cast<const TKV*>(k), static_cast<const TKV*>(v), ks, vs,
                                 p.Hkv, p.S, D};
  return zt_mma::launch_mma<TQ, TKV, D, CH, false>(kv, p, stream);
}

// D 256 (Gemma-1 on the q8 cache) takes chunks of 64 slots: two stages of
// 128 rows of 256 would not fit a block's shared memory beside q's three
// parts and the int8 chunk's bf16 tiles (K10's D 256 form does the same).
// The running max advances a chunk; the probabilities are never rounded,
// so the chunk size moves the result by f32 reassociation only.
template <typename TQ, typename TKV>
int launch_mma(int D, const void* k, const void* v, const float* ks, const float* vs,
               const zt_mma::Params& p, cudaStream_t stream) {
  if (D == 64) return launch_mma_d<TQ, TKV, 64, kChunk>(k, v, ks, vs, p, stream);
  if (D == 128) return launch_mma_d<TQ, TKV, 128, kChunk>(k, v, ks, vs, p, stream);
  if (D == 256) return launch_mma_d<TQ, TKV, 256, 64>(k, v, ks, vs, p, stream);
  return (int)cudaErrorInvalidValue;
}

// the split form's addressor for decode_cluster.cuh: contiguous K/V
// [B, Hkv, S, D], chunk j of (b, h) from slot j * cs; with kScaled the
// int8 codes' f32 scales [B, Hkv, S]
template <typename T, bool kScaled_>
struct ContigKV {
  const T* k;
  const T* v;
  const float* ks;
  const float* vs;
  int Hkv, S;
  static constexpr bool kScaled = kScaled_;
  static constexpr int kRound = zt_dc::kRoundNone;  // f32 probabilities, never rounded
  static constexpr bool kInsert = false;
  __device__ __forceinline__ size_t base(int b, int h, int j, int cs) const {
    return ((size_t)b * Hkv + h) * S + (size_t)j * cs;
  }
};

template <typename TQ, typename TKV>
int launch_split(int D, const void* k, const void* v, const float* ks, const float* vs,
                 const zt_dc::Params& p, int B, cudaStream_t stream) {
  constexpr bool kScaled = sizeof(TKV) == 1;
  const ContigKV<TKV, kScaled> kv{static_cast<const TKV*>(k), static_cast<const TKV*>(v), ks, vs,
                                  p.Hkv, p.S};
  if (D == 64) return zt_dc::launch<TQ, TKV, 64>(p, kv, B, stream);
  if (D == 128) return zt_dc::launch<TQ, TKV, 128>(p, kv, B, stream);
  if (D == 256) return zt_dc::launch<TQ, TKV, 256>(p, kv, B, stream);
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

// The split form, R = T * Hq / Hkv <= 32 query rows a kv head: one
// cluster launch (decode_cluster.cuh).  dtype codes: q 0 = float32, 1 =
// bfloat16; k/v 1 = bfloat16, 2 = int8 (then ks/vs are its f32 scales
// [B, Hkv, S], else null).  pos0 int32 [B]; sinks f32 [Hq] or null; out
// like q.
extern "C" int zt_attn_blockwise(const void* q, int q_dtype, const void* k, const void* v,
                                 int kv_dtype, const float* ks, const float* vs, const int* pos0,
                                 const float* sinks, void* out, int B, int T, int Hq, int Hkv,
                                 int S, int D, float scale, float softcap, int window,
                                 void* stream) {
  if (Hq % Hkv != 0 || T <= 0 || S <= 0 || (kv_dtype == 2) != (ks != nullptr && vs != nullptr))
    return (int)cudaErrorInvalidValue;
  if (T * (Hq / Hkv) > MAXR) return (int)cudaErrorInvalidValue;
  zt_dc::Params p{};
  p.q = q;
  p.out = out;
  p.pos = pos0;
  p.sinks = sinks;
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.S = S;
  p.cs = zt_dc::CH;
  p.scale = scale;
  p.softcap = softcap;
  p.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZT_ARGS D, k, v, ks, vs, p, B, st
  if (q_dtype == 0 && kv_dtype == 1) return launch_split<float, __nv_bfloat16>(ZT_ARGS);
  if (q_dtype == 0 && kv_dtype == 2) return launch_split<float, int8_t>(ZT_ARGS);
  if (q_dtype == 1 && kv_dtype == 1) return launch_split<__nv_bfloat16, __nv_bfloat16>(ZT_ARGS);
  if (q_dtype == 1 && kv_dtype == 2) return launch_split<__nv_bfloat16, int8_t>(ZT_ARGS);
#undef ZT_ARGS
  return (int)cudaErrorInvalidValue;
}
