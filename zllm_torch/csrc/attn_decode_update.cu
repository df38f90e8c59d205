// K8: the contiguous-cache decode step of one layer: insert the new K/V row
// into the [B, Hkv, S, D] caches in place, then attend.
//
// Replaces zllm/ops/attention.py::_attn_decode_kernel (launched by
// attn_decode_update): q[B, 1, Hq, D] (roped; not rounded to the cache
// dtype) and the new rows k/v_new[B, 1, Hkv, D] (roped K); caches
// [B, Hkv, S, D]; pos int32 [B].  Row b writes its new K/V, cast to the
// cache dtype, at slot min(pos, S - 1) (a trash row, pos == S, writes slot
// S - 1 and attends all S slots), then GQA attention (any group) over slots
// <= pos (and > pos - window), logit softcap, f32 scores and softmax, the
// probabilities normalized and then cast to the cache dtype before P.V
// (f32 accumulate); the output in q's dtype.  Caches f32, bf16 or f16 (the
// f16 KV cache, `--kv-type f16`); q f32 or bf16.
//
// Bound on the H100: the bytes of the K/V slots each row sees, 2 * Hkv *
// min(pos + 1, S) * D * sizeof(cache) a row, plus q and the output, over
// 3.35 TB/s; a few FLOPs a byte.  Where the TPU kernel holds a (row, kv
// head)'s whole cache in VMEM and runs one grid step per pair, an MHA model
// at B = 1 gives the H100 only 16 such pairs, and a block per pair walking
// 2048 slots is latency-bound.  Design: the one-launch cluster decode step
// of decode_cluster.cuh (shared with K7's split form and K9) behind a
// contiguous addressor: the 128-slot chunks of a (row, kv head, group of 8
// query rows)'s span are dealt to the 8 blocks of a thread-block cluster,
// each block keeps its chunks' scores in shared memory, the row's max and
// f32 denominator come from the peers' chunk statistics over distributed
// shared memory (every block sums them in one order), and p = exp(s - M) /
// l is rounded to the cache dtype where the plain version rounds it.  The
// insert: the block that owns the insert chunk writes the cache row and
// patches its staged K and V rows with the rounded new row; no global
// scratch, one launch a call (the three-launch split step it replaces
// round-tripped scores and partials through a scratch).
//
// Where trouble lies: a GPC holds whole clusters, and at one block an SM
// the H100 held 15 of K8's D 128 clusters at once, so an OLMo-2 step's 16
// ran as two waves; the bf16-cache forms run two blocks an SM (p is one
// bf16 part, which frees the registers), 30 clusters at once
// (zt_attn_decode_update_clusters reports it).
//
// The f16-cache form: the header's f16 pool form (K9's), on f16 x f16
// mma.sync.  Phase 1: each query row scaled by the power of two that brings
// its largest |q| into [2^14, 2^15) (zt::f16_row_exp), then split into three
// f16 parts (one for a bf16 q), its 2^-e folded into the score's scale, all
// exact; q itself is never rounded to f16, as zllm's kernel keeps it.
// Phase 2: p = exp(s - M) / l is normalized in f32 and rounded to f16, as
// the plain version rounds it, which makes it one exact f16 part (no 2^15
// pre-scale, unlike K9's unnormalized p), subnormals under 2^-14 kept by
// the round-to-nearest conversion and by the tensor cores.  The new row is
// written in f16 at min(pos, S - 1).  The 2^e of each row lives in the
// dynamic shared memory beside the rest, two blocks an SM as for bf16.

#include "decode_cluster.cuh"

namespace {

// contiguous caches [B, Hkv, S, D]: chunk j of (b, h) from slot j * cs; the
// insert slot's row is written from k/v_new
template <typename TQ, typename TC>
struct ContigInsertKV {
  const TC* k;
  const TC* v;
  TC* k_pool;  // the same caches, written at the insert slot
  TC* v_pool;
  const TQ* k_new;  // [B, Hkv, D]
  const TQ* v_new;
  int Hkv, S;
  static constexpr bool kScaled = false;
  static constexpr int kRound = zt_dc::kRoundNorm;  // p normalized, then rounded to the cache dtype
  static constexpr bool kInsert = true;
  __device__ __forceinline__ size_t base(int b, int h, int j, int cs) const {
    return ((size_t)b * Hkv + h) * S + (size_t)j * cs;
  }
  // zllm's dynamic_update_slice clamps: a trash row (pos == S) writes S - 1
  __device__ __forceinline__ int insert_slot(int p0, int S_) const { return min(p0, S_ - 1); }
};

zt_dc::Params params(const void* q, void* out, const int* pos, int Hq, int Hkv, int S,
                     float scale, float softcap, int window) {
  zt_dc::Params p{};
  p.q = q;
  p.out = out;
  p.pos = pos;
  p.sinks = nullptr;
  p.T = 1;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.S = S;
  p.cs = zt_dc::CH;
  p.scale = scale;
  p.softcap = softcap;
  p.window = window;
  return p;
}

template <typename TQ, typename TC>
ContigInsertKV<TQ, TC> addressor(const void* k_new, const void* v_new, void* k_cache,
                                 void* v_cache, int Hkv, int S) {
  return {static_cast<const TC*>(k_cache), static_cast<const TC*>(v_cache),
          static_cast<TC*>(k_cache), static_cast<TC*>(v_cache),
          static_cast<const TQ*>(k_new), static_cast<const TQ*>(v_new), Hkv, S};
}

template <typename TQ, typename TC>
int launch(int D, const void* k_new, const void* v_new, void* k_cache, void* v_cache,
           const zt_dc::Params& p, int B, cudaStream_t stream) {
  const auto kv = addressor<TQ, TC>(k_new, v_new, k_cache, v_cache, p.Hkv, p.S);
  if (D == 64) return zt_dc::launch<TQ, TC, 64>(p, kv, B, stream);
  if (D == 128) return zt_dc::launch<TQ, TC, 128>(p, kv, B, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename TQ, typename TC>
int clusters(int D, const zt_dc::Params& p, int B, int* n) {
  using KV = ContigInsertKV<TQ, TC>;
  if (D == 64) return zt_dc::max_active_clusters<TQ, TC, 64, KV>(p, B, n);
  if (D == 128) return zt_dc::max_active_clusters<TQ, TC, 128, KV>(p, B, n);
  return (int)cudaErrorInvalidValue;
}

bool bad_shape(int Hq, int Hkv, int D, int S) {
  return (D != 64 && D != 128) || Hkv <= 0 || Hq % Hkv != 0 || S <= 0;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 3 = float16 (q, k_new, v_new
// share one, f32 or bf16; the caches another, f32, bf16 or f16).  Caches
// [B, Hkv, S, D]; pos int32 [B]; out [B, Hq, D] in q's dtype.
extern "C" int zt_attn_decode_update(const void* q, const void* k_new, const void* v_new,
                                     int q_dtype, void* k_cache, void* v_cache, int c_dtype,
                                     const int* pos, void* out, int B, int Hq, int Hkv, int D,
                                     int S, float scale, float softcap, int window,
                                     void* stream) {
  if (bad_shape(Hq, Hkv, D, S)) return (int)cudaErrorInvalidValue;
  const zt_dc::Params p = params(q, out, pos, Hq, Hkv, S, scale, softcap, window);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZT_ARGS D, k_new, v_new, k_cache, v_cache, p, B, st
  if (q_dtype == 0 && c_dtype == 0) return launch<float, float>(ZT_ARGS);
  if (q_dtype == 0 && c_dtype == 1) return launch<float, __nv_bfloat16>(ZT_ARGS);
  if (q_dtype == 1 && c_dtype == 0) return launch<__nv_bfloat16, float>(ZT_ARGS);
  if (q_dtype == 1 && c_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(ZT_ARGS);
  if (q_dtype == 0 && c_dtype == 3) return launch<float, __half>(ZT_ARGS);
  if (q_dtype == 1 && c_dtype == 3) return launch<__nv_bfloat16, __half>(ZT_ARGS);
#undef ZT_ARGS
  return (int)cudaErrorInvalidValue;
}

// The clusters of one call's shape the card holds at once
// (cudaOccupancyMaxActiveClusters) in *n; dtype codes as above.
extern "C" int zt_attn_decode_update_clusters(int q_dtype, int c_dtype, int B, int Hq, int Hkv,
                                              int D, int S, int* n) {
  if (bad_shape(Hq, Hkv, D, S)) return (int)cudaErrorInvalidValue;
  const zt_dc::Params p = params(nullptr, nullptr, nullptr, Hq, Hkv, S, 1.f, 0.f, 0);
#define ZT_ARGS D, p, B, n
  if (q_dtype == 0 && c_dtype == 0) return clusters<float, float>(ZT_ARGS);
  if (q_dtype == 0 && c_dtype == 1) return clusters<float, __nv_bfloat16>(ZT_ARGS);
  if (q_dtype == 1 && c_dtype == 0) return clusters<__nv_bfloat16, float>(ZT_ARGS);
  if (q_dtype == 1 && c_dtype == 1) return clusters<__nv_bfloat16, __nv_bfloat16>(ZT_ARGS);
  if (q_dtype == 0 && c_dtype == 3) return clusters<float, __half>(ZT_ARGS);
  if (q_dtype == 1 && c_dtype == 3) return clusters<__nv_bfloat16, __half>(ZT_ARGS);
#undef ZT_ARGS
  return (int)cudaErrorInvalidValue;
}
