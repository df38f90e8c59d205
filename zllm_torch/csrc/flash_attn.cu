// K6: multi-token (prefill) attention with GQA over a contiguous cache.
//
// Replaces zllm/ops/attention.py::_attn_kernel (launched by flash_attention):
// queries q[B, T, Hq, D] at consecutive positions pos0[b] + t attend the
// cache k/v[B, Hkv, S, D] over slots <= pos (and > pos - window), with
// optional logit softcap and per-head attention sinks in the softmax
// denominator.  Scores are f32; the probabilities are normalized, then
// cast to V's dtype before P.V (f32 accumulate), as the Pallas kernel does.
//
// Bound on the H100: 4 * Hq * D FLOPs per visible (query, slot) pair over
// the 989 TFLOP/s tensor-core peak, or the q/k/v/out bytes over 3.35 TB/s,
// whichever is larger; at prefill shapes it is compute.  Where the TPU
// kernel holds a whole (batch, kv-head) context in VMEM, the tile loop of
// attn_tile.cuh (shared with K10) streams K/V through shared memory in
// tiles of 64 slots; here a tile is the 64 rows of one (batch, kv head)
// stripe of the cache.

#include "attn_tile.cuh"

namespace {

using namespace zt_attn;

// slot s of (b, h) at k + ((b * Hkv + h) * S + s) * D
template <typename T>
struct ContigKV {
  const T* k;
  const T* v;
  int Hkv, S, D;
  static constexpr bool kScales = false;
  __device__ __forceinline__ size_t off(int b, int h, int s0) const {
    return (((size_t)b * Hkv + h) * S + s0) * D;
  }
  __device__ __forceinline__ const T* k_rows(int b, int h, int s0) const { return k + off(b, h, s0); }
  __device__ __forceinline__ const T* v_rows(int b, int h, int s0) const { return v + off(b, h, s0); }
};

template <typename TQ, typename TKV>
int launch_d(int D, const void* q, const void* k, const void* v, const int* pos0,
             const float* sinks, void* out, int B, int T, int Hq, int Hkv, int S, float scale,
             float softcap, int window, cudaStream_t s) {
  const ContigKV<TKV> kv{static_cast<const TKV*>(k), static_cast<const TKV*>(v), Hkv, S, D};
  if (D == 64)
    return launch_tiles<TQ, TKV, 64>(q, kv, pos0, sinks, out, B, T, Hq, Hkv, S, scale, softcap,
                                     window, s);
  if (D == 128)
    return launch_tiles<TQ, TKV, 128>(q, kv, pos0, sinks, out, B, T, Hq, Hkv, S, scale,
                                      softcap, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  sinks may be null.
extern "C" int zt_flash_attention(const void* q, int q_dtype, const void* k, const void* v,
                                  int kv_dtype, const int* pos0, const float* sinks, void* out,
                                  int B, int T, int Hq, int Hkv, int S, int D, float scale,
                                  float softcap, int window, void* stream) {
  if (Hq % Hkv != 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ZT_ARGS D, q, k, v, pos0, sinks, out, B, T, Hq, Hkv, S, scale, softcap, window, s
  if (q_dtype == 0 && kv_dtype == 0) return launch_d<float, float>(ZT_ARGS);
  if (q_dtype == 0 && kv_dtype == 1) return launch_d<float, __nv_bfloat16>(ZT_ARGS);
  if (q_dtype == 1 && kv_dtype == 0) return launch_d<__nv_bfloat16, float>(ZT_ARGS);
  if (q_dtype == 1 && kv_dtype == 1) return launch_d<__nv_bfloat16, __nv_bfloat16>(ZT_ARGS);
#undef ZT_ARGS
  return (int)cudaErrorInvalidValue;
}
