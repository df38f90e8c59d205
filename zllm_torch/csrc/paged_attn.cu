// K10: multi-token GQA attention over a paged KV pool.
//
// Replaces zllm/ops/attention.py::_paged_attn_kernel (launched by
// paged_attention): queries q[B, T, Hq, D] at consecutive positions
// pos0[b] + t attend the logical slots 0 .. LP*ps - 1 of their row, read
// through the page table, over slots <= pos (and > pos - window), with
// optional logit softcap.  As in zllm, the causal mask comes from pos0
// alone: the engine's mixed step puts a generating row's one real token in
// column 0 and trash positions in the rest, and reads back column 0 only.
//
// Layout: each layer's pool is token-major, [Hkv, P * ps, D]; slot s of
// row b is pool row table[b, s / ps] * ps + s % ps of head h.  The TPU
// kernel streams one page per grid step through its scalar-prefetched
// table and keeps an online softmax whose max advances once a page, with
// exp(s - max) rounded to the pool dtype before P.V.  Here, for bf16
// pools (the serving path's) and f16 pools (`--kv-type f16`: f16 x f16
// mma.sync, q's rows scaled by a power of two before their f16 split, see
// attn_mma.cuh), the one-pass tensor-core loop of attn_mma.cuh (shared
// with K7's multi-row form) does the same: chunks of
// 128 slots (64 when ps is not a multiple of 128) never straddle a page, so
// one table read a chunk gives its base row and its rows are contiguous; a
// page of one chunk is scored once, a larger one walked twice (its max,
// then P.V).  f32 pools (the f32 engines and tests; bf16 operands would
// round K/V) take the CUDA-core tile loop of attn_tile.cuh (shared with
// K6's f32 K/V) in 64-slot tiles, whose probabilities, normalized before the
// rounding to f32, are the same values.
//
// Bound on the H100: 4 * Hq * D FLOPs per visible (query, slot) pair over
// the 989 TFLOP/s tensor-core peak, or the q/out bytes and the bytes of the
// pages read over 3.35 TB/s, whichever is larger; at the serve path's mixed
// step (chunk 128, rows from 0, 256, 300 and a trash row) it is the bytes,
// by a small margin.  A block of the bf16 loop takes 32 of the T * G query
// rows of one (slot, kv head), so a chunk of 128 at G = 8 gives 32 x Hkv x
// B blocks, the idle row's first.  Head dims 64, 128 and 256 (Gemma's):
// at D 256 the bf16/f16 loop always takes chunks of 64 slots (two stages of
// 128 would not fit a block's shared memory with an f32 q's three parts),
// and the f32 tile loop its 64-slot tiles as at the other widths.

#include "attn_mma.cuh"
#include "attn_tile.cuh"

namespace {

using namespace zt_attn;

template <typename T>
struct PagedKV {
  const T* k;
  const T* v;
  const int* table;  // [B, TW]
  int TW, ps, D;
  size_t head_stride;  // P * ps * D elements per head
  static constexpr bool kScales = false;
  __device__ __forceinline__ size_t off(int b, int h, int s0) const {
    const int page = __ldg(table + (size_t)b * TW + s0 / ps);
    return (size_t)h * head_stride + ((size_t)page * ps + s0 % ps) * D;
  }
  __device__ __forceinline__ const T* k_rows(int b, int h, int s0) const { return k + off(b, h, s0); }
  __device__ __forceinline__ const T* v_rows(int b, int h, int s0) const { return v + off(b, h, s0); }
};

// the tile loop over f32 pools
template <typename TQ>
int launch_d(int D, const void* q, const void* k, const void* v, const int* table,
             const int* pos0, void* out, int B, int T, int Hq, int Hkv, int n_rows, int TW,
             int ps, float scale, float softcap, int window, cudaStream_t s) {
  const PagedKV<float> kv{static_cast<const float*>(k), static_cast<const float*>(v), table, TW,
                          ps, D, (size_t)n_rows * D};
  const int S = (TW - 1) * ps;  // the last table column is the trash pin
  if (D == 64)
    return launch_tiles<TQ, float, 64>(q, kv, pos0, nullptr, out, B, T, Hq, Hkv, S, scale,
                                       softcap, window, s);
  if (D == 128)
    return launch_tiles<TQ, float, 128>(q, kv, pos0, nullptr, out, B, T, Hq, Hkv, S, scale,
                                        softcap, window, s);
  if (D == 256)
    return launch_tiles<TQ, float, 256>(q, kv, pos0, nullptr, out, B, T, Hq, Hkv, S, scale,
                                        softcap, window, s);
  return (int)cudaErrorInvalidValue;
}

template <typename TQ, typename TP, int D, int CH>
int launch_mma_d(const PagedKV<TP>& kv, const zt_mma::Params& a, cudaStream_t s) {
  return zt_mma::launch_mma<TQ, TP, D, CH, true>(kv, a, s);
}

template <typename TQ, typename TP>
int launch_mma_q(int D, const void* k_pool, const void* v_pool, const int* table, int TW,
                 int n_rows, const zt_mma::Params& a, cudaStream_t s) {
  const PagedKV<TP> kv{static_cast<const TP*>(k_pool), static_cast<const TP*>(v_pool), table, TW,
                       a.ps, D, (size_t)n_rows * D};
  const bool ch128 = a.ps % 128 == 0;
  if (D == 64)
    return ch128 ? launch_mma_d<TQ, TP, 64, 128>(kv, a, s) : launch_mma_d<TQ, TP, 64, 64>(kv, a, s);
  if (D == 128)
    return ch128 ? launch_mma_d<TQ, TP, 128, 128>(kv, a, s)
                 : launch_mma_d<TQ, TP, 128, 64>(kv, a, s);
  if (D == 256) return launch_mma_d<TQ, TP, 256, 64>(kv, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The tensor-core loop (attn_mma.cuh): bf16 (kv_dtype 1) or f16 (kv_dtype
// 3) pools, q 0 = float32 or 1 = bfloat16; shapes as zt_paged_attention.
extern "C" int zt_paged_attention_mma(const void* q, int q_dtype, const void* k_pool,
                                      const void* v_pool, int kv_dtype, const int* table,
                                      const int* pos0, void* out, int B, int T, int Hq, int Hkv,
                                      int D, int n_rows, int TW, int ps, float scale,
                                      float softcap, int window, void* stream) {
  if (Hq % Hkv != 0 || T <= 0 || TW < 2 || ps % 64 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const zt_mma::Params a{q, out, pos0, nullptr, B, T, Hq, Hkv, (TW - 1) * ps, ps,
                         scale, softcap, window};
#define ZT_ARGS D, k_pool, v_pool, table, TW, n_rows, a, s
  if (q_dtype == 0 && kv_dtype == 1) return launch_mma_q<float, __nv_bfloat16>(ZT_ARGS);
  if (q_dtype == 1 && kv_dtype == 1) return launch_mma_q<__nv_bfloat16, __nv_bfloat16>(ZT_ARGS);
  if (q_dtype == 0 && kv_dtype == 3) return launch_mma_q<float, __half>(ZT_ARGS);
  if (q_dtype == 1 && kv_dtype == 3) return launch_mma_q<__nv_bfloat16, __half>(ZT_ARGS);
#undef ZT_ARGS
  return (int)cudaErrorInvalidValue;
}

// The CUDA-core tile loop (attn_tile.cuh), f32 pools (kv_dtype 0).  dtype
// codes: 0 = float32, 1 = bfloat16.  Pools [Hkv, n_rows, D] with n_rows =
// P * ps; table int32 [B, TW]; pos0 int32 [B].
extern "C" int zt_paged_attention(const void* q, int q_dtype, const void* k_pool,
                                  const void* v_pool, int kv_dtype, const int* table,
                                  const int* pos0, void* out, int B, int T, int Hq, int Hkv,
                                  int D, int n_rows, int TW, int ps, float scale, float softcap,
                                  int window, void* stream) {
  if (Hq % Hkv != 0 || T <= 0 || TW < 2 || ps % KT != 0 || kv_dtype != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ZT_ARGS D, q, k_pool, v_pool, table, pos0, out, B, T, Hq, Hkv, n_rows, TW, ps, scale, \
                softcap, window, s
  if (q_dtype == 0) return launch_d<float>(ZT_ARGS);
  if (q_dtype == 1) return launch_d<__nv_bfloat16>(ZT_ARGS);
#undef ZT_ARGS
  return (int)cudaErrorInvalidValue;
}
