// K9: the paged decode step of one layer: insert the new K/V row into its
// page, then attend over the page table.
//
// Replaces zllm/ops/attention.py::_paged_decode_kernel (launched by
// paged_attn_decode_update): q[B, 1, Hq, D] (roped) and the new rows
// k/v_new[B, 1, Hkv, D] (roped K) of every slot; per-layer pools
// [Hkv, P * ps, D] (token-major: slot s of row b is pool row
// table[b, s / ps] * ps + s % ps); table int32 [B, LP + 1]; pos int32 [B].
// A row with pos < LP * ps (the horizon) writes its new K/V, cast to the
// pool dtype (f32, bf16 or f16), at its position; a row at or past the horizon (the engine's
// trash rows) writes nothing.  Then GQA attention over slots <= pos (and
// > pos - window), logit softcap, f32 scores, and zllm's page-by-page
// online softmax: exp(s - running max after the page) cast to the pool
// dtype before P.V (f32 accumulate), one division by the f32 denominator
// at the end, as K10 does.  Pages past pos and outside the window are
// never read.
//
// Bound on the H100: the bytes of the pages it must read, 2 * Hkv *
// (visible slots) * D * sizeof(pool) a row, over 3.35 TB/s; the work is a
// few FLOPs a byte.  Design: where the TPU kernel walks one page a grid
// step, here the pages of a (row, kv head, group of 8 query heads) are
// dealt to the 8 blocks of one thread-block cluster (decode_cluster.cuh,
// a page-table addressor, a chunk = a page of ps <= 128 slots), in one
// launch: each block keeps its pages' scores in shared memory, reads the
// prefix maxima (the running max after each of its pages) from its peers'
// page maxima over distributed shared memory, rounds exp(s - M_j) to the
// pool dtype, rescales each page's P.V to the row's max, and block 0 sums
// the blocks' partials and divides once.  The insert slot's K and V rows
// come from k/v_new (rounded), never from the pool.  Head dims 64, 128 and
// 256 (Gemma's); at D 256 bf16 and f16 pools only (an f32 pool's two
// 128-slot chunks of 1 KB rows exceed a block's shared memory), q's
// fragments in shared memory (decode_cluster.cuh's kQsmOf).

#include "decode_cluster.cuh"

namespace {

// pools [Hkv, n_rows, D]: chunk j of (b, h) is page table[b, j]; the
// insert slot's row is written from k/v_new
template <typename TQ, typename TP>
struct PagedKV {
  const TP* k;
  const TP* v;
  TP* k_pool;  // the same pools, written at the insert slot
  TP* v_pool;
  const TQ* k_new;  // [B, Hkv, D]
  const TQ* v_new;
  const int* table;
  int TW, n_rows;
  static constexpr bool kScaled = false;
  static constexpr int kRound = zt_dc::kRoundPage;  // exp(s - M_j) rounded to the pool dtype
  static constexpr bool kInsert = true;
  __device__ __forceinline__ size_t base(int b, int h, int j, int cs) const {
    return (size_t)h * n_rows + (size_t)__ldg(table + (size_t)b * TW + j) * cs;
  }
  // a row before the horizon S inserts at its position; the engine's trash
  // rows (at or past it) write nothing
  __device__ __forceinline__ int insert_slot(int p0, int S) const { return p0 < S ? p0 : -1; }
};

template <typename TQ, typename TP>
int launch(int D, const void* k_new, const void* v_new, void* k_pool, void* v_pool,
           const int* table, int TW, int n_rows, const zt_dc::Params& p, int B,
           cudaStream_t stream) {
  const PagedKV<TQ, TP> kv{static_cast<const TP*>(k_pool), static_cast<const TP*>(v_pool),
                           static_cast<TP*>(k_pool), static_cast<TP*>(v_pool),
                           static_cast<const TQ*>(k_new), static_cast<const TQ*>(v_new),
                           table, TW, n_rows};
  if (D == 64) return zt_dc::launch<TQ, TP, 64>(p, kv, B, stream);
  if (D == 128) return zt_dc::launch<TQ, TP, 128>(p, kv, B, stream);
  if constexpr (sizeof(TP) == 2) {
    if (D == 256) return zt_dc::launch<TQ, TP, 256>(p, kv, B, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 3 = float16 (q, k_new, v_new
// share one, f32 or bf16; the pools another, f32, bf16 or f16).  Pools [Hkv, n_rows, D]; table int32 [B, TW]; pos int32
// [B]; out [B, Hq, D]; 1 <= ps <= 128; the horizon S = (TW - 1) * ps.
extern "C" int zt_paged_attn_decode_update(const void* q, const void* k_new, const void* v_new,
                                           int q_dtype, void* k_pool, void* v_pool, int p_dtype,
                                           const int* table, const int* pos, void* out, int B,
                                           int Hq, int Hkv, int D, int n_rows, int TW, int ps,
                                           float scale, float softcap, int window,
                                           void* stream) {
  if (TW < 2 || ps <= 0 || ps > zt_dc::CH || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  zt_dc::Params p{};
  p.q = q;
  p.out = out;
  p.pos = pos;
  p.sinks = nullptr;
  p.T = 1;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.S = (TW - 1) * ps;
  p.cs = ps;
  p.scale = scale;
  p.softcap = softcap;
  p.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZT_ARGS D, k_new, v_new, k_pool, v_pool, table, TW, n_rows, p, B, st
  if (q_dtype == 0 && p_dtype == 0) return launch<float, float>(ZT_ARGS);
  if (q_dtype == 0 && p_dtype == 1) return launch<float, __nv_bfloat16>(ZT_ARGS);
  if (q_dtype == 1 && p_dtype == 0) return launch<__nv_bfloat16, float>(ZT_ARGS);
  if (q_dtype == 1 && p_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(ZT_ARGS);
  if (q_dtype == 0 && p_dtype == 3) return launch<float, __half>(ZT_ARGS);
  if (q_dtype == 1 && p_dtype == 3) return launch<__nv_bfloat16, __half>(ZT_ARGS);
#undef ZT_ARGS
  return (int)cudaErrorInvalidValue;
}
