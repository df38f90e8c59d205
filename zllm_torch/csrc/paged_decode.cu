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
// > pos - window), logit softcap, f32 scores, and zllm's page-by-page
// online softmax: exp(s - running max after the page) cast to the pool
// dtype before P.V (f32 accumulate), one division by the f32 denominator
// at the end, as K10 does.  Pages past pos and outside the window are
// never read.
//
// Bound on the H100: the bytes of the pages it must read, 2 * Hkv *
// (visible slots) * D * sizeof(pool) a row, over 3.35 TB/s; the work is a
// few FLOPs a byte.  Design: where the TPU kernel walks one page a grid
// step, here every (logical page, kv head, slot) is a block, so a row's
// pages are read in parallel (flash-decoding), in three launches: the
// split decode step of decode_split.cuh with a page-table addressor (a
// split is a page, `kPageRound`), which K8 shares with a contiguous one.
// Launch 2 rounds a page's probabilities at the running max after that
// page (the prefix max of the split maxima) and launch 3 rescales each
// page's P.V to the row's max, so the splits still run in parallel.  Other
// slots read only full prefix pages, which are never an insert page.

#include "decode_split.cuh"

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
  if (TW < 2 || ps <= 0) return (int)cudaErrorInvalidValue;
  const zt_split::PagedAddr addr{table, TW, n_rows};
  return zt_split::dispatch(q, k_new, v_new, q_dtype, k_pool, v_pool, p_dtype, pos, out, scratch,
                            B, Hq, Hkv, D, (TW - 1) * ps, ps, scale, softcap, window, addr,
                            stream);
}
