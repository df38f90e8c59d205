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
// (f32 accumulate); the output in q's dtype.
//
// Bound on the H100: the bytes of the K/V slots each row sees, 2 * Hkv *
// min(pos + 1, S) * D * sizeof(cache) a row, plus q and the output, over
// 3.35 TB/s; a few FLOPs a byte.  Design: where the TPU kernel holds a
// (row, kv head)'s whole cache in VMEM and runs one grid step per pair, an
// MHA model at B = 1 gives the H100 only 16 such pairs, and a block per pair
// walking 2048 slots is latency-bound (K9's first design, 8.70 ms a serve
// decode step).  So the slots are cut into splits of 128 that run in
// parallel: the three-launch split step of decode_split.cuh, with a
// contiguous addressor and the clamped insert, keeping the plain version's
// rounding points.

#include "decode_split.cuh"

// dtype codes: 0 = float32, 1 = bfloat16 (q, k_new, v_new share one; the
// caches another).  out [B, Hq, D]; scratch f32 [B, Hq, S + NP * (D + 2)]
// with NP = ceil(S / split).
extern "C" int zt_attn_decode_update(const void* q, const void* k_new, const void* v_new,
                                     int q_dtype, void* k_cache, void* v_cache, int c_dtype,
                                     const int* pos, void* out, float* scratch, int B, int Hq,
                                     int Hkv, int D, int S, int split, float scale, float softcap,
                                     int window, void* stream) {
  const zt_split::ContigAddr addr{Hkv, S};
  return zt_split::dispatch(q, k_new, v_new, q_dtype, k_cache, v_cache, c_dtype, pos, out,
                            scratch, B, Hq, Hkv, D, S, split, scale, softcap, window, addr,
                            stream);
}
