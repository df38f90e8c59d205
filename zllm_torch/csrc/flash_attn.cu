// K6: multi-token (prefill) attention with GQA over a contiguous cache.
//
// Replaces zllm/ops/attention.py::_attn_kernel (launched by flash_attention):
// queries q[B, T, Hq, D] at consecutive positions pos0[b] + t attend the
// cache k/v[B, Hkv, S, D] over slots <= pos (and > pos - window), with
// optional logit softcap and per-head attention sinks in the softmax
// denominator.  Scores are f32; one global row max (with the sink), then
// the probabilities exp(s - m) / denom are normalized, cast to V's dtype,
// and P.V is summed in f32, as the Pallas kernel does.  So unlike K10
// (which rounds exp(s - running max) a page at a time) and K7 (which never
// rounds p), a probability can be rounded only once the row's final max and
// denominator are known.
//
// Bound on the H100: 4 * Hq * D FLOPs per visible (query, slot) pair over
// the 989 TFLOP/s tensor-core peak, or the q/k/v/out bytes over 3.35 TB/s,
// whichever is larger; at prefill shapes it is the bytes by a small margin.
// Where the TPU kernel holds a whole (batch, kv-head) context in VMEM, two
// forms here, by K/V's dtype (a route by dtype, never a fallback):
//
//  * bf16 K/V (zt_flash_attention_mma; the Generator's and the engine's
//    bf16 caches): two passes over the block's band of slots on the bf16
//    tensor cores.  A block takes 32 query rows of one (row b, kv head),
//    rows t-major and group-minor, in two row groups of 16, each served by
//    two warps that take one half of every 128-slot chunk by absolute slot
//    index; K/V chunks stream through attn_mma.cuh's two-stage cp.async
//    ring.  Pass 1 (K only): S = Q.K^T on mma.sync m16n8k16 with f32
//    accumulators, an f32 q split into three bf16 parts (hi, mid, lo;
//    attn_mma.cuh's split_pair) so that the scores keep f32 precision, a
//    bf16 q one part, bf16 K exact; scale, softcap, mask (zllm's finite
//    NEG_INF); each warp keeps its own online row max and sum.  The two
//    warps' (max, sum) then merge in a fixed order and the sinks join.
//    Pass 2 (K and V): the same MMA chain gives the same score bits;
//    p = exp(s - m) / l with an IEEE division, rounded to bf16, is the A
//    operand of P.V straight from the accumulator registers, V comes
//    through ldmatrix.trans, and the two warps' sums are added at the end.
//    A row's bits depend on its q, its position and the cache only, never
//    on T, B or the other rows of its block: chunks sit at absolute slot
//    indices, and a chunk of the band that a row does not see adds exact
//    zeros (its probabilities are exp(NEG_INF - m) = 0; before the row's
//    first visible slot a warp's junk sum of exp(0) is wiped by the alpha
//    = exp(NEG_INF - m) = 0 of the first visible chunk or of the merge).
//    Blocks are ordered so that the rows with the most slots start first.
//  * f16 K/V (zt_flash_attention_mma too; the f16 KV cache, the Generator's
//    and the engine's with kv_dtype float16): the same two passes on f16 x
//    f16 mma.sync, the bf16 rate.  K and V are exact in f16, and so is p,
//    rounded to f16 after the IEEE division (one part).  q is split as
//    attn_mma.cuh's f16 form splits it: each query row scaled by the power
//    of two that brings its largest |q| into [2^14, 2^15)
//    (zt::f16_row_exp), then three f16 parts (f32 q) or one (bf16 q), the
//    row's 2^-e folded into the score's scale on the f32 accumulator, so
//    the scores keep f32 precision without f16 overflow or subnormal parts.
//  * f32 K/V (zt_flash_attention): the CUDA-core tile loop of attn_tile.cuh
//    (shared with K10's f32 pools), since bf16 tensor-core operands would
//    round K/V; the probabilities are rounded to f32, the identity.
//
// Head dims 64, 128 and 256 (Gemma's).  At D 256 the tensor-core form takes
// chunks of 64 slots (two stages of 128 would need 264 KB of shared memory
// with an f32 q's three parts; 64 take 182 KB, one block an SM), and its O
// accumulators, 128 registers a thread, stay under the 255 of two blocks'
// launch bound; the tile loop's f32 tiles take 169 KB.

#include "attn_mma.cuh"
#include "attn_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

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

template <typename TQ>
int launch_tile(int D, const void* q, const void* k, const void* v, const int* pos0,
                const float* sinks, void* out, int B, int T, int Hq, int Hkv, int S, float scale,
                float softcap, int window, cudaStream_t s) {
  const ContigKV<float> kv{static_cast<const float*>(k), static_cast<const float*>(v), Hkv, S, D};
  if (D == 64)
    return zt_attn::launch_tiles<TQ, float, 64>(q, kv, pos0, sinks, out, B, T, Hq, Hkv, S, scale,
                                                softcap, window, s);
  if (D == 128)
    return zt_attn::launch_tiles<TQ, float, 128>(q, kv, pos0, sinks, out, B, T, Hq, Hkv, S,
                                                 scale, softcap, window, s);
  if (D == 256)
    return zt_attn::launch_tiles<TQ, float, 256>(q, kv, pos0, sinks, out, B, T, Hq, Hkv, S,
                                                 scale, softcap, window, s);
  return (int)cudaErrorInvalidValue;
}

// ---- the tensor-core form (bf16 or f16 K/V) --------------------------------

using zt_mma::kNegInf;
using zt_mma::kSlotWarps;
using zt_mma::QB;
// slots a chunk: 128, 64 at D 256 (two stages of its rows fit a block)
template <int D>
constexpr int kChOf = D > 128 ? 64 : 128;

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(zt_mma::kThreads, 2)
    flash_mma_kernel(const ContigKV<TKV> kv, const zt_mma::Params a) {
  using namespace zt;
  constexpr int kCh = kChOf<D>;
  using L = zt_mma::Layout<TQ, TKV, D, kCh, false>;
  using TT = TKV;  // the tensor cores' operand type: the K/V dtype
  constexpr bool kF16 = zt_mma::IsF16<TKV>::value;
  constexpr int QS = L::QS, RS = L::RS, ND = D / 8, kThreads = zt_mma::kThreads;
  static_assert(RS == QS, "chunk_scores reads K rows at q's stride");
  constexpr int HC = kCh / kSlotWarps, NT = HC / 8;  // a warp's slots of a chunk, n-tiles of 8
  static_assert(HC % 16 == 0 && D % 16 == 0, "shapes");
  static_assert((size_t)(kSlotWarps - 1) * QB * (D + 1) * 4 <= 2 * L::stage_bytes, "combine");
  extern __shared__ __align__(16) unsigned char smem[];
  TT* qs = reinterpret_cast<TT*>(smem);  // [NQ][QB][QS]
  unsigned char* stages = smem + L::q_bytes;
  __shared__ int b_sel;
  __shared__ float stat[kSlotWarps][QB][2];  // each warp's pass-1 (max, sum) of a row
  __shared__ unsigned q_amax[kF16 ? QB : 1];   // f16: each q row's largest |q|,
  __shared__ float q_unscale[kF16 ? QB : 1];   // and its 2^-e

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = warp / kSlotWarps, sh = warp % kSlotWarps;  // row group, share of a chunk
  const int G = a.Hq / a.Hkv, R = a.T * G, nrb = (R + QB - 1) / QB;

  int rb, h;
  zt_mma::order_block(a, nrb, rb, h, &b_sel);  // the rows with the most slots first
  const int r0 = rb * QB, r_end = min(r0 + QB, R);
  __syncthreads();  // b_sel
  const int b = b_sel;
  zt_mma::stage_q<TQ, TT, D, L::NQ, QS>(a, b, h, r0, qs, q_amax, q_unscale);
  const int p0 = a.pos0[b];

  // the block's band of slots in chunks of kCh at absolute slot indices,
  // walked twice: visits 0 .. nc-1 pass 1 (K), nc .. 2nc-1 pass 2 (K, V)
  const int qp_min = p0 + r0 / G, qp_max = p0 + (r_end - 1) / G;
  const int col_hi = min(qp_max, a.S - 1);
  const int col_lo = a.window > 0 ? max(0, qp_min - a.window + 1) : 0;
  const int c_lo = col_lo / kCh;
  const int nc = col_lo <= col_hi ? col_hi / kCh - c_lo + 1 : 0;
  const int nv = 2 * nc;

  auto issue = [&](int v) {
    const bool pv = v >= nc;
    const int s0 = (c_lo + (pv ? v - nc : v)) * kCh;
    TKV* kt = reinterpret_cast<TKV*>(stages + (v & 1) * L::stage_bytes);
    TKV* vt = kt + kCh * RS;
    const TKV* kg = kv.k_rows(b, h, s0);
    const TKV* vg = kv.v_rows(b, h, s0);
    constexpr int kRowP = D / 8;  // 16-byte pieces a row
    for (int p = tid; p < kCh * kRowP; p += kThreads) {
      const int j = p / kRowP, c = (p % kRowP) * 8;
      const bool ok = s0 + j < a.S;
      const size_t go = ok ? (size_t)j * D + c : 0;
      cp_async16(kt + j * RS + c, kg + go, ok ? 16 : 0);
      if (pv) cp_async16(vt + j * RS + c, vg + go, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  // this thread's two rows (gid, gid + 8 of its row group's 16), and the
  // rows of the warp (for the chunks that need no mask)
  const int wr0 = rg * 16, so = sh * HC;
  int qp[2];
  bool rv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + wr0 + gid + 8 * i;
    rv[i] = r < R;
    qp[i] = p0 + r / G;
  }
  const bool rows_full = r0 + wr0 + 15 < R;
  const int wqp_lo = p0 + (r0 + wr0) / G, wqp_hi = p0 + min(r0 + wr0 + 15, R - 1) / G;
  // f16: the scale of each of this thread's two rows, with the row's 2^-e
  float rsc[2] = {a.scale, a.scale};
  if constexpr (kF16) {
#pragma unroll
    for (int i = 0; i < 2; ++i) rsc[i] = a.scale * q_unscale[wr0 + gid + 8 * i];
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  if (nv > 0) issue(0);
  for (int v = 0; v < nv; ++v) {
    cp_async_wait_all();
    __syncthreads();  // chunk v has landed; chunk v - 1's stage is free; stat is written
    if (v + 1 < nv) issue(v + 1);  // in flight while chunk v computes
    const bool pv = v >= nc;
    const int s0 = (c_lo + (pv ? v - nc : v)) * kCh;
    const TT* kb = reinterpret_cast<const TT*>(stages + (v & 1) * L::stage_bytes) + so * RS;
    const TT* vb = kb + kCh * RS;

    // scores of this warp's half, one code path for both passes: s[n] the
    // 16x8 accumulator of slots s0 + so + 8n .. +7; scale, softcap, mask
    // (only where some slot of the half is outside some row's band)
    float s[NT][4];
    zt_mma::chunk_scores<L::NQ, NT, D, QS, TT>(s, qs, kb, wr0, lane);
    const int c0 = s0 + so;
    const bool full = rows_full && c0 + HC <= a.S && c0 + HC - 1 <= wqp_lo &&
                      (a.window <= 0 || c0 > wqp_hi - a.window);
    if constexpr (kF16) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= rsc[e >> 1];
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= a.scale;
    }
    zt_mma::cap_and_mask<NT>(s, a, full, c0, tig, rv, qp);

    if (!pv) {  // pass 1: this warp's online row max and sum
      float mx[2] = {kNegInf, kNegInf}, ls[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        mx[i] = fmaxf(m[i], mx[i]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ls[e >> 1] += expf(s[n][e] - mx[e >> 1]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ls[i] += __shfl_xor_sync(0xffffffffu, ls[i], 1);
        ls[i] += __shfl_xor_sync(0xffffffffu, ls[i], 2);
        l[i] = l[i] * expf(m[i] - mx[i]) + ls[i];
        m[i] = mx[i];
        if (v == nc - 1 && tig == 0) {
          stat[sh][wr0 + gid + 8 * i][0] = m[i];
          stat[sh][wr0 + gid + 8 * i][1] = l[i];
        }
      }
      continue;
    }
    if (v == nc) {  // the warps' (max, sum) merged in one order, then the sinks
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rr = wr0 + gid + 8 * i;
        float mm = stat[0][rr][0];
#pragma unroll
        for (int w = 1; w < kSlotWarps; ++w) mm = fmaxf(mm, stat[w][rr][0]);
        float ll = 0.f;
#pragma unroll
        for (int w = 0; w < kSlotWarps; ++w) ll += stat[w][rr][1] * expf(stat[w][rr][0] - mm);
        if (mm == kNegInf) ll = 0.f;  // the row sees no slot: only junk sums
        if (a.sinks != nullptr) {
          const float sk = a.sinks[h * G + (r0 + rr) % G];
          const float mf = fmaxf(mm, sk);
          ll = ll * expf(mm - mf) + expf(sk - mf);
          mm = mf;
        }
        if (!(ll > 0.f)) {  // nothing to attend: p = exp(NEG_INF) / 1 = 0, output 0
          mm = 0.f;
          ll = 1.f;
        }
        m[i] = mm;
        l[i] = ll;
      }
    }
    // pass 2: p = exp(s - m) / l rounded to the K/V dtype is the A fragment of a
    // k-step: a0 (row gid, k 0-7), a1 (row gid+8, k 0-7), a2 (row gid, k
    // 8-15), a3 (row gid+8, k 8-15)
#pragma unroll
    for (int k2 = 0; k2 < HC / 16; ++k2) {
      uint32_t ap[4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {  // n-tiles 2 k2 (k 0-7), 2 k2 + 1 (k 8-15)
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = __fdiv_rn(expf(s[2 * k2 + hf][e] - m[e >> 1]), l[e >> 1]);
        ap[hf * 2] = Tc<TT>::pack(p[0], p[1]);
        ap[hf * 2 + 1] = Tc<TT>::pack(p[2], p[3]);
      }
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t r[4];
        zt_mma::ldmatrix_x4_trans(r, vb + (k2 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                                         dn * 16 + (lane >> 4) * 8);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        Tc<TT>::mma(o[2 * dn], ap, b0);
        Tc<TT>::mma(o[2 * dn + 1], ap, b1);
      }
    }
  }
  __syncthreads();  // the last chunk is read: its stage takes the shares' partials

  // the other shares' P.V join share 0's, in share order
  float* part = reinterpret_cast<float*>(stages);  // [SW - 1][QB][D + 1], copies done
  if (sh > 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* row = part + ((sh - 1) * QB + wr0 + gid + 8 * i) * (D + 1);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        row[n * 8 + tig * 2] = o[n][2 * i];
        row[n * 8 + tig * 2 + 1] = o[n][2 * i + 1];
      }
    }
  }
  __syncthreads();
  if (sh > 0) return;
  TQ* out = static_cast<TQ*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + wr0 + gid + 8 * i;
    if (r >= R) continue;
    TQ* dst = out + (((size_t)b * a.T + r / G) * a.Hq + h * G + r % G) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      float y0 = o[n][2 * i], y1 = o[n][2 * i + 1];
#pragma unroll
      for (int w = 0; w < kSlotWarps - 1; ++w) {
        const float* row = part + (w * QB + wr0 + gid + 8 * i) * (D + 1);
        y0 += row[n * 8 + tig * 2];
        y1 += row[n * 8 + tig * 2 + 1];
      }
      dst[n * 8 + tig * 2] = zt_attn::from_f<TQ>(y0);
      dst[n * 8 + tig * 2 + 1] = zt_attn::from_f<TQ>(y1);
    }
  }
}

// One launch: grid (B * Hkv * ceil(T * G / QB)), kThreads threads.
template <typename TQ, typename TKV, int D>
int launch_mma_d(const ContigKV<TKV>& kv, const zt_mma::Params& a, cudaStream_t stream) {
  constexpr size_t shmem = zt_mma::Layout<TQ, TKV, D, kChOf<D>, false>::bytes;
  static_assert(shmem + 1024 <= 232448, "K6's shared memory");
  auto kern = flash_mma_kernel<TQ, TKV, D>;
  static bool attr_set = false;  // once per instantiation, not inside graph captures
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int nrb = (a.T * (a.Hq / a.Hkv) + QB - 1) / QB;
  kern<<<a.B * a.Hkv * nrb, zt_mma::kThreads, shmem, stream>>>(kv, a);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int launch_mma(int D, const void* k, const void* v, int Hkv, int S, const zt_mma::Params& a,
               cudaStream_t s) {
  const ContigKV<TKV> kv{static_cast<const TKV*>(k), static_cast<const TKV*>(v), Hkv, S, D};
  if (D == 64) return launch_mma_d<TQ, TKV, 64>(kv, a, s);
  if (D == 128) return launch_mma_d<TQ, TKV, 128>(kv, a, s);
  if (D == 256) return launch_mma_d<TQ, TKV, 256>(kv, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The tensor-core form: bf16 (kv_dtype 1) or f16 (kv_dtype 3) K/V, q 0 =
// float32 or 1 = bfloat16; shapes as zt_flash_attention.
extern "C" int zt_flash_attention_mma(const void* q, int q_dtype, const void* k, const void* v,
                                      int kv_dtype, const int* pos0, const float* sinks,
                                      void* out, int B, int T, int Hq, int Hkv, int S, int D,
                                      float scale, float softcap, int window, void* stream) {
  if (Hq % Hkv != 0 || T <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const zt_mma::Params a{q, out, pos0, sinks, B, T, Hq, Hkv, S, D > 128 ? 64 : 128, scale,
                         softcap, window};
#define ZT_ARGS D, k, v, Hkv, S, a, s
  if (q_dtype == 0 && kv_dtype == 1) return launch_mma<float, bf16>(ZT_ARGS);
  if (q_dtype == 1 && kv_dtype == 1) return launch_mma<bf16, bf16>(ZT_ARGS);
  if (q_dtype == 0 && kv_dtype == 3) return launch_mma<float, __half>(ZT_ARGS);
  if (q_dtype == 1 && kv_dtype == 3) return launch_mma<bf16, __half>(ZT_ARGS);
#undef ZT_ARGS
  return (int)cudaErrorInvalidValue;
}

// The CUDA-core tile loop (attn_tile.cuh): f32 K/V only (kv_dtype must be
// 0).  dtype codes: 0 = float32, 1 = bfloat16.  sinks may be null.
extern "C" int zt_flash_attention(const void* q, int q_dtype, const void* k, const void* v,
                                  int kv_dtype, const int* pos0, const float* sinks, void* out,
                                  int B, int T, int Hq, int Hkv, int S, int D, float scale,
                                  float softcap, int window, void* stream) {
  if (Hq % Hkv != 0 || T <= 0 || kv_dtype != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ZT_ARGS D, q, k, v, pos0, sinks, out, B, T, Hq, Hkv, S, scale, softcap, window, s
  if (q_dtype == 0) return launch_tile<float>(ZT_ARGS);
  if (q_dtype == 1) return launch_tile<bf16>(ZT_ARGS);
#undef ZT_ARGS
  return (int)cudaErrorInvalidValue;
}
