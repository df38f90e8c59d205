// The one-pass multi-token attention loop on the tensor cores, shared by
// K10 (paged_attn.cu, bf16 or f16 pools read through a page table) and K7's
// multi-row form (attn_blockwise.cu, bf16 K/V or int8 codes with f32
// scales, T * G > 32 query rows a kv head).  They differ in where a chunk of
// K/V rows lives, which the KV addressor answers as attn_tile.cuh's do:
// `k_rows(b, h, s0)` / `v_rows(b, h, s0)` point at the row of slot s0, and
// the CH rows from s0 on are contiguous; an addressor with `kScales` (int8
// codes) also gives `k_scales` / `v_scales(b, h, s0)`, the f32 scale of
// each row from s0 on.  K6's bf16 K/V take a two-pass loop of their own
// (flash_attn.cu: the row's final max and sum before any probability is
// rounded) built from this file's layout and helpers; attn_tile.cuh's
// CUDA-core loop stays for K6's f32 K/V and K10's f32 pools.
//
// Queries q[B, T, Hq, D] (f32 or bf16) at consecutive positions
// pos0[b] + t attend slots 0 .. S-1 that are <= pos (and > pos - window),
// with optional logit softcap; f32 scores, the finite NEG_INF of zllm's
// kernels for masked ones, and zllm's online softmax (m = max(m, chunk
// max), alpha = exp(m - m'), l = l * alpha + sum(p), acc = acc * alpha +
// P.V, acc / l at the end).  Two forms, by kPage:
//   * K10 (kPage, zllm `_paged_attn_kernel`): the running max advances once
//     a page of ps slots (ps a multiple of CH); p = exp(s - m) is rounded to
//     the pool dtype (bf16 or f16) before P.V, l sums the unrounded p.  A page of
//     CH slots is scored once, its scores held in registers; a larger page
//     is walked twice, once for its max, once for P.V.  The rounding points
//     are the plain version's (`ops/attention.py::paged_online_plain`).
//   * K7 (zllm `_attnb_kernel`): the max advances a chunk of CH = 128
//     slots (64 at D 256); K's scale multiplies the score, V's the
//     probability, which is never rounded: p * vs is split into three bf16
//     parts and P.V is three products.  Sink logits join at the end.  At D
//     256 the two warps of a row group split the output columns (128 each)
//     and each scores every slot of a chunk (kSplitD), rather than each
//     taking half the slots for all 256 columns: that accumulator, beside
//     p's and q's three parts, spilled past 255 registers.
//
// Tensor cores without rounding the reference's f32 operands: K's int8
// codes and bf16 K/V are exact in bf16, and an f32 x is split into three
// bf16 parts, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid),
// whose sum is x to 2^-24: S = (q_hi + q_mid + q_lo).K on mma.sync
// m16n8k16 bf16 with f32 accumulators keeps zllm's f32 scores.  Two parts
// (16 bits) are not enough: with them the server's greedy tokens parted
// between a mixed step (this loop) and a decode step (K7's split form,
// f32 on the CUDA cores).  A bf16 q is one part.
//
// f16 pools (K10's f16 form) run the same loop on f16 x f16 mma.sync (the
// bf16 rate): K and V are exact in f16, and so is p, rounded to f16 as zllm
// rounds it (one part).  q cannot be split as above: f16's 5-bit exponent
// overflows above 65504, and the mid and lo parts of a small element fall
// below f16's normal range.  Of the two designs that keep the f32 scores
// (each q row scaled by a power of two before an f16 split, or K taken as
// two bf16 parts against q's bf16 split, twice the score MMAs), this loop
// takes the first: `zt::f16_row_exp` brings each query row's largest |q|
// into [2^14, 2^15), the row is split into three f16 parts (f32 q) or one
// (bf16 q: exact in f16 once normal), and the row's 2^-e joins the score's
// scale on the f32 accumulator, exactly.  It costs one more pass over the
// block's q rows and two barriers a block, no MMA.
//
// Bound on the H100: 4 * Hq * D FLOPs per visible (query, slot) pair over
// the 989 TFLOP/s bf16 peak, or the bytes of the slots each row sees plus
// q/out over 3.35 TB/s.  Design: a block takes 32 query rows of one (row
// b, kv head), rows t-major and group-minor, in two row groups of 16, each
// served by two warps that take one half of every chunk's slots; the
// halves swap their row maxima through shared memory, so both keep the one
// running max zllm keeps, and their acc and l are added at the end (the
// critical path, the idle row's blocks, runs two warps where one would walk
// every slot).  The block keeps q's parts in shared memory (ldmatrix per
// k-step) and streams the K/V chunks of its band through a two-stage shared
// ring filled with 16-byte cp.async (int8 chunks converted to bf16 tiles in
// shared memory once they land).  Scores, scale, K scale, softcap, mask
// (skipped for a half every row sees whole), the online max and sum (quad
// shuffles) and the probabilities stay in the accumulator registers, which
// are the A operand of P.V; V comes through ldmatrix.trans.  Chunks outside
// the block's causal/window band are skipped.  Blocks are ordered so that
// the rows with the most slots to read, above all the engine's idle row at
// pos0 >= horizon, start first.  What sets the pace on the card is not the
// MMA issue but the work on each fragment element (scale, mask, exp, the
// splits) and the barriers of every chunk: the mask and the softcap run
// only where needed, each under a uniform branch, and int8 codes become
// bf16 by byte permutes and one f32 add, not by the quarter-rate
// conversion instructions.

#pragma once

#include <type_traits>

#include "attn_tile.cuh"
#include "mma_ptx.cuh"

namespace zt_mma {

using zt::cp_async16;
using zt::cp_async_commit;
using zt::cp_async_wait_all;
using zt::ldmatrix_x4;
using zt::Tc;

constexpr int kRowWarps = 2;   // row groups of 16 query rows a block
constexpr int kSlotWarps = 2;  // warps a row group, each a share of every chunk's slots
constexpr int QB = 16 * kRowWarps;                  // query rows a block
constexpr int kThreads = 32 * kRowWarps * kSlotWarps;
constexpr float kNegInf = -2.4e38f;  // zllm's NEG_INF

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem_row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

template <typename T> struct IsF32 { static constexpr bool value = false; };
template <> struct IsF32<float> { static constexpr bool value = true; };
template <typename T> struct IsF16 { static constexpr bool value = false; };
template <> struct IsF16<__half> { static constexpr bool value = true; };
// the tensor cores' operand type for K/V of type TKV: f16 for f16 K/V, bf16
// for bf16 K/V and int8 codes (exact in bf16)
template <typename TKV>
using TcOf = typename std::conditional<IsF16<TKV>::value, __half, __nv_bfloat16>::type;

struct Params {
  const void* q;
  void* out;
  const int* pos0;
  const float* sinks;  // [Hq] or null (K7 only)
  int B, T, Hq, Hkv, S, ps;
  float scale, softcap;
  int window;
};

// shared memory of one instantiation, in bytes
template <typename TQ, typename TKV, int D, int CH, bool kScales>
struct Layout {
  static constexpr int QS = D + 8;                   // row stride of q and the bf16 tiles
  static constexpr int RS = D + 16 / sizeof(TKV);    // row stride of a staged chunk
  static constexpr int NQ = IsF32<TQ>::value ? 3 : 1;  // bf16 parts of q
  static constexpr bool kConvert = sizeof(TKV) == 1; // int8 chunks -> bf16 tiles
  static constexpr size_t q_bytes = (size_t)QB * QS * 2 * NQ;
  static constexpr size_t tile_bytes = (size_t)CH * RS * sizeof(TKV);
  static constexpr size_t stage_bytes = 2 * tile_bytes + (kScales ? 2 * CH * 4 : 0);
  static constexpr size_t work_bytes = kConvert ? 2 * (size_t)CH * QS * 2 : 0;
  static constexpr size_t bytes = q_bytes + 2 * stage_bytes + work_bytes;
};

// (a, b) as N packed pairs of T (bf16 or f16) whose sum is (a, b): hi,
// then (N = 3) mid and lo of the remainders, each subtraction exact in f32
// (for f16, where the values are in f16's range: see zt::f16_row_exp)
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& mid,
                                           uint32_t& lo) {
  hi = Tc<T>::pack(a, b);
  if constexpr (N > 1) {
    const float2 h = Tc<T>::unpack(hi);
    a -= h.x;
    b -= h.y;
    mid = Tc<T>::pack(a, b);
    const float2 m = Tc<T>::unpack(mid);
    lo = Tc<T>::pack(a - m.x, b - m.y);
  }
}

// four int8 codes (a 32-bit word) as two packed bf16 pairs, exactly, on
// the integer and f32 pipes: code c is the f32 whose bits are 2^23 +
// (c + 128), less 2^23 + 128, and an integer of 8 bits is the upper half of
// its f32 (I2F and F2F run at a quarter of the rate)
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// slots a row of q sees, the measure by which blocks are ordered
__device__ __forceinline__ int row_span(const Params& a, int b) {
  const int p0 = a.pos0[b];
  const int hi = min(p0 + a.T - 1, a.S - 1);
  const int lo = a.window > 0 ? max(0, p0 - a.window + 1) : 0;
  return hi - lo;
}

// This block's row block rb and kv head h, and (into the shared *b_sel,
// read after a barrier) its row b: rows by their span, longest first (ties
// by index), so the rows with the most slots to read start first; within
// a row the later (longer) row blocks first.
__device__ __forceinline__ void order_block(const Params& a, int nrb, int& rb, int& h,
                                            int* b_sel) {
  const int per_row = a.Hkv * nrb;
  const int rank = blockIdx.x / per_row, rem = blockIdx.x % per_row;
  rb = nrb - 1 - rem / a.Hkv;
  h = rem % a.Hkv;
  for (int bb = threadIdx.x; bb < a.B; bb += kThreads) {
    const int wb = row_span(a, bb);
    int k = 0;
    for (int o = 0; o < a.B; ++o) {
      const int wo = row_span(a, o);
      k += (wo > wb) || (wo == wb && o < bb);
    }
    if (k == rank) *b_sel = bb;
  }
}

// Query rows r0 .. r0 + QB - 1 of (row b, kv head h) -> shared qs
// [NQ][QB][QS], as NQ parts of the tensor-core type TT (zeros past the R =
// T * G rows).  For f16 (TT = __half) each row is first scaled by its 2^e
// (zt::f16_row_exp; `amax` [QB] scratch), and `unscale` [QB] gets 2^-e;
// the f16 form ends with a barrier, so the caller may read `unscale`.
template <typename TQ, typename TT, int D, int NQ, int QS>
__device__ __forceinline__ void stage_q(const Params& a, int b, int h, int r0, TT* qs,
                                        unsigned* amax, float* unscale) {
  const TQ* q = static_cast<const TQ*>(a.q);
  const int G = a.Hq / a.Hkv, R = a.T * G;
  constexpr bool kF16 = IsF16<TT>::value;
  auto load = [&](int e, float (&x)[4]) {
    const int rr = e / (D / 4), dd = (e % (D / 4)) * 4, r = r0 + rr;
    if (r < R) {
      const TQ* src = q + (((size_t)b * a.T + r / G) * a.Hq + h * G + r % G) * D + dd;
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = zt_attn::to_f(src[i]);
    }
  };
  if constexpr (kF16) {  // each row's largest |q| (non-negative floats order as their bits)
    for (int r = threadIdx.x; r < QB; r += kThreads) amax[r] = 0u;
    __syncthreads();
    for (int e = threadIdx.x; e < QB * D / 4; e += kThreads) {
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      load(e, x);
      const float m = fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])), fmaxf(fabsf(x[2]), fabsf(x[3])));
      atomicMax(amax + e / (D / 4), __float_as_uint(m));
    }
    __syncthreads();
    for (int r = threadIdx.x; r < QB; r += kThreads)
      unscale[r] = zt::pow2(-zt::f16_row_exp(__uint_as_float(amax[r])));
  }
  for (int e = threadIdx.x; e < QB * D / 4; e += kThreads) {
    const int rr = e / (D / 4), dd = (e % (D / 4)) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    load(e, x);
    if constexpr (kF16) {
      const float up = zt::pow2(zt::f16_row_exp(__uint_as_float(amax[rr])));
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] *= up;
    }
    uint32_t pk[3][2];
    split_pair<NQ, TT>(x[0], x[1], pk[0][0], pk[1][0], pk[2][0]);
    split_pair<NQ, TT>(x[2], x[3], pk[0][1], pk[1][1], pk[2][1]);
#pragma unroll
    for (int part = 0; part < NQ; ++part)
      *reinterpret_cast<uint2*>(qs + (part * QB + rr) * QS + dd) =
          make_uint2(pk[part][0], pk[part][1]);
  }
  if constexpr (kF16) __syncthreads();  // unscale
}

// A warp's scores of NT * 8 slots of a chunk: s[n] (zeroed here) the 16x8
// accumulator of the rows wr0 .. wr0 + 15 and the K rows 8n .. 8n + 7 of
// kb (row stride QS), over the NQ parts of q in shared qs; TT the
// tensor-core type (bf16, or f16 for f16 K)
template <int NQ, int NT, int D, int QS, typename TT = __nv_bfloat16>
__device__ __forceinline__ void chunk_scores(float (&s)[NT][4], const TT* qs, const TT* kb,
                                             int wr0, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t aq[NQ][4];
#pragma unroll
    for (int part = 0; part < NQ; ++part)
      ldmatrix_x4(aq[part], qs + (part * QB + wr0 + (lane & 15)) * QS + kk * 16 +
                                (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t r[4];
      ldmatrix_x4(r, kb + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * QS + kk * 16 +
                         ((lane >> 3) & 1) * 8);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
#pragma unroll
      for (int part = 0; part < NQ; ++part) {
        Tc<TT>::mma(s[2 * np], aq[part], b0);
        Tc<TT>::mma(s[2 * np + 1], aq[part], b1);
      }
    }
  }
}

// Softcap, then the mask (zllm's finite NEG_INF), skipped when `full` (every
// slot of the half inside every row's band), each a loop of its own under a
// uniform branch, so that a chunk without softcap or mask runs none of
// their code.  Slot c0 + 8n + 2 tig + (e & 1) of row i = e >> 1 (position
// qp[i], valid rv[i]).
template <int NT>
__device__ __forceinline__ void cap_and_mask(float (&s)[NT][4], const Params& a, bool full,
                                             int c0, int tig, const bool* rv, const int* qp) {
  if (a.softcap > 0.f) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = tanhf(s[n][e] / a.softcap) * a.softcap;
  }
  if (!full) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = c0 + n * 8 + tig * 2 + (e & 1);
        const bool ok = rv[i] && col < a.S && col <= qp[i] &&
                        (a.window <= 0 || col > qp[i] - a.window);
        s[n][e] = ok ? s[n][e] : kNegInf;
      }
  }
}

// Two blocks an SM (shared memory holds no more at D 64): the bound leaves
// ptxas up to 255 registers a thread, where without it it capped the D 128,
// 128-slot K10 form at 168 and spilled.
template <typename TQ, typename TKV, int D, int CH, bool kPage, typename KV>
__global__ void __launch_bounds__(kThreads, 2) attn_mma_kernel(const KV kv, const Params a) {
  using L = Layout<TQ, TKV, D, CH, KV::kScales>;
  constexpr int QS = L::QS, RS = L::RS;
  // K7 at D 256 (kSplitD): the warps of a row group split the output
  // columns, each scoring every slot of the chunk (twice the score MMAs),
  // not the slots: an f32 accumulator of all 256 columns (128 registers a
  // thread) beside three parts of p and q spilled past 255 registers
  constexpr bool kSplitD = !kPage && D > 128;
  constexpr int DV = kSplitD ? D / kSlotWarps : D;  // output columns a warp
  constexpr int ND = DV / 8;
  // a warp's slots of a chunk, n-tiles of 8
  constexpr int HC = kSplitD ? CH : CH / kSlotWarps, NT = HC / 8;
  static_assert(HC % 16 == 0 && D % 16 == 0 && DV % 16 == 0, "shapes");
  static_assert((size_t)(kSlotWarps - 1) * QB * (D + 1) * 4 <= 2 * L::stage_bytes, "combine");
  static_assert(!(kPage && KV::kScales), "K10 takes no scales");
  // f16 K/V: K10's form (K7's would need its unrounded p scaled before an
  // f16 split, as decode_cluster.cuh does)
  static_assert(kPage || !IsF16<TKV>::value, "f16 K/V in K10 only");
  using TT = TcOf<TKV>;  // the tensor cores' operand type
  constexpr bool kF16 = IsF16<TT>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  TT* qs = reinterpret_cast<TT*>(smem);  // [NQ][QB][QS]
  unsigned char* stages = smem + L::q_bytes;
  __nv_bfloat16* work = reinterpret_cast<__nv_bfloat16*>(stages + 2 * L::stage_bytes);
  __shared__ int b_sel;
  __shared__ float xm[kSlotWarps][QB];  // each share's row maxima of a chunk
  __shared__ unsigned q_amax[kF16 ? QB : 1];   // f16: each q row's largest |q|,
  __shared__ float q_unscale[kF16 ? QB : 1];   // and its 2^-e

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = warp / kSlotWarps, sh = warp % kSlotWarps;  // row group, share of a chunk
  const int G = a.Hq / a.Hkv, R = a.T * G, nrb = (R + QB - 1) / QB;

  int rb, h;
  order_block(a, nrb, rb, h, &b_sel);
  const int r0 = rb * QB, r_end = min(r0 + QB, R);
  __syncthreads();  // b_sel
  const int b = b_sel;
  stage_q<TQ, TT, D, L::NQ, QS>(a, b, h, r0, qs, q_amax, q_unscale);
  const int p0 = a.pos0[b];

  // the block's band of slots, walked in visits of CH slots: a page of ps
  // (K7: ps = CH) once, or twice (max, then P.V) when ps > CH
  const int qp_min = p0 + r0 / G, qp_max = p0 + (r_end - 1) / G;
  const int col_hi = min(qp_max, a.S - 1);
  const int col_lo = a.window > 0 ? max(0, qp_min - a.window + 1) : 0;
  const int ps = kPage ? a.ps : CH;
  const int nc = ps / CH;
  const bool two = nc > 1;
  const int vpp = two ? 2 * nc : 1;
  const int pg_lo = col_lo / ps;
  const int nv = col_lo <= col_hi ? (col_hi / ps - pg_lo + 1) * vpp : 0;

  auto issue = [&](int v) {
    const int w = v % vpp, phase = two ? w / nc : 1;
    const int s0 = (pg_lo + v / vpp) * ps + (two ? w % nc : 0) * CH;
    TKV* kt = reinterpret_cast<TKV*>(stages + (v & 1) * L::stage_bytes);
    TKV* vt = kt + CH * RS;
    const TKV* kg = kv.k_rows(b, h, s0);
    const TKV* vg = kv.v_rows(b, h, s0);
    constexpr int kPer = 16 / sizeof(TKV), kRowP = D / kPer;
    for (int p = tid; p < CH * kRowP; p += kThreads) {
      const int j = p / kRowP, c = (p % kRowP) * kPer;
      const bool ok = s0 + j < a.S;
      const size_t go = ok ? (size_t)j * D + c : 0;
      cp_async16(kt + j * RS + c, kg + go, ok ? 16 : 0);
      if (phase) cp_async16(vt + j * RS + c, vg + go, ok ? 16 : 0);
    }
    if constexpr (KV::kScales) {
      float* sc = reinterpret_cast<float*>(vt + CH * RS);  // ks [CH], vs [CH]
      const float* kgs = kv.k_scales(b, h, s0);
      const float* vgs = kv.v_scales(b, h, s0);
      for (int j = tid; j < 2 * CH; j += kThreads) {
        const int jj = j % CH;
        const bool ok = s0 + jj < a.S;
        cp_async4(sc + j, (j < CH ? kgs : vgs) + (ok ? jj : 0), ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  // this thread's two rows (gid, gid + 8 of its row group's 16), and the
  // rows of the warp (for the chunks that need no mask)
  const int wr0 = rg * 16, so = kSplitD ? 0 : sh * HC;
  const int dv0 = kSplitD ? sh * DV : 0;  // this warp's first output column
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
  // (exact: a power of two)
  float rsc[2] = {a.scale, a.scale};
  if constexpr (kF16) {
#pragma unroll
    for (int i = 0; i < 2; ++i) rsc[i] = a.scale * q_unscale[wr0 + gid + 8 * i];
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, pm[2] = {kNegInf, kNegInf};
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  if (nv > 0) issue(0);
  for (int v = 0; v < nv; ++v) {
    cp_async_wait_all();
    __syncthreads();  // chunk v has landed; chunk v - 1's stage, tiles and xm are free
    if (v + 1 < nv) issue(v + 1);  // in flight while chunk v computes
    const int w = v % vpp, phase = two ? w / nc : 1;
    const int s0 = (pg_lo + v / vpp) * ps + (two ? w % nc : 0) * CH;
    const unsigned char* sb = stages + (v & 1) * L::stage_bytes;
    const TT* kb;
    const TT* vb;
    const float* ksc = nullptr;
    const float* vsc = nullptr;
    if constexpr (KV::kScales) {
      ksc = reinterpret_cast<const float*>(sb + 2 * L::tile_bytes) + so;
      vsc = ksc + CH;
    }
    if constexpr (L::kConvert) {  // int8 chunk -> bf16 tiles (exact)
      const int8_t* src = reinterpret_cast<const int8_t*>(sb);
      constexpr int kRowP = D / 16, kPieces = CH * kRowP;
      for (int p = tid; p < 2 * kPieces; p += kThreads) {
        const int t = p / kPieces, pp = p % kPieces, j = pp / kRowP, c = (pp % kRowP) * 16;
        const uint4 raw = *reinterpret_cast<const uint4*>(src + t * CH * RS + j * RS + c);
        const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t pk[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) i8x4_to_bf16(wd[i], pk[2 * i], pk[2 * i + 1]);
        uint4* dst = reinterpret_cast<uint4*>(work + t * CH * QS + j * QS + c);
        dst[0] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
        dst[1] = make_uint4(pk[4], pk[5], pk[6], pk[7]);
      }
      __syncthreads();
      kb = work + so * QS;
      vb = work + (CH + so) * QS;
    } else {
      kb = reinterpret_cast<const TT*>(sb) + so * RS;
      vb = reinterpret_cast<const TT*>(sb) + (CH + so) * RS;
    }

    // scores of this warp's half: s[n] the 16x8 accumulator of slots
    // s0 + so + 8n .. +7
    float s[NT][4];
    chunk_scores<L::NQ, NT, D, QS, TT>(s, qs, kb, wr0, lane);
    // scale, K scale, softcap, mask (only where some slot of the half is
    // outside some row's band); the half's row max
    const int c0 = s0 + so;
    const bool full = rows_full && c0 + HC <= a.S && c0 + HC - 1 <= wqp_lo &&
                      (a.window <= 0 || c0 > wqp_hi - a.window);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x;
        if constexpr (kF16) {
          x = s[n][e] * rsc[e >> 1];
        } else {
          x = s[n][e] * a.scale;
        }
        if constexpr (KV::kScales) x *= ksc[n * 8 + tig * 2 + (e & 1)];
        s[n][e] = x;
      }
    cap_and_mask<NT>(s, a, full, c0, tig, rv, qp);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    // the running max advances once a page (two-pass: after its max pass),
    // over both halves of the chunk
    if (!two || phase == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        if (tig == 0) xm[sh][wr0 + gid + 8 * i] = mx[i];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int o2 = 1; o2 < kSlotWarps; ++o2)
          mx[i] = fmaxf(mx[i], xm[(sh + o2) % kSlotWarps][wr0 + gid + 8 * i]);
      bool advance = true;
      if (two) {
#pragma unroll
        for (int i = 0; i < 2; ++i) pm[i] = (w == 0) ? mx[i] : fmaxf(pm[i], mx[i]);
        advance = w == nc - 1;
#pragma unroll
        for (int i = 0; i < 2; ++i) mx[i] = pm[i];
      }
      if (advance) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float m_new = fmaxf(m[i], mx[i]);
          const float alpha = expf(m[i] - m_new);
          m[i] = m_new;
          l[i] *= alpha;
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            o[n][2 * i] *= alpha;
            o[n][2 * i + 1] *= alpha;
          }
        }
      }
    }
    if (!two || phase == 1) {
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[n][e] - m[e >> 1]);
          ls[e >> 1] += p;
          s[n][e] = p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ls[i] += __shfl_xor_sync(0xffffffffu, ls[i], 1);
        ls[i] += __shfl_xor_sync(0xffffffffu, ls[i], 2);
        l[i] += ls[i];
      }
      // P.V: the probabilities of 16 slots are the A fragment of a k-step:
      // a0 (row gid, k 0-7), a1 (row gid+8, k 0-7), a2 (row gid, k 8-15),
      // a3 (row gid+8, k 8-15); K10 one part (p rounded to the pool
      // dtype, bf16 or f16), K7 three (p * vs unrounded)
      constexpr int NP = kPage ? 1 : 3;
#pragma unroll
      for (int k2 = 0; k2 < HC / 16; ++k2) {
        uint32_t ap[3][4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {  // n-tiles 2 k2 (k 0-7), 2 k2 + 1 (k 8-15)
          float x[4] = {s[2 * k2 + hf][0], s[2 * k2 + hf][1], s[2 * k2 + hf][2],
                        s[2 * k2 + hf][3]};
          if constexpr (KV::kScales) {
            const int jj = (2 * k2 + hf) * 8 + tig * 2;
            const float v0 = vsc[jj], v1 = vsc[jj + 1];
            x[0] *= v0;
            x[1] *= v1;
            x[2] *= v0;
            x[3] *= v1;
          }
          split_pair<NP, TT>(x[0], x[1], ap[0][hf * 2], ap[1][hf * 2], ap[2][hf * 2]);
          split_pair<NP, TT>(x[2], x[3], ap[0][hf * 2 + 1], ap[1][hf * 2 + 1],
                             ap[2][hf * 2 + 1]);
        }
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, vb + (k2 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * QS +
                                   dv0 + dn * 16 + (lane >> 4) * 8);
          const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
#pragma unroll
          for (int part = 0; part < NP; ++part) {
            Tc<TT>::mma(o[2 * dn], ap[part], b0);
            Tc<TT>::mma(o[2 * dn + 1], ap[part], b1);
          }
        }
      }
    }
  }
  __syncthreads();  // the last chunk is read: its stage takes the shares' partials

  // the other shares' acc and l join share 0's (the running max is the
  // same in all), then sinks (K7) and acc / l; kSplitD: each warp holds
  // its columns' whole sums and writes them
  float* part = reinterpret_cast<float*>(stages);  // [SW - 1][QB][D + 1], copies done
  if (!kSplitD && sh > 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* row = part + ((sh - 1) * QB + wr0 + gid + 8 * i) * (D + 1);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        row[n * 8 + tig * 2] = o[n][2 * i];
        row[n * 8 + tig * 2 + 1] = o[n][2 * i + 1];
      }
      if (tig == 0) row[D] = l[i];
    }
  }
  __syncthreads();
  if (!kSplitD && sh > 0) return;
  TQ* out = static_cast<TQ*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + wr0 + gid + 8 * i;
    if (r >= R) continue;
    float li = l[i], acc[ND][2];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] = o[n][2 * i];
      acc[n][1] = o[n][2 * i + 1];
    }
#pragma unroll
    for (int o2 = 0; o2 < (kSplitD ? 0 : kSlotWarps - 1); ++o2) {
      const float* row = part + (o2 * QB + wr0 + gid + 8 * i) * (D + 1);
      li += row[D];
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] += row[n * 8 + tig * 2];
        acc[n][1] += row[n * 8 + tig * 2 + 1];
      }
    }
    const int t = r / G, head = h * G + r % G;
    float rs = 1.f;
    if (!kPage && a.sinks != nullptr) {
      const float sk = a.sinks[head];
      const float mf = fmaxf(m[i], sk);
      rs = expf(m[i] - mf);
      li = li * rs + expf(sk - mf);
    }
    TQ* dst = out + (((size_t)b * a.T + t) * a.Hq + head) * D + dv0;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int d = n * 8 + tig * 2;
      const float y0 = acc[n][0] * rs, y1 = acc[n][1] * rs;
      dst[d] = zt_attn::from_f<TQ>(li > 0.f ? y0 / li : 0.f);
      dst[d + 1] = zt_attn::from_f<TQ>(li > 0.f ? y1 / li : 0.f);
    }
  }
}

// One launch: grid (B * Hkv * ceil(T * G / QB)), kThreads threads.
template <typename TQ, typename TKV, int D, int CH, bool kPage, typename KV>
int launch_mma(const KV& kv, const Params& a, cudaStream_t stream) {
  constexpr size_t shmem = Layout<TQ, TKV, D, CH, KV::kScales>::bytes;
  static_assert(shmem + 1024 <= 232448, "the loop's shared memory");
  auto kern = attn_mma_kernel<TQ, TKV, D, CH, kPage, KV>;
  static bool attr_set = false;  // once per instantiation, not inside graph captures
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int nrb = (a.T * (a.Hq / a.Hkv) + QB - 1) / QB;
  kern<<<a.B * a.Hkv * nrb, kThreads, shmem, stream>>>(kv, a);
  return (int)cudaGetLastError();
}

}  // namespace zt_mma
