// The one-launch decode step shared by K7's split form (attn_blockwise.cu,
// a contiguous cache of bf16 K/V or int8 codes with f32 scales), K8
// (attn_decode_update.cu, a contiguous f32, bf16 or f16 cache with the
// insert of the new K/V row) and K9 (paged_decode.cu, f32, bf16 or f16 page
// pools read through a page table, with the insert): flash-decoding as ONE
// thread-block-cluster launch.
//
// Queries: R = T * G rows of one (row b, kv head h), row r = t * G + g at
// position pos[b] + t (K8, K9: T = 1), taken 8 at a time (RM), each group
// of 8 its own cluster.  Slots <= the row's position (and > position -
// window) are seen; scores are f32 (q . k) * scale (times K's scale for
// int8 K), logit softcap.  The users differ in where chunk j of (b, h)
// lives (the addressor's `base`), in the insert slot (`insert_slot`) and
// in the softmax's rounding point (`kRound`):
//   * K7 (kRoundNone, zllm's `_attnb_kernel`): p = exp(s - M) unrounded,
//     M the row's max, times V's scale for int8 V; out = (sum p.V) / l,
//     l = sum exp(s - M), with the sink logit in M and l when given;
//   * K8 (kRoundNorm, zllm's `_attn_decode_kernel`): p = exp(s - M) / l
//     (IEEE division) rounded to the cache dtype, l the row's f32
//     denominator, which every block reads from its peers' chunk
//     statistics in one order (so all hold the same bits); out = sum p.V;
//   * K9 (kRoundPage, zllm's `_paged_decode_kernel`, an online softmax a
//     page a grid step): p = exp(s - M_j) rounded to the pool dtype, M_j the
//     running max after page j (the max of the chunk maxima of the row's
//     chunks up to j), each chunk's P.V rescaled by exp(M_j - M) (folded
//     into its rounded p, in f32), and one division by the f32
//     denominator l at the end.
//
// Bound on the H100: the bytes of the slots each row sees, 2 * (visible
// slots) * (D * sizeof(K/V) + scales) a (row, kv head), over 3.35 TB/s; the
// work is ~4 FLOPs a byte, so a serve decode step (~1.4-2.7 MB a layer) is
// ~10 us of bytes.  What paces the old split launches was latency, not
// bytes: 2-3 dependent launches, scores and partials round-tripped through
// a global scratch, and the trash row's 16-17 chunks walked by one chain.
//
// Design.  Grid (NB, Hkv * ceil(R / RM), B), cluster (NB, 1, 1): one
// cluster of NB = 8 blocks (the portable cluster size) serves one (row,
// kv head, group of 8 query rows).  The 128-slot chunks (K9: the pages) of
// the span [lo, hi] are dealt to the cluster's blocks in contiguous runs of
// ceil(n / NB): the rule reads only the span and S, never B or another row,
// so a row's bits are the same alone, in a batch, in a decode step and on
// column 0 of a mixed step.  The trash row's 16-17 chunks become <= 3 a
// block, and a live row's chunks run on separate SMs.  A block is 8 warps,
// two blocks an SM at the serve shapes (a cluster's 8 blocks must fit one
// GPC: at one block an SM a serve step's 16 clusters ran as if in two
// waves).
//   * Loads: each block streams its chunks' K rows (then V rows), with the
//     int8 codes' scales, through a ring of NBUF <= 5 chunk buffers by
//     16-byte cp.async; NBUF - 1 are in flight from entry (all K and the
//     first V at the serve shapes; the rest are asked for as phase 1 frees
//     buffers), so V's latency hides behind the score phase; a deeper ring
//     only lengthened the prologue (the copies' issue stalls).  Rows are
//     padded by 16 bytes (no bank conflicts).  q is loaded before anything
//     waits on the row's position.
//   * Phase 1: scores in f32, kept in shared memory (no global scratch);
//     each chunk's max and sum of exp beside them.  bf16 K and int8 codes
//     (exact in bf16) take mma.sync m16n8k16, a warp a tile of 16 slots (M)
//     against the 8 query rows (N), q split into three bf16 parts (one for
//     a bf16 q) so the products keep f32's precision, as attn_mma.cuh does;
//     f32 K (K9's f32 pools) f32 FMAs, a thread a slot.  At ~4 FLOPs a byte
//     the products are not the bound: with 4 warps the FMA form and the
//     tensor-core forms took the same time; the tensor cores free the
//     registers that let 8 warps run two blocks an SM, and each q part
//     keeps its own accumulator so the MMA chains stay short.
//   * cluster.sync(), then every block reads the chunk statistics of its
//     peers through distributed shared memory (map_shared_rank): the row's
//     max M (K9: also the prefix maxima M_j of its own chunks; block 0, and
//     for K8 every block, also the denominator l).
//   * Phase 2: probabilities in place of the scores, then P.V, in f32: bf16
//     and int8 V on the tensor cores as (P.V)^T = V^T P^T (D as M, the 8
//     rows as N, a warp's 16 slots as K, p in three bf16 parts, K8's
//     rounded p in one; slots outside the staged rows read as 0), f32 V on
//     the CUDA cores; summed per warp in chunk order, then over the warps
//     in order.
//   * f16 pools and caches (K9's and K8's f16 forms, `--kv-type f16`): both
//     phases on f16 x f16 mma.sync (the bf16 rate), K and V exact in f16.
//     An f32 or bf16 q would overflow or lose its small parts in an f16
//     split, so each query row is first scaled by the power of two that
//     brings its largest |q| into [2^14, 2^15) (zt::f16_row_exp; three f16
//     parts, or one for a bf16 q), and its 2^-e joins the score's scale,
//     exactly.  K9's p =
//     round_f16(exp(s - M_j)) * exp(M_j - M) is at most 1 and is not one
//     f16 value: it is scaled by 2^15 before its three-part f16 split (so
//     its small parts stay normal) and P.V by 2^-15 after, exactly; K8's
//     normalized p is rounded to f16 and so is one exact f16 part.
//   * cluster.sync(), then block 0 sums the blocks' partials over DSMEM in
//     block order (= chunk order, the runs being contiguous), adds the sinks
//     (K7), divides by l (K7, K9) and writes the output; a last
//     cluster.sync() keeps every peer's shared memory alive until block 0
//     has read it.
//   * A span longer than the scores' room (more than kKeepBytes of scores
//     a block, > 16384 slots at chunks of 128) keeps the scores of a
//     block's first `mkeep` chunks and recomputes the rest in phase 2 from
//     a second copy of their K rows (the same code, so the same bits).
//
// Where trouble lies:
//   * No early return: a block without a chunk (a short row's idle blocks,
//     rows past R) still reaches every cluster.sync(), or the launch hangs.
//   * The insert in one launch (K8, K9): no block may use the insert slot's
//     row from the cache (its cp.async copy brings the stale row); the block
//     that owns the insert chunk overwrites that row of its staged K and V
//     with k_new / v_new rounded to the cache dtype.  Only the clusters of
//     query group 0 write the cache (G > 8 runs more groups).  The slot is
//     the addressor's: K9's row at or past the horizon (the engine's trash
//     rows) writes nothing and attends every page; K8's slot is
//     min(pos, S - 1), so its trash row (pos == S) writes slot S - 1 and
//     attends all S.  No other row reads an insert page or chunk.
//   * Dynamic shared memory above 48 KB needs cudaFuncSetAttribute once an
//     instantiation, outside graph capture (to the block's whole 227 KB, so
//     the kernel may declare no static shared memory); the launch is checked with
//     cudaGetLastError(), since a refused cluster launch never runs.
//   * hi = min(last position, S - 1) passes through an opaque register:
//     compiled as written, the card gave wrong scores whenever S was not a
//     multiple of 128 (same data, same memory; PERF.md §7).
//   * Registers: K8's f16 form keeps q's B fragments in shared memory (in
//     registers, its f32-q D 128 form spilled under the 128 registers of two
//     blocks an SM); K9's f16 form keeps them in registers, 3-6 % faster on
//     an H100 (`python -m zllm_torch.decode_cluster_ablation --k9-shared-q`).
//     `-Xptxas -v` must show no spill in any instantiation (q f32/bf16 x
//     K/V int8/bf16, caches or pools f32/bf16/f16 x D 64/128);
//     chip_smoke.py fails on one.

#pragma once

#include <cooperative_groups.h>

#include "attn_mma.cuh"

namespace zt_dc {

namespace cg = cooperative_groups;
using zt::cp_async16;
using zt::cp_async_commit;
using zt::Tc;
using zt_attn::from_f;
using zt_attn::to_f;

constexpr int NB = 8;          // blocks a cluster
constexpr int CH = 128;        // slots a chunk at most (K7: 128; K9: the page size)
constexpr int kThreads = 2 * CH;  // 8 warps: a 16-slot tile each on the tensor cores
constexpr int kWarps = kThreads / 32;
constexpr int RM = 8;          // query rows a cluster
constexpr int kMaxSmem = 232448;            // an H100 block's shared memory
constexpr int kKeepBytes = 64 * 1024;       // room for kept scores a block
constexpr int kRingBytes = 96 * 1024;       // room for the K/V ring a block
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -INFINITY;
constexpr int kPUpExp = 15;  // f16 P.V: p (at most 1) times 2^15 before its f16 split

// where the softmax rounds, an addressor's kRound: K7 never, K9 exp(s - M_j)
// to the pool dtype a page, K8 the normalized p to the cache dtype
enum Round { kRoundNone = 0, kRoundPage = 1, kRoundNorm = 2 };

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(gmem) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// the ring of chunk buffers of one K/V type: a row is padded by 16 bytes
template <typename T, int D>
struct Ring {
  static constexpr int RS = D * (int)sizeof(T) + 16;  // bytes a staged row
  static constexpr int BUF = CH * RS;
  static constexpr int N0 = kRingBytes / BUF;
  static constexpr int N = N0 < 2 ? 2 : (N0 > 5 ? 5 : N0);  // buffers
};

// 4 int8 codes of a word as f32, exactly, by byte permutes and one add each
// (2^23 + (c + 128), less 2^23 + 128) rather than the conversion instructions
__device__ __forceinline__ void codes_f(uint32_t w, float* dst) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    dst[i] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - 8388736.f;
}

struct Params {
  const void* q;       // [B, T, Hq, D]
  void* out;           // like q
  const int* pos;      // [B]: the position of the row's query 0
  const float* sinks;  // [Hq] or null (K7 only)
  int T, Hq, Hkv, S;   // S slots a row
  int cs;              // slots a chunk (K7: 128; K9: the page size)
  int mmax, mkeep;     // own chunks a block at most; of them kept with their scores
  float scale, softcap;
  int window;
};

// q's B fragments in shared memory, built once by warp 0 (else in each
// warp's registers): K8's f16 form (in registers they spilled its f32-q D
// 128 form at two blocks an SM) and every D 256 form (96 registers of an
// f32 q's three parts, beside phase 2's 128 of P.V accumulators)
template <typename TKV, int D, int ROUND>
constexpr bool kQsmOf = (zt_mma::IsF16<TKV>::value && ROUND == kRoundNorm) || D > 128;

// shared memory of one launch, in bytes (the kernel's carve-up, in order)
template <typename TKV, int D, bool kScaled, int ROUND>
size_t smem_bytes(int mmax, int n_slots) {
  using RG = Ring<TKV, D>;
  return sizeof(float) * (size_t)RM * D                     // q
         + (size_t)RG::N * RG::BUF                          // K/V ring
         + (kScaled ? sizeof(float) * RG::N * CH : 0)       // the ring's scales
         + sizeof(float) * (size_t)n_slots * CH * RM        // scores / probabilities
         + sizeof(float2) * (size_t)mmax * RM               // chunk (max, sum of exp)
         + sizeof(float) * (size_t)mmax * RM                // prefix max (K9)
         + sizeof(float) * 2 * RM                           // row max, denominator
         + sizeof(float) * (size_t)RM * D                   // the block's P.V partial
         + sizeof(size_t) * (size_t)mmax                    // own chunks' first rows
         + (zt_mma::IsF16<TKV>::value || kQsmOf<TKV, D, ROUND>  // f16: each q row's 2^e
                ? sizeof(int) * RM
                : 0)
         + (kQsmOf<TKV, D, ROUND> ? sizeof(uint32_t) * D / 16 * 3 * 2 * 32 : 0);  // q's fragments
}

// two blocks an SM where the registers allow it (bf16 / int8 K/V at D 64, the
// serve shapes: a cluster's blocks then fit a GPC in one wave; K8's bf16
// cache at D 128 too, its p one bf16 part: an OLMo-2 step's 16 clusters in
// one wave); one for f32 pools and the other D 128 forms, whose
// accumulators need more than 128 registers a thread
template <typename TKV, int D, int ROUND>
constexpr int kMinBlocks = sizeof(TKV) <= 2 && (D == 64 || ROUND == kRoundNorm) ? 2 : 1;

template <typename TQ, typename TKV, int D, typename KV>
__global__ void __cluster_dims__(NB, 1, 1) __launch_bounds__(kThreads,
                                                             kMinBlocks<TKV, D, KV::kRound>)
    decode_cluster_kernel(const Params p, const KV kv) {
  using RG = Ring<TKV, D>;
  constexpr int RS = RG::RS, NBUF = RG::N;
  constexpr int DPL = D / 32;  // output columns a lane in P.V
  extern __shared__ __align__(16) unsigned char smem[];
  float* qsh = reinterpret_cast<float*>(smem);                      // [RM][D]
  unsigned char* ring = smem + sizeof(float) * RM * D;              // [NBUF][CH][RS]
  float* rsc = reinterpret_cast<float*>(ring + (size_t)NBUF * RG::BUF);  // [NBUF][CH]
  float* sT = rsc + (KV::kScaled ? NBUF * CH : 0);                  // [slots][CH][RM]
  const int n_slots = p.mkeep < p.mmax ? p.mkeep + 1 : p.mmax;
  float2* st = reinterpret_cast<float2*>(sT + (size_t)n_slots * CH * RM);  // [mmax][RM]
  float* mj = reinterpret_cast<float*>(st + (size_t)p.mmax * RM);   // [mmax][RM]
  float* row_m = mj + (size_t)p.mmax * RM;                          // [RM]
  float* row_l = row_m + RM;                                        // [RM]
  float* part = row_l + RM;                                         // [RM][D]
  size_t* bases = reinterpret_cast<size_t*>(part + RM * D);        // [mmax]
  constexpr bool kF16 = zt_mma::IsF16<TKV>::value;
  using TT = zt_mma::TcOf<TKV>;  // the tensor cores' operand type (bf16 for int8 codes)
  // f16: each query row's 2^e (zt::f16_row_exp) [RM]; dynamic, as all of
  // this kernel's shared memory: the attribute asks for the block's whole
  // 227 KB, which leaves no room for static arrays
  int* q_exp = reinterpret_cast<int*>(bases + p.mmax);
  // K8's f16 form: q's B fragments [D/16][NQ][2][32 lanes], built once by
  // warp 0 and read by every warp, and each row's score scale read where it
  // is used (in registers they spilled the f32-q D 128 form at two blocks an
  // SM, 128 registers a thread; K9's f16 form keeps both in registers)
  constexpr bool kQsm = kQsmOf<TKV, D, KV::kRound>;
  uint32_t* qbs = reinterpret_cast<uint32_t*>(q_exp + RM);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.Hq / p.Hkv, R = p.T * G, GC = (R + RM - 1) / RM;
  const int h = blockIdx.y / GC, c = blockIdx.y % GC, b = blockIdx.z;
  const int r0 = c * RM, nr = min(RM, R - r0);  // this cluster's query rows
  // q first: its loads do not wait on the row's position
  constexpr int QPT = RM * D / kThreads;  // q values a thread stages
  float qv[QPT];
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int e = tid + k * kThreads, i = e / D, r = r0 + i;
    qv[k] = i < nr ? to_f(static_cast<const TQ*>(p.q)[(((size_t)b * p.T + r / G) * p.Hq + h * G +
                                                        r % G) * D + e % D])
                   : 0.f;
  }
  const int p0 = p.pos[b], cs = p.cs;
  // the slots some row of the cluster sees: [lo, hi] (hi through an opaque
  // register: see "Where trouble lies" above)
  int hi = min(p0 + (r0 + nr - 1) / G, p.S - 1);
  asm volatile("" : "+r"(hi));
  const int lo = p.window > 0 ? max(p0 + r0 / G - p.window + 1, 0) : 0;
  const int j0 = lo / cs;
  const int n = hi >= lo ? hi / cs - j0 + 1 : 0;  // chunks of the span
  const int per = (n + NB - 1) / NB;              // chunks a block: contiguous runs
  const int my0 = rank * per;                     // the first own chunk, from j0
  const int m = max(0, min(per, n - my0));        // own chunks
  const int nb_used = per > 0 ? (n + per - 1) / per : 0;
  const int kept = min(m, p.mkeep);
  const int n_items = m + kept + 2 * (m - kept);  // K of every chunk, then V (K again if not kept)
  // K8, K9: the insert slot (-1: none) and its chunk
  int pw = -1;
  if constexpr (KV::kInsert) pw = kv.insert_slot(p0, p.S);
  const int jw = pw >= 0 ? pw / cs : -1;

  if constexpr (KV::kInsert) {  // the pool write: query group 0's owner of the insert chunk
    if (c == 0 && jw >= j0 + my0 && jw < j0 + my0 + m) {
      const size_t at = (kv.base(b, h, jw, cs) + pw % cs) * D;
      const size_t nw = ((size_t)b * p.Hkv + h) * D;
      for (int d = tid; d < D; d += kThreads) {
        kv.k_pool[at + d] = from_f<TKV>(to_f(kv.k_new[nw + d]));
        kv.v_pool[at + d] = from_f<TKV>(to_f(kv.v_new[nw + d]));
      }
    }
  }

  // item idx of this block's stream: (own chunk i, V?)
  auto item = [&](int idx, int& i, bool& is_v) {
    if (idx < m) {
      i = idx;
      is_v = false;
    } else if (idx < m + kept) {
      i = idx - m;
      is_v = true;
    } else {
      const int e = idx - m - kept;
      i = kept + e / 2;
      is_v = e % 2;
    }
  };
  // the rows of own chunk i the cluster sees, [a, z] within the chunk
  auto rows_of = [&](int i, int& a, int& z) {
    const int j = j0 + my0 + i;
    a = max(j * cs, lo) - j * cs;
    z = min(j * cs + cs - 1, hi) - j * cs;
  };
  auto issue = [&](int idx) {  // copies of item idx into buffer idx % NBUF, one commit group
    if (idx < n_items) {
      int i, a, z;
      bool is_v;
      item(idx, i, is_v);
      rows_of(i, a, z);
      const size_t base = bases[i];
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>((is_v ? kv.v : kv.k) + base * D);
      unsigned char* dst = ring + (size_t)(idx % NBUF) * RG::BUF;
      constexpr int VPR = D * (int)sizeof(TKV) / 16;  // 16-byte pieces a row
      for (int e = tid; e < (z - a + 1) * VPR; e += kThreads) {
        const int rr = a + e / VPR, v16 = e % VPR;
        cp_async16(dst + rr * RS + v16 * 16, src + (size_t)rr * D * sizeof(TKV) + v16 * 16, 16);
      }
      if constexpr (KV::kScaled) {
        const float* ssrc = (is_v ? kv.vs : kv.ks) + base;
        float* sdst = rsc + (idx % NBUF) * CH;
        if ((reinterpret_cast<uintptr_t>(ssrc + a) & 15) == 0) {  // 16 bytes a copy where aligned
          for (int rr = a + 4 * tid; rr <= z; rr += 4 * kThreads) {
            if (rr + 3 <= z) {
              cp_async16(sdst + rr, ssrc + rr, 16);
            } else {
              for (int r4 = rr; r4 <= z; ++r4) cp_async4(sdst + r4, ssrc + r4);
            }
          }
        } else {
          for (int rr = a + tid; rr <= z; rr += kThreads) cp_async4(sdst + rr, ssrc + rr);
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  int next = 0;  // the next item to consume
  auto acquire = [&]() -> int {  // wait for item `next`, refill the ring, return its buffer
    cp_async_wait<NBUF - 2>();
    __syncthreads();
    issue(next + NBUF - 1);
    return (next++) % NBUF;
  };
  // K8, K9: the insert slot's staged row from k_new / v_new, rounded to the cache dtype
  auto patch = [&](int buf, int i, bool is_v) {
    if constexpr (KV::kInsert) {
      if (j0 + my0 + i == jw) {  // uniform over the block
        TKV* row = reinterpret_cast<TKV*>(ring + (size_t)buf * RG::BUF + (pw % cs) * RS);
        const TQ* src = (is_v ? kv.v_new : kv.k_new) + ((size_t)b * p.Hkv + h) * D;
        for (int d = tid; d < D; d += kThreads) row[d] = from_f<TKV>(to_f(src[d]));
        __syncthreads();
      }
    }
  };
  int qpos[RM];  // each query row's position
#pragma unroll
  for (int r = 0; r < RM; ++r) qpos[r] = p0 + (r0 + r) / G;
  // phase 1 on the tensor cores (bf16 K, int8 codes: exact in bf16): mma.sync
  // m16n8k16 with the chunk's slots as M (a warp two tiles of 16), the 8 query
  // rows as N and D as K; q split into NQ bf16 parts (3 for an f32 q, so the
  // products keep f32's precision; 1 for a bf16 q), its B fragments built once
  constexpr bool kMma = sizeof(TKV) <= 2;
  constexpr int NQ = sizeof(TQ) == 4 ? 3 : 1;
  constexpr int KS = D / 16;
  uint32_t qb[kMma && !kQsm ? KS : 1][NQ][2];
  // f16 (K9): the score scale of this lane's accumulator rows (lane % 4) * 2
  // and + 1, with their rows' 2^-e (set once q_exp is)
  float qrs[2] = {p.scale, p.scale};
  auto build_qb = [&]() {
    if constexpr (kMma) {
      if (kQsm && warp != 0) return;  // fragments in shared memory: built once
      const float* qn = qsh + (lane / 4) * D + (lane % 4) * 2;
      float up = 1.f;
      if constexpr (kF16) up = zt::pow2(q_exp[lane / 4]);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          uint32_t part3[3];
          if constexpr (kF16) {
            zt_mma::split_pair<NQ, TT>(qn[ks * 16 + hf * 8] * up, qn[ks * 16 + hf * 8 + 1] * up,
                                       part3[0], part3[1], part3[2]);
          } else {
            zt_mma::split_pair<NQ>(qn[ks * 16 + hf * 8], qn[ks * 16 + hf * 8 + 1], part3[0],
                                   part3[1], part3[2]);
          }
#pragma unroll
          for (int pt = 0; pt < NQ; ++pt) {
            if constexpr (kQsm) {
              qbs[((ks * NQ + pt) * 2 + hf) * 32 + lane] = part3[pt];
            } else {
              qb[ks][pt][hf] = part3[pt];
            }
          }
        }
    }
  };
  auto scores_mma = [&](int buf, int i, float* sc) {
    const int j = j0 + my0 + i;
    const unsigned char* kb = ring + (size_t)buf * RG::BUF;
    {
      const int sl = 16 * warp + lane / 4;  // this lane's slots: sl and sl + 8
      float cp[NQ][4];  // an accumulator a part of q: NQ chains of KS products, not one of KS * NQ
#pragma unroll
      for (int pt = 0; pt < NQ; ++pt)
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) cp[pt][e4] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4];
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {  // rows sl (+8 for q4 odd), columns (+8 for q4 >= 2)
          const int row = sl + (q4 & 1) * 8, col = ks * 16 + (lane % 4) * 2 + (q4 >> 1) * 8;
          if constexpr (sizeof(TKV) == 2) {
            a[q4] = *reinterpret_cast<const uint32_t*>(kb + row * RS + col * 2);
          } else {
            float f[4];
            codes_f(*reinterpret_cast<const uint16_t*>(kb + row * RS + col), f);
            a[q4] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
          }
        }
#pragma unroll
        for (int pt = 0; pt < NQ; ++pt) {
          if constexpr (kQsm) {  // written by warp 0 before phase 1's first barrier
            const uint32_t bq[2] = {qbs[((ks * NQ + pt) * 2) * 32 + lane],
                                    qbs[((ks * NQ + pt) * 2 + 1) * 32 + lane]};
            Tc<TT>::mma(cp[pt], a, bq);
          } else {
            Tc<TT>::mma(cp[pt], a, qb[ks][pt]);
          }
        }
      }
      float c[4];  // hi + (mid + lo)
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        if constexpr (NQ == 3) {
          c[e4] = cp[0][e4] + (cp[1][e4] + cp[2][e4]);
        } else {
          c[e4] = cp[0][e4];
        }
      }
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const int slot = sl + (e4 >> 1) * 8, r = (lane % 4) * 2 + (e4 & 1);
        const int s = j * cs + slot, qp = p0 + (r0 + r) / G;
        const bool ok = slot < cs && s >= lo && s <= hi && r < nr && s <= qp &&
                        (p.window <= 0 || s > qp - p.window);
        float x;
        if constexpr (kQsm && kF16) {  // the row's 2^-e joins the scale (read here: no registers held)
          x = c[e4] * (p.scale * zt::pow2(-q_exp[r]));
        } else if constexpr (kF16) {
          x = c[e4] * qrs[e4 & 1];
        } else {
          x = c[e4] * p.scale;
        }
        if constexpr (KV::kScaled) x *= ok ? rsc[buf * CH + slot] : 1.f;
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        sc[slot * RM + r] = ok ? x : kNeg;
      }
    }
  };
  // phase 1 on the CUDA cores (f32 K: a thread a slot), sc[slot][RM]
  auto scores_fma = [&](int buf, int i, float* sc) {
    if constexpr (!kMma) {
      if (tid >= CH) return;
      const int s = (j0 + my0 + i) * cs + tid;
      const bool in = tid < cs && s >= lo && s <= hi;
      float acc[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r) acc[r] = 0.f;
      if (in) {
        const float4* row = reinterpret_cast<const float4*>(ring + (size_t)buf * RG::BUF + tid * RS);
#pragma unroll 4
        for (int c4 = 0; c4 < D / 4; ++c4) {
          const float4 x = row[c4];
#pragma unroll
          for (int r = 0; r < RM; ++r) {
            const float4 qq = reinterpret_cast<const float4*>(qsh + r * D)[c4];
            float a = acc[r];
            a += qq.x * x.x;
            a += qq.y * x.y;
            a += qq.z * x.z;
            a += qq.w * x.w;
            acc[r] = a;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int qp = qpos[r];
        const bool ok = in && r < nr && s <= qp && (p.window <= 0 || s > qp - p.window);
        float x = acc[r] * p.scale;
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        acc[r] = ok ? x : kNeg;
      }
      float4* dst = reinterpret_cast<float4*>(sc + tid * RM);
      dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  };
  auto scores = [&](int buf, int i, float* sc) {
    if constexpr (kMma) {
      scores_mma(buf, i, sc);
    } else {
      scores_fma(buf, i, sc);
    }
  };
  // each row's max and sum of exp over own chunk i's scores, a warp a row
  auto stats = [&](const float* sc, int i) {
    __syncthreads();
    for (int r = warp; r < RM; r += kWarps) {
      float x[CH / 32];
      float mx = kNeg;
#pragma unroll
      for (int k = 0; k < CH / 32; ++k) {
        x[k] = sc[(lane + 32 * k) * RM + r];
        mx = fmaxf(mx, x[k]);
      }
      mx = warp_max(mx);
      float l = 0.f;
      if (mx > kNeg) {
#pragma unroll
        for (int k = 0; k < CH / 32; ++k) l += expf(x[k] - mx);
      }
      l = warp_sum(l);
      if (lane == 0) st[i * RM + r] = make_float2(mx, l);
    }
  };

  // the prologue: own chunks' first rows (K9: a table read each, all at once),
  // the copies of the first NBUF - 1 items, then q, whose loads overlap them
  for (int i = tid; i < m; i += kThreads) bases[i] = kv.base(b, h, j0 + my0 + i, cs);
  __syncthreads();
  for (int idx = 0; idx < NBUF - 1; ++idx) issue(idx);
#pragma unroll
  for (int k = 0; k < QPT; ++k) qsh[tid + k * kThreads] = qv[k];
  if constexpr (kMma) {
    __syncthreads();
    if constexpr (kF16) {  // each query row's 2^e, a warp a row
      for (int r = warp; r < RM; r += kWarps) {
        float mx = 0.f;
        for (int d = lane; d < D; d += 32) mx = fmaxf(mx, fabsf(qsh[r * D + d]));
        mx = warp_max(mx);
        if (lane == 0) q_exp[r] = zt::f16_row_exp(mx);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i) qrs[i] = p.scale * zt::pow2(-q_exp[(lane % 4) * 2 + i]);
    }
    build_qb();
  }

  // ---- phase 1: scores and chunk statistics -------------------------------
  for (int i = 0; i < m; ++i) {
    const int buf = acquire();
    patch(buf, i, false);
    float* sc = sT + (size_t)min(i, p.mkeep) * CH * RM;
    scores(buf, i, sc);
    stats(sc, i);
  }
  cluster.sync();

  // ---- the row's max (K9: own prefix maxima; block 0, K8 every block: l) --
  for (int r = warp; r < RM; r += kWarps) {
    float M = kNeg, carry = kNeg;
    float2 first = make_float2(kNeg, 0.f);  // this lane's chunk of the first 32
    for (int k0 = 0; k0 < n; k0 += 32) {
      const int k = k0 + lane;
      float2 s2 = make_float2(kNeg, 0.f);
      if (k < n) s2 = cluster.map_shared_rank(st, k / per)[(k % per) * RM + r];
      if (k0 == 0) first = s2;
      if constexpr (KV::kRound == kRoundPage) {
        float pre = s2.x;  // inclusive prefix max over the chunks
        for (int o = 1; o < 32; o <<= 1) {
          const float y = __shfl_up_sync(kFull, pre, o);
          if (lane >= o) pre = fmaxf(pre, y);
        }
        pre = fmaxf(pre, carry);
        if (k >= my0 && k < my0 + m) mj[(k - my0) * RM + r] = pre;
        carry = __shfl_sync(kFull, pre, 31);
      }
      M = fmaxf(M, warp_max(s2.x));
    }
    float l = 0.f;
    if (rank == 0 || KV::kRound == kRoundNorm) {
      for (int k0 = 0; k0 < n; k0 += 32) {
        const int k = k0 + lane;
        float2 s2 = first;
        if (k0 > 0)
          s2 = k < n ? cluster.map_shared_rank(st, k / per)[(k % per) * RM + r]
                     : make_float2(kNeg, 0.f);
        l += warp_sum(s2.y > 0.f ? s2.y * expf(s2.x - M) : 0.f);
      }
    }
    if (lane == 0) {
      row_m[r] = M;
      row_l[r] = l;
    }
  }

  // ---- phase 2: probabilities, then P.V ----------------------------------
  float acc[RM][DPL];  // CUDA cores (f32 V): a lane D / 32 columns of the 8 rows
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[r][d] = 0.f;
  // tensor cores (bf16 or f16 V, int8 codes): (P.V)^T = V^T P^T with D as M
  // (tiles of 16), the 8 rows as N and a warp's 32 slots of the chunk as K;
  // p split into NP parts of the operand type (K8: p is rounded to the
  // cache dtype, one exact part; three otherwise, f16's after p * 2^15), V
  // exact
  constexpr int MT = D / 16;
  constexpr int NP = KV::kRound == kRoundNorm ? 1 : 3;
  float tacc[kMma ? MT : 1][4];                    // p's hi part
  float tacc2[kMma && NP > 1 ? MT : 1][4];         // its mid and lo parts
#pragma unroll
  for (int mt = 0; mt < (kMma ? MT : 1); ++mt)
#pragma unroll
    for (int e4 = 0; e4 < 4; ++e4) tacc[mt][e4] = 0.f;
#pragma unroll
  for (int mt = 0; mt < (kMma && NP > 1 ? MT : 1); ++mt)
#pragma unroll
    for (int e4 = 0; e4 < 4; ++e4) tacc2[mt][e4] = 0.f;
  // V[s][d], V[s + 1][d] of a staged chunk as a bf16 pair; a slot outside the
  // staged rows [a, z] is 0 (its bytes were never loaded)
  auto vpair = [&](const unsigned char* vbase, int s, int d, bool ok0, bool ok1) -> uint32_t {
    if constexpr (sizeof(TKV) == 2) {
      const uint32_t lo = ok0 ? *reinterpret_cast<const uint16_t*>(vbase + s * RS + d * 2) : 0u;
      const uint32_t hi = ok1 ? *reinterpret_cast<const uint16_t*>(vbase + (s + 1) * RS + d * 2) : 0u;
      return lo | (hi << 16);
    } else {
      const uint32_t c0 = ok0 ? vbase[s * RS + d] : 0u, c1 = ok1 ? vbase[(s + 1) * RS + d] : 0u;
      float f[4];
      codes_f(c0 | (c1 << 8), f);
      return __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
    }
  };
  for (int i = 0; i < m; ++i) {
    float* sc = sT + (size_t)min(i, p.mkeep) * CH * RM;
    if (i >= p.mkeep) {  // scores not kept: the same code on a second copy of the K rows
      const int kb = acquire();
      patch(kb, i, false);
      scores(kb, i, sc);
    }
    const int buf = acquire();  // also orders row_m / mj before their first use
    patch(buf, i, true);
    if (tid < CH) {  // p in place of the scores, a thread a slot
      float4* mine = reinterpret_cast<float4*>(sc + tid * RM);
      const float4 xa = mine[0], xb = mine[1];
      float x[RM] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float vsc = KV::kScaled ? rsc[buf * CH + tid] : 1.f;
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        float pr = 0.f;
        if (x[r] > kNeg) {
          if constexpr (KV::kRound == kRoundPage) {  // the page's P.V rescaled to the row's max
            const float mr = mj[i * RM + r];
            pr = to_f(from_f<TKV>(expf(x[r] - mr))) * expf(mr - row_m[r]);
          } else if constexpr (KV::kRound == kRoundNorm) {
            pr = to_f(from_f<TKV>(__fdiv_rn(expf(x[r] - row_m[r]), row_l[r])));
          } else {
            pr = expf(x[r] - row_m[r]);
            if constexpr (KV::kScaled) pr *= vsc;
          }
        }
        x[r] = pr;
      }
      mine[0] = make_float4(x[0], x[1], x[2], x[3]);
      mine[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
    __syncthreads();
    int a, z;
    rows_of(i, a, z);
    if constexpr (kMma) {
      const unsigned char* vbase = ring + (size_t)buf * RG::BUF;
      const int row = lane / 4;
      {
        const int s0 = 16 * warp + (lane % 4) * 2;  // k pairs s0, s0 + 1 and s0 + 8, s0 + 9
        uint32_t pb[3][2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int s = s0 + 8 * hf;
          if constexpr (kF16 && NP > 1) {
            const float up = zt::pow2(kPUpExp);
            zt_mma::split_pair<NP, TT>(sc[s * RM + row] * up, sc[(s + 1) * RM + row] * up,
                                       pb[0][hf], pb[1][hf], pb[2][hf]);
          } else {
            zt_mma::split_pair<NP, TT>(sc[s * RM + row], sc[(s + 1) * RM + row], pb[0][hf],
                                       pb[1][hf], pb[2][hf]);
          }
        }
        const bool k00 = s0 >= a && s0 <= z, k01 = s0 + 1 >= a && s0 + 1 <= z;
        const bool k10 = s0 + 8 >= a && s0 + 8 <= z, k11 = s0 + 9 >= a && s0 + 9 <= z;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int dd = mt * 16 + lane / 4;
          uint32_t av[4];
          av[0] = vpair(vbase, s0, dd, k00, k01);
          av[1] = vpair(vbase, s0, dd + 8, k00, k01);
          av[2] = vpair(vbase, s0 + 8, dd, k10, k11);
          av[3] = vpair(vbase, s0 + 8, dd + 8, k10, k11);
          Tc<TT>::mma(tacc[mt], av, pb[0]);
          if constexpr (NP > 1) {
            Tc<TT>::mma(tacc2[mt], av, pb[1]);
            Tc<TT>::mma(tacc2[mt], av, pb[2]);
          }
        }
      }
    } else {  // f32 V
      const unsigned char* vb = ring + (size_t)buf * RG::BUF + lane * DPL * sizeof(float);
      for (int t = a + warp; t <= z; t += kWarps) {
        const float4 pa = *reinterpret_cast<const float4*>(sc + t * RM);
        const float4 pb = *reinterpret_cast<const float4*>(sc + t * RM + 4);
        const float pv[RM] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
        const float* v = reinterpret_cast<const float*>(vb + t * RS);
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[r][d] += pv[r] * v[d];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it holds the warps' partials now
  float* wp = reinterpret_cast<float*>(ring);  // [kWarps][RM][D]
  if constexpr (kMma) {
    const int row = (lane % 4) * 2;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int dd = mt * 16 + lane / 4;
      float o[4];
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) o[e4] = NP > 1 ? tacc[mt][e4] + tacc2[mt][e4] : tacc[mt][e4];
      if constexpr (kF16 && NP > 1) {
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) o[e4] *= zt::pow2(-kPUpExp);
      }
      wp[(warp * RM + row) * D + dd] = o[0];
      wp[(warp * RM + row + 1) * D + dd] = o[1];
      wp[(warp * RM + row) * D + dd + 8] = o[2];
      wp[(warp * RM + row + 1) * D + dd + 8] = o[3];
    }
  } else {
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int d = 0; d < DPL; ++d) wp[(warp * RM + r) * D + lane * DPL + d] = acc[r][d];
  }
  __syncthreads();
  for (int e = tid; e < RM * D; e += kThreads) {
    float o = wp[e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) o += wp[w * RM * D + e];
    part[e] = o;
  }
  cluster.sync();

  // ---- block 0: the partials in block order, then the output ---------------
  if (rank == 0) {
    for (int e = tid; e < nr * D; e += kThreads) {
      const int i = e / D, r = r0 + i, g = r % G;
      float pq[NB];  // every peer's value in flight at once, then summed in block order
#pragma unroll
      for (int q = 0; q < NB; ++q) pq[q] = q < nb_used ? cluster.map_shared_rank(part, q)[e] : 0.f;
      float o = 0.f;
#pragma unroll
      for (int q = 0; q < NB; ++q)
        if (q < nb_used) o += pq[q];
      float l = row_l[i];
      if (p.sinks != nullptr) {
        const float sk = p.sinks[h * G + g];
        const float mf = fmaxf(row_m[i], sk);
        const float w = expf(row_m[i] - mf);
        o *= w;
        l = l * w + expf(sk - mf);
      }
      if constexpr (KV::kRound != kRoundNorm) o = l > 0.f ? o / l : 0.f;
      static_cast<TQ*>(p.out)[(((size_t)b * p.T + r / G) * p.Hq + h * G + g) * D + e % D] =
          from_f<TQ>(o);
    }
  }
  cluster.sync();  // the peers' shared memory lives until block 0 has read it
}

// p's chunk room (mmax, mkeep) for its S, the launch's shared memory in
// *shmem, and the kernel's shared-memory attribute (set once an
// instantiation, not inside graph captures); returns a CUDA error code
template <typename TQ, typename TKV, int D, typename KV>
int prepare(Params& p, size_t* shmem) {
  const int nchunks = (p.S + p.cs - 1) / p.cs;  // the widest span
  p.mmax = (nchunks + NB - 1) / NB;
  const int slot_bytes = (int)sizeof(float) * CH * RM;
  p.mkeep = p.mmax * slot_bytes <= kKeepBytes ? p.mmax : kKeepBytes / slot_bytes - 1;
  const int n_slots = p.mkeep < p.mmax ? p.mkeep + 1 : p.mmax;
  *shmem = smem_bytes<TKV, D, KV::kScaled, KV::kRound>(p.mmax, n_slots);
  if (*shmem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(decode_cluster_kernel<TQ, TKV, D, KV>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  return 0;
}

inline dim3 grid(const Params& p, int B) {
  return dim3(NB, p.Hkv * ((p.T * (p.Hq / p.Hkv) + RM - 1) / RM), B);
}

// one launch; returns a CUDA error code (0 on success)
template <typename TQ, typename TKV, int D, typename KV>
int launch(Params p, const KV& kv, int B, cudaStream_t stream) {
  size_t shmem = 0;
  const int err = prepare<TQ, TKV, D, KV>(p, &shmem);
  if (err != 0) return err;
  decode_cluster_kernel<TQ, TKV, D, KV><<<grid(p, B), kThreads, shmem, stream>>>(p, kv);
  return (int)cudaGetLastError();
}

// the clusters of this launch's shape that the card holds at once
// (cudaOccupancyMaxActiveClusters) in *n; returns a CUDA error code
template <typename TQ, typename TKV, int D, typename KV>
int max_active_clusters(Params p, int B, int* n) {
  size_t shmem = 0;
  const int err = prepare<TQ, TKV, D, KV>(p, &shmem);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid(p, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = shmem;
  return (int)cudaOccupancyMaxActiveClusters(n, decode_cluster_kernel<TQ, TKV, D, KV>, &cfg);
}

}  // namespace zt_dc
