// K4: decode matvec (M = 1) on the int8 path for the formats whose weight
// is an integer code times one scale a group: Q6_K (16-groups), Q8_0
// (32-groups), Q2_K and Q3_K (16-groups), IQ4_NL, IQ4_XS and MXFP4
// (32-groups), and the IQ grid formats as the port's loader folds them
// (value indexes, zllm_torch/quant/repack.py): IQ2_XXS (32-groups), IQ2_XS
// and IQ2_S (16-groups), IQ3_XXS, IQ3_S and IQ1_S (32-groups), and the
// ternary TQ1_0 and TQ2_0 (32-groups, one form).
//
// Replaces zllm/ops/qmatmul.py::_w4a8_kernel (launched by _qmm_w4a8_call
// from qmatmul_w4a8, qmatvec_norm and qmatvec_glu), instantiated for these
// fifteen of its _INT_FMT formats: y[n] = sum_g pi_g * a_g * dx_g (- b_g *
// e_g, Q2_K's and IQ1_S's min term, e_g = dx_g * sx_g), where the activation row is
// quantized to int8 per group (the prologue of matvec_common.cuh, shared
// with K1: group 16 or 32 as the format's) and pi_g is the exact integer
// dot of the group's int8 activations with the weight's codes (_int_qtile):
//   Q6_K: (ql | qh << 4) - 32 in -32..31;  Q8_0: the stored int8;
//   Q2_K: the crumb 0..3;  Q3_K: (crumb | bit << 2) - 4 in -4..3;
//   IQ4_NL, IQ4_XS: IQ4NL_VALUES[index];  MXFP4: MXFP4_VALUES[index];
//   IQ2_*: IQ2_VALUES[index];  IQ3_XXS: IQ3XXS_VALUES[index];  IQ3_S: the
//   odd value of its index;  IQ1_S, TQ1_0, TQ2_0: crumb - 1 in -1..1;
// a_g the group scale (Q6_K, Q2_K, Q3_K, IQ4_XS, the IQ grid formats, TQ1_0
// and TQ2_0: the fp16 plane a; Q8_0, IQ4_NL: d; MXFP4: 2^(e - 128) from the
// E8M0 byte), b_g Q2_K's and IQ1_S's fp16 min.
//
// Bound on the H100: the weight bytes, read once (Q6_K: 210 bytes per 256
// weights in the GGUF, 224 in this layout, whose scale plane a is fp16 per
// 16-group; Q8_0: 34 per 32; Q2_K and Q3_K 128 per 256 in this layout,
// IQ4_NL and IQ4_XS 144, MXFP4 136, the IQ2 and IQ3 forms 128 + 2 * 256 /
// group, IQ1_S 96, TQ1_0 and TQ2_0 80 (the GGUF's 54 and 66); the GGUF's
// IQ grid blocks are 50-110 bytes per 256, zllm's value-index layout
// 1.5-2.9x that); 2*K*N int8 operations are ~1000x under the int8 peak.
// A Q4_K_M step's 34 launches move 0.2-2.3 MB each (0.07-0.7 us of
// bytes), so what paces them is each launch's fixed part: the earlier
// form (8-warp blocks, up to four an SM each redoing the prologue, a plain
// <<<>>> launch, a column's loads issued only after the previous column's
// dots) took 7.3 us a launch (python -m zllm_torch.k1_ablation --kernel k4,
// PERF.md §6).
//
// Design: K1's (q4k_matvec.cu), with its launch machinery from
// matvec_common.cuh.  Every block quantizes the activation row into shared
// memory, then each warp streams whole output columns, the column's planes
// contiguous along K (the weight layouts of zllm_torch/quant/repack.py).
// A lane takes one slot a round (kSlot elements: 32 for Q6_K and Q8_0, 64
// for the others), so a warp reads 32 slots of a column per round with
// 16-byte loads:
//   Q6_K slot c (superblock c/8, half h, quarter t): 16 ql bytes whose low
//     nibbles are the 16 codes of one group and high nibbles those of the
//     group 64 elements on, and the 16 qh bytes that hold their top bits
//     (crumbs t/2 and 2 + t/2); four __dp4a a group;
//   Q8_0 slot c: the 32 codes of group c, eight __dp4a;
//   Q2_K, Q3_K slot c: the 16 crumb bytes of groups 4c..4c+3 (group g's
//     u32 word shifted by 2i and masked holds its elements 4i..4i+3 in its
//     bytes), Q3_K's 8 bytes of third bits (two a group, moved to bit 2 of
//     each code byte by one multiply and mask), the four groups' fp16
//     scales (and Q2_K's mins) as 8 bytes each; four __dp4a a group;
//   IQ4_NL, IQ4_XS, MXFP4 and the IQ2 / IQ3 forms slot c: the 32 qs bytes
//     of chunk c, whose low nibbles index group 2c's codes and high nibbles
//     group 2c + 1's, each word's eight indexes turned into int8 table
//     values by byte permutes (lut16, lowbit.cuh); eight __dp4a a group
//     (IQ2_XS and IQ2_S: the same bytes are four 16-groups, 4c + h and 4c
//     + 2 + h from the words of half h, four __dp4a and a scale each);
//   IQ1_S slot c: Q2_K's 16 crumb bytes of 16-groups 4c..4c+3, i.e. the
//     32-groups 2c and 2c + 1, and their two scales and two mins; TQ1_0
//     and TQ2_0 the same without the mins (Crumb32<false>).
// Unsigned codes go into __dp4a as they are and a bias comes off the
// integer dot: sum (q - 32) x = sum q x - 32 sum x (Q6_K), - 4 sum x
// (Q3_K), - sum x (IQ1_S, TQ1_0, TQ2_0), with sum x the group's code sum
// from the prologue; every group
// dot is at most 32 * 127 * 127 < 2^24, so all are exact.
//   * One wave of 16-warp blocks, at most two an SM (cpw columns a warp);
//     a narrow N (wv, 256 columns) is spread over the SMs a few warps'
//     columns a block, the block's other warps only helping the prologue
//     (packed sixteen columns a block, wv ran on 16 SMs).
//   * "glu" (ffn_down, K 5632): the blocks of a thread-block cluster of 4
//     share the prologue over distributed shared memory
//     (quantize_glu_cluster, 16-groups for Q6_K, Q2_K and Q3_K).
//   * Cross-column prefetch: a warp's columns are cut into units of one
//     round (32 slots), held in two register sets; the next unit's loads
//     are in flight while the current one's dots run (two rounds a set took
//     0.163 ms a step against 0.176, but spilled under the 64 registers of
//     two blocks an SM).
//   * Programmatic dependent launch (launch_matvec): before
//     griddepcontrol.wait a block issues only loads of what no kernel
//     writes -- its warps' first two units of weight planes, and an L2
//     prefetch of the RMS weight for "norm" -- so a K4 that follows a K1
//     (wk -> wv, gate|up -> down) has its weights in flight while its
//     predecessor drains; launch_dependents at the block's start.
//   * Each lane adds the same slot terms in the same order as the earlier
//     form (slot c = lane + 32 i, i rising, then warp_sum), and the row is
//     quantized as before, so the Q6_K and Q8_0 output is bit-identical to
//     it.
//
// Where trouble lies: as K1's (q4k_matvec.cu) -- nothing before the wait
// reads x or writes y; a predecessor that never triggers (a torch op, K2)
// makes the launch as safe as a plain one; `-Xptxas -v` must show no spill
// under __launch_bounds__(512, 2) (chip_smoke.py's build report fails on
// one).

#include "lowbit.cuh"
#include "matvec_common.cuh"

namespace {

using namespace zt;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint4 ld16(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ float half_of(uint32_t word, int i) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(word >> (16 * i))));
}

struct Q6K {
  static constexpr int kGroup = 16, kSlot = 32;
  const uint8_t* ql;  // [N, K/2]
  const uint8_t* qh;  // [N, K/4]
  const __half* a;    // [N, K/16]
  struct Slot {
    uint4 l, h;
    __half alo, ahi;
  };
  __device__ __forceinline__ void fetch(Slot& s, size_t n, int K, int c) const {
    const int sb = c >> 3, half = (c >> 2) & 1, t = c & 3;
    s.l = ld16(ql + n * (K / 2) + sb * 128 + half * 64 + t * 16);
    s.h = ld16(qh + n * (K / 4) + sb * 64 + half * 32 + (t & 1) * 16);
    const int g = sb * 16 + half * 8 + t;  // the low nibbles' group; +4 the high
    s.alo = a[n * (K / 16) + g];
    s.ahi = a[n * (K / 16) + g + 4];
  }
  __device__ __forceinline__ float dot(const Slot& s, int c, const QuantRow<16>& row) const {
    const int sb = c >> 3, half = (c >> 2) & 1, t = c & 3;
    const int g = sb * 16 + half * 8 + t;
    const int shl = 2 * (t >> 1), shh = shl + 4;  // crumb of the low / high group
    const int4 xl = *reinterpret_cast<const int4*>(row.xq + g * 16);
    const int4 xh = *reinterpret_cast<const int4*>(row.xq + (g + 4) * 16);
    const uint32_t lw[4] = {s.l.x, s.l.y, s.l.z, s.l.w};
    const uint32_t hw[4] = {s.h.x, s.h.y, s.h.z, s.h.w};
    const int xlw[4] = {xl.x, xl.y, xl.z, xl.w};
    const int xhw[4] = {xh.x, xh.y, xh.z, xh.w};
    int plo = 0, phi = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = (lw[i] & 0x0F0F0F0Fu) | (((hw[i] >> shl) & 0x03030303u) << 4);
      const uint32_t hi = ((lw[i] >> 4) & 0x0F0F0F0Fu) | (((hw[i] >> shh) & 0x03030303u) << 4);
      plo = __dp4a((int)lo, xlw[i], plo);
      phi = __dp4a((int)hi, xhw[i], phi);
    }
    plo -= 32 * row.sx[g];
    phi -= 32 * row.sx[g + 4];
    return (float)plo * __half2float(s.alo) * row.dx[g] +
           (float)phi * __half2float(s.ahi) * row.dx[g + 4];
  }
};

struct Q80 {
  static constexpr int kGroup = 32, kSlot = 32;
  const int8_t* qs;  // [N, K]
  const __half* d;   // [N, K/32]
  struct Slot {
    uint4 q0, q1;
    __half d;
  };
  __device__ __forceinline__ void fetch(Slot& s, size_t n, int K, int c) const {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(qs) + n * K + c * 32;
    s.q0 = ld16(p);
    s.q1 = ld16(p + 16);
    s.d = d[n * (K / 32) + c];
  }
  __device__ __forceinline__ float dot(const Slot& s, int c, const QuantRow<32>& row) const {
    const int4 x0 = *reinterpret_cast<const int4*>(row.xq + c * 32);
    const int4 x1 = *reinterpret_cast<const int4*>(row.xq + c * 32 + 16);
    int pi = 0;
    pi = __dp4a((int)s.q0.x, x0.x, pi);
    pi = __dp4a((int)s.q0.y, x0.y, pi);
    pi = __dp4a((int)s.q0.z, x0.z, pi);
    pi = __dp4a((int)s.q0.w, x0.w, pi);
    pi = __dp4a((int)s.q1.x, x1.x, pi);
    pi = __dp4a((int)s.q1.y, x1.y, pi);
    pi = __dp4a((int)s.q1.z, x1.z, pi);
    pi = __dp4a((int)s.q1.w, x1.w, pi);
    return (float)pi * __half2float(s.d) * row.dx[c];
  }
};

// Q2_K (no third bit, a min) and Q3_K (a third bit, a -4 bias): slot c is
// the 16-groups 4c..4c+3
template <bool kQ3>
struct Crumb {
  static constexpr int kGroup = 16, kSlot = 64;
  const uint8_t* qs;  // [N, K/4]
  const uint8_t* qh;  // Q3_K: [N, K/8]
  const __half* a;    // [N, K/16]
  const __half* b;    // Q2_K: [N, K/16]
  struct Slot {
    uint4 q;
    uint2 h, a, b;  // the four groups' third bits, scales and mins
  };
  __device__ __forceinline__ void fetch(Slot& s, size_t n, int K, int c) const {
    s.q = ld16(qs + n * (K / 4) + c * 16);
    s.a = *reinterpret_cast<const uint2*>(a + n * (K / 16) + c * 4);
    if constexpr (kQ3)
      s.h = *reinterpret_cast<const uint2*>(qh + n * (K / 8) + c * 8);
    else
      s.b = *reinterpret_cast<const uint2*>(b + n * (K / 16) + c * 4);
  }
  __device__ __forceinline__ float dot(const Slot& s, int c, const QuantRow<16>& row) const {
    const uint32_t qw[4] = {s.q.x, s.q.y, s.q.z, s.q.w};
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g = 4 * c + j;
      const int4 x = *reinterpret_cast<const int4*>(row.xq + g * 16);
      const int xw[4] = {x.x, x.y, x.z, x.w};
      uint32_t hb = 0;  // Q3_K: group g's 16 third bits
      if constexpr (kQ3) hb = (j < 2 ? s.h.x : s.h.y) >> (16 * (j & 1));
      int p = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t code = (qw[j] >> (2 * i)) & 0x03030303u;
        if constexpr (kQ3) code |= fifth_bits4(hb, i) >> 2;  // bit 4i + e -> bit 2 of byte e
        p = __dp4a((int)code, xw[i], p);
      }
      const float dx = row.dx[g], a_ = half_of(j < 2 ? s.a.x : s.a.y, j & 1);
      if constexpr (kQ3) {
        t += (float)(p - 4 * row.sx[g]) * a_ * dx;
      } else {
        const float b_ = half_of(j < 2 ? s.b.x : s.b.y, j & 1);
        t += (float)p * a_ * dx - b_ * (dx * (float)row.sx[g]);
      }
    }
    return t;
  }
};

// IQ4_NL (d), IQ4_XS (a), MXFP4 (e) and the IQ2 / IQ3 forms (a): 4-bit
// indexes into TABLE in the nibble formats' order; slot c is the 32-groups
// 2c (low nibbles) and 2c + 1 (high), or with kG = 16 (IQ2_XS, IQ2_S) the
// 16-groups 4c, 4c + 1 (low nibbles of the two halves) and 4c + 2, 4c + 3
// (high), four fp16 scales
template <class TABLE, bool kE8M0, int kG = 32>
struct Table4 {
  static constexpr int kGroup = kG, kSlot = 64;
  const uint8_t* qs;  // [N, K/2]
  const void* sc;     // fp16 [N, K/kG], or MXFP4's uint8 exponents [N, K/32]
  struct Slot {
    uint4 q0, q1;
    uint32_t s;  // the two groups' scales: two fp16, or two exponent bytes
    uint32_t s2;  // kG = 16: the scales of 4c + 2, 4c + 3
  };
  __device__ __forceinline__ void fetch(Slot& s, size_t n, int K, int c) const {
    const uint8_t* p = qs + n * (K / 2) + c * 32;
    s.q0 = ld16(p);
    s.q1 = ld16(p + 16);
    if constexpr (kG == 16) {
      const uint2 v = *reinterpret_cast<const uint2*>(static_cast<const __half*>(sc) +
                                                      n * (K / 16) + 4 * c);
      s.s = v.x;
      s.s2 = v.y;
    } else if constexpr (kE8M0) {
      s.s = *(static_cast<const uint16_t*>(sc) + (n * (K / 32) + 2 * c) / 2);
    } else {
      s.s = *reinterpret_cast<const uint32_t*>(static_cast<const __half*>(sc) + n * (K / 32) +
                                               2 * c);
    }
  }
  __device__ __forceinline__ float dot(const Slot& s, int c, const QuantRow<kG>& row) const {
    const uint32_t w[8] = {s.q0.x, s.q0.y, s.q0.z, s.q0.w, s.q1.x, s.q1.y, s.q1.z, s.q1.w};
    if constexpr (kG == 16) {
      int p[4] = {0, 0, 0, 0};  // 16-groups 4c + j
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int4 xl = *reinterpret_cast<const int4*>(row.xq + (4 * c + h) * 16);
        const int4 xh = *reinterpret_cast<const int4*>(row.xq + (4 * c + 2 + h) * 16);
        const int xlw[4] = {xl.x, xl.y, xl.z, xl.w};
        const int xhw[4] = {xh.x, xh.y, xh.z, xh.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint2 v = lut16<TABLE>(w[4 * h + i]);
          p[h] = __dp4a((int)v.x, xlw[i], p[h]);
          p[2 + h] = __dp4a((int)v.y, xhw[i], p[2 + h]);
        }
      }
      float t = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        t += (float)p[j] * half_of(j < 2 ? s.s : s.s2, j & 1) * row.dx[4 * c + j];
      return t;
    }
    const int g = 2 * c;
    int plo = 0, phi = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int4 xl = *reinterpret_cast<const int4*>(row.xq + g * 32 + 16 * h);
      const int4 xh = *reinterpret_cast<const int4*>(row.xq + (g + 1) * 32 + 16 * h);
      const int xlw[4] = {xl.x, xl.y, xl.z, xl.w};
      const int xhw[4] = {xh.x, xh.y, xh.z, xh.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint2 v = lut16<TABLE>(w[4 * h + i]);
        plo = __dp4a((int)v.x, xlw[i], plo);
        phi = __dp4a((int)v.y, xhw[i], phi);
      }
    }
    float alo, ahi;
    if constexpr (kE8M0) {
      alo = e8m0_half(s.s & 0xFFu);
      ahi = e8m0_half((s.s >> 8) & 0xFFu);
    } else {
      alo = half_of(s.s, 0);
      ahi = half_of(s.s, 1);
    }
    return (float)plo * alo * row.dx[g] + (float)phi * ahi * row.dx[g + 1];
  }
};

// IQ1_S (kMin) and TQ1_0, TQ2_0: Q2_K's crumb order, the crumbs the value
// + 1 (IQ1_S: the grid value), one scale a 32-group and, for IQ1_S, one min;
// slot c is the 16-groups 4c..4c+3 (the 32-groups 2c, 2c + 1)
template <bool kMin>
struct Crumb32 {
  static constexpr int kGroup = 32, kSlot = 64;
  const uint8_t* qs;  // [N, K/4]
  const __half* a;    // [N, K/32]
  const __half* b;    // IQ1_S: [N, K/32]
  struct Slot {
    uint4 q;
    uint32_t a, b;  // the two groups' scales and mins
  };
  __device__ __forceinline__ void fetch(Slot& s, size_t n, int K, int c) const {
    s.q = ld16(qs + n * (K / 4) + c * 16);
    s.a = *reinterpret_cast<const uint32_t*>(a + n * (K / 32) + 2 * c);
    if constexpr (kMin) s.b = *reinterpret_cast<const uint32_t*>(b + n * (K / 32) + 2 * c);
  }
  __device__ __forceinline__ float dot(const Slot& s, int c, const QuantRow<32>& row) const {
    const uint32_t qw[4] = {s.q.x, s.q.y, s.q.z, s.q.w};
    float t = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int p = 0;
#pragma unroll
      for (int j = 2 * h; j < 2 * h + 2; ++j) {  // the two 16-groups of 32-group 2c + h
        const int4 x = *reinterpret_cast<const int4*>(row.xq + (4 * c + j) * 16);
        const int xw[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) p = __dp4a((int)((qw[j] >> (2 * i)) & 0x03030303u), xw[i], p);
      }
      const int g = 2 * c + h;
      const float dx = row.dx[g];
      if constexpr (kMin) {
        t += (float)(p - row.sx[g]) * half_of(s.a, h) * dx -
             half_of(s.b, h) * (dx * (float)row.sx[g]);
      } else {
        t += (float)(p - row.sx[g]) * half_of(s.a, h) * dx;
      }
    }
    return t;
  }
};

template <typename TX, int MODE, class F>
__global__ void __launch_bounds__(kThreads, 2) int8_matvec_kernel(
    const TX* __restrict__ x, const float* __restrict__ aux, const F f,
    float* __restrict__ y, int K, int N, int cols_per_warp, int wpb, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const QuantRow<F::kGroup> row(smem, K);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nslot = K / F::kSlot;
  const int upc = (nslot + 31) / 32;  // units (rounds of 32 slots) a column
  // this warp's columns n0 + j * wpb (j < cpw, < N; warps >= wpb none),
  // unit u = (column u / upc, slots from (u % upc) * 32)
  const int n0 = blockIdx.x * cols_per_warp * wpb + warp;
  const int ncols = warp < wpb && n0 < N ? min(cols_per_warp, (N - 1 - n0) / wpb + 1) : 0;
  const int nu = ncols * upc;
  auto fetch = [&](typename F::Slot& sl, int u) {
    const int c = (u % upc) * 32 + lane;
    if (u < nu && c < nslot) f.fetch(sl, (size_t)(n0 + (u / upc) * wpb), K, c);
  };

  // before the wait: weights and the norm weight only
  typename F::Slot ca, cb;
  fetch(ca, 0);
  fetch(cb, 1);
  if (MODE == kNorm) {
    for (int k = threadIdx.x * 32; k < K; k += kThreads * 32)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(aux + k));
  }
  launch_dependents();
  if (MODE == kGlu) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  grid_wait();
  if constexpr (MODE == kGlu) {
    quantize_glu_cluster<TX, F::kGroup, kThreads>(x, K, row);
  } else {
    quantize_row<TX, MODE, F::kGroup, kThreads>(x, aux, K, eps, row);
  }

  float acc = 0.f;
  auto dots = [&](const typename F::Slot& sl, int u) {
    if (u >= nu) return;  // uniform across the warp
    const int c = (u % upc) * 32 + lane;
    if (c < nslot) acc += f.dot(sl, c, row);
    if (u % upc == upc - 1) {  // the column's last unit
      acc = warp_sum(acc);
      if (lane == 0) y[n0 + (u / upc) * wpb] = acc;
      acc = 0.f;
    }
  };
  for (int u = 0; u < nu; u += 2) {
    dots(ca, u);
    fetch(ca, u + 2);
    dots(cb, u + 1);
    fetch(cb, u + 3);
  }
}

// warps of a block that take columns: as many as spread the columns over
// every SM, at most all of them (N >= 16 * cpw * SMs)
inline int spread_warps(int N, int cpw, int sms, int warps) {
  const int w = (N + cpw * sms - 1) / (cpw * sms);
  return w < 1 ? 1 : (w > warps ? warps : w);
}

template <typename TX, int MODE, class F>
int launch(const void* x, const float* aux, const F& f, float* y, int K, int N, float eps,
           cudaStream_t stream) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  // one wave of at most two blocks an SM
  const int cpw = wave_cols(N, sms, kWarps);
  const int wpb = spread_warps(N, cpw, sms, kWarps);
  // glu: clusters of cl blocks share the prologue (a multiple of cl blocks,
  // the last ones perhaps without a column)
  const int cl = MODE == kGlu ? glu_cluster<F::kGroup>(K) : 1;
  return launch_matvec(int8_matvec_kernel<TX, MODE, F>, (N + cpw * wpb - 1) / (cpw * wpb),
                       kThreads, QuantRow<F::kGroup>::bytes(K), cl, stream,
                       static_cast<const TX*>(x), aux, f, y, K, N, cpw, wpb, eps);
}

template <typename TX, class F>
int launch_mode(int mode, const void* x, const float* aux, const F& f, float* y, int K, int N,
                float eps, cudaStream_t s) {
  switch (mode) {
    case kQ: return launch<TX, kQ>(x, aux, f, y, K, N, eps, s);
    case kNorm: return launch<TX, kNorm>(x, aux, f, y, K, N, eps, s);
    case kGlu: return launch<TX, kGlu>(x, aux, f, y, K, N, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <class F>
int launch_dtype(int x_dtype, int mode, const void* x, const float* aux, const F& f, float* y,
                 int K, int N, float eps, cudaStream_t s) {
  if (x_dtype == 0) return launch_mode<float>(mode, x, aux, f, y, K, N, eps, s);
  if (x_dtype == 1) return launch_mode<__nv_bfloat16>(mode, x, aux, f, y, K, N, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// fmt: 0 = Q6_K (p0 = ql, p1 = qh, p2 = a), 1 = Q8_0 (p0 = qs, p1 = d),
// 2 = Q2_K (qs, a, b), 3 = Q3_K (qs, qh, a), 4 = IQ4_NL (qs, d), 5 = IQ4_XS
// (qs, a), 6 = MXFP4 (qs, e), 7 = IQ2_XXS, 8 = IQ2_XS, 9 = IQ2_S, 10 =
// IQ3_XXS, 11 = IQ3_S (qs, a), 12 = IQ1_S (qs, a, b), 14 = TQ1_0, 15 = TQ2_0
// (qs, a).
// x_dtype: 0 = float32, 1 = bfloat16.  mode: 0 = q, 1 = norm, 2 = glu.
extern "C" int zt_int8_matvec(int fmt, const void* x, int x_dtype, const float* aux,
                              const void* p0, const void* p1, const void* p2, float* y, int K,
                              int N, int mode, float eps, void* stream) {
  if (K % 256 != 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fmt == 0) {
    const Q6K f{static_cast<const uint8_t*>(p0), static_cast<const uint8_t*>(p1),
                static_cast<const __half*>(p2)};
    return launch_dtype(x_dtype, mode, x, aux, f, y, K, N, eps, s);
  }
  if (fmt == 1) {
    const Q80 f{static_cast<const int8_t*>(p0), static_cast<const __half*>(p1)};
    return launch_dtype(x_dtype, mode, x, aux, f, y, K, N, eps, s);
  }
  const auto* qs = static_cast<const uint8_t*>(p0);
  switch (fmt) {
    case 2:
      return launch_dtype(x_dtype, mode, x, aux,
                          Crumb<false>{qs, nullptr, static_cast<const __half*>(p1),
                                       static_cast<const __half*>(p2)},
                          y, K, N, eps, s);
    case 3:
      return launch_dtype(x_dtype, mode, x, aux,
                          Crumb<true>{qs, static_cast<const uint8_t*>(p1),
                                      static_cast<const __half*>(p2), nullptr},
                          y, K, N, eps, s);
    case 4:
    case 5:
      return launch_dtype(x_dtype, mode, x, aux, Table4<IQ4Table, false>{qs, p1}, y, K, N, eps,
                          s);
    case 6:
      return launch_dtype(x_dtype, mode, x, aux, Table4<MXFP4Table, true>{qs, p1}, y, K, N, eps,
                          s);
    case 7:
      return launch_dtype(x_dtype, mode, x, aux, Table4<IQ2Table, false>{qs, p1}, y, K, N, eps,
                          s);
    case 8:
    case 9:
      return launch_dtype(x_dtype, mode, x, aux, Table4<IQ2Table, false, 16>{qs, p1}, y, K, N,
                          eps, s);
    case 10:
      return launch_dtype(x_dtype, mode, x, aux, Table4<IQ3XXSTable, false>{qs, p1}, y, K, N,
                          eps, s);
    case 11:
      return launch_dtype(x_dtype, mode, x, aux, Table4<IQ3STable, false>{qs, p1}, y, K, N, eps,
                          s);
    case 12:
      return launch_dtype(x_dtype, mode, x, aux,
                          Crumb32<true>{qs, static_cast<const __half*>(p1),
                                        static_cast<const __half*>(p2)},
                          y, K, N, eps, s);
    case 14:
    case 15:
      return launch_dtype(x_dtype, mode, x, aux,
                          Crumb32<false>{qs, static_cast<const __half*>(p1), nullptr}, y, K, N,
                          eps, s);
  }
  return (int)cudaErrorInvalidValue;
}
