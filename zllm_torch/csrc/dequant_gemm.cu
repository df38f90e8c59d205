// K5: dequant GEMM for the formats without a nibble-pair layout of K3's,
// Q6_K, Q8_0, Q2_K, Q3_K, IQ4_NL, IQ4_XS, MXFP4 and the IQ grid formats as
// the port's loader folds them (IQ2_XXS, IQ2_XS, IQ2_S, IQ3_XXS, IQ3_S,
// IQ1_S, IQ1_M: value indexes, zllm_torch/quant/repack.py) and the ternary
// TQ1_0 and TQ2_0: y[M, N] (f32) =
// bf16(x)[M, K] @ bf16(dequant(W)).
//
// Replaces zllm/ops/qmatmul.py::_qmm_kernel (launched by _qmm_call from
// qmatmul), instantiated for these sixteen of its formats: the weight is
// dequantized in f32 as _dequant_tile does (Q6_K: ((ql | qh << 4) - 32) *
// f32(a); Q8_0: qs * f32(d); Q2_K: crumb * f32(a) - f32(b); Q3_K: ((crumb
// | bit << 2) - 4) * f32(a); IQ4_NL, IQ4_XS: IQ4NL_VALUES[index] * f32(d
// or a); MXFP4: MXFP4_VALUES[index] * 2^(e - 128), the e2m1 value doubled
// times the halved E8M0 scale, which is _dequant_tile's sign * mag * d;
// IQ2_*, IQ3_XXS, IQ3_S: the table value of the index * f32(a); IQ1_S,
// IQ1_M: (crumb - 1) * f32(a) - f32(b); TQ1_0, TQ2_0: (crumb - 1) * f32(a);
// every product is exact in f32, so a contraction of q * a - b into one
// FMA rounds as zllm's two operations do) and rounded to bf16 (round to
// nearest even); x (f32 or bf16) is rounded to bf16 in the kernel; the
// products are summed in f32 in zllm's order, one partial per 512-wide (or
// 256-wide) k-slice added in slice order.
//
// Bound on the H100: at the engine's decode M = 4 the weight bytes over
// 3.35 TB/s; at prefill shapes (M = 256 rows a chunk) the 2*M*K*N bf16
// FLOPs over the 989 TFLOP/s tensor-core peak.  Design: the sliced loop of
// gemm_slice.cuh (a split-K row form for M <= 16, a 128-row tile form
// above; K3 runs the same loop), with a decoder per format; a thread copies
// and decodes 16 k of one column in each 64-wide step:
//   Q6_K step c (128-wide chunk c/2, half c%2), quarter q: the 16 ql bytes
//     16q.. of the chunk, whose low (even half) or high (odd half) nibbles
//     hold the codes, the 16 qh bytes 16(q%2).. whose crumb 2(c%2) + q/2
//     holds their top bits, and the 4-byte pair of scales holding group
//     4c + q.  The even half fetches ql and qh, and the odd half reads
//     them from the even half's ring stage: it fetches only its scales.
//   Q8_0 step c, quarter q: 16 int8 codes and the pair of scales holding
//     group 2c + q/2.
//   Q2_K, Q3_K step c, quarter q: 16-group 4c + q, k 16q..16q+15 of the
//     step: its 4 crumb bytes, the 4-byte word of Q3_K's third bits (or
//     of Q2_K's fp16 mins) holding it, in one 16-byte ring piece, and the
//     pair of scales holding it.
//   IQ4_NL, IQ4_XS, MXFP4 and the IQ2 / IQ3 forms step c, quarter q: K3's
//     order (byte 32c + i holds the indexes of k 64c + i and 64c + 32 + i):
//     the 8 bytes 32c + 8q.., k 8q.. (low nibbles, group 2c) and 32 + 8q..
//     (high, group 2c + 1) of the step, their indexes turned into the
//     table's int8 values by byte permutes (lut16, lowbit.cuh), and the
//     word holding the two groups' scales (two fp16, or MXFP4's two
//     exponent bytes); IQ2_XS and IQ2_S (16-groups: the low nibbles'
//     4c + q/2, the high ones' 4c + 2 + q/2) copy the step's four fp16
//     scales into the ring piece's second 8 bytes instead.
//   IQ1_S, IQ1_M step c, quarter q: Q2_K's 16-group 4c + q: its 4 crumb
//     bytes, the min pair holding it (IQ1_S: per 32-group) or its two
//     8-groups' mins (IQ1_M), and the scale pair holding it.
//   TQ1_0, TQ2_0 step c, quarter q: the same 4 crumb bytes and the scale
//     pair holding its 32-group, no min.

#include "gemm_slice.cuh"
#include "lowbit.cuh"
#include "matvec_common.cuh"

namespace {

using zt::pack_bf16;
using zt_slice::cp_async16;
using zt_slice::cp_async4;
using zt_slice::cp_async8;

__device__ __forceinline__ float half_of(uint32_t word, int i) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(word >> (16 * i))));
}

// four values (the bytes of b: codes minus `bias`, or int8 when is_signed)
// times sc, as two bf16 pairs.  A byte u becomes the float 2^23 + u by a
// byte permute (no int-to-float conversion), exact; less 2^23 + bias it is
// the code, exact, and the product with sc is exact in f32 (6 or 8 bits by
// fp16's 11), rounded once to bf16.
__device__ __forceinline__ uint2 scale4(uint32_t b, int bias, float sc, bool is_signed) {
  if (is_signed) {  // s + 128 as an unsigned byte
    b ^= 0x80808080u;
    bias = 128;
  }
  const float off = 8388608.f + (float)bias;
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = (__int_as_float(__byte_perm(b, 0x4B000000u, 0x7440 | e)) - off) * sc;
  return make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
}

struct Q6KSlice {
  const uint8_t* ql;  // [N, K/2]
  const uint8_t* qh;  // [N, K/4]
  const __half* a;    // [N, K/16]
  int K;
  static constexpr int kPieces = 2;
  __device__ __forceinline__ static int slot(int q, int i) { return 2 * q + i; }
  __device__ __forceinline__ void fetch(uint4* p, int stride, uint32_t* word, size_t col, int c,
                                        int q) const {
    const int ch = c >> 1, hh = c & 1;
    if (!hh) {
      cp_async16(p, ql + col * (K / 2) + ch * 64 + 16 * q, 16);
      cp_async16(p + stride, qh + col * (K / 4) + ch * 32 + 16 * (q & 1), 16);
    }
    cp_async4(word, a + col * (K / 16) + ch * 8 + 4 * hh + (q & 2));
  }
  __device__ __forceinline__ void dequant(const uint4* p, const uint4* prev, int stride,
                                          uint32_t word, size_t, int c, int q,
                                          uint4 (&v)[2]) const {
    const int hh = c & 1, nsh = 4 * hh, csh = 2 * (2 * hh + (q >> 1));
    const float sc = half_of(word, q & 1);
    const uint4* b = hh ? prev : p;  // the chunk's ql and qh, from its even step
    const uint4 l = b[0], h = b[stride];
    const uint32_t lw[4] = {l.x, l.y, l.z, l.w}, hw[4] = {h.x, h.y, h.z, h.w};
    uint2 o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t codes = ((lw[j] >> nsh) & 0x0F0F0F0Fu) | (((hw[j] >> csh) & 0x03030303u) << 4);
      o[j] = scale4(codes, 32, sc, false);
    }
    v[0] = make_uint4(o[0].x, o[0].y, o[1].x, o[1].y);
    v[1] = make_uint4(o[2].x, o[2].y, o[3].x, o[3].y);
  }
};

struct Q80Slice {
  const int8_t* qs;  // [N, K]
  const __half* d;   // [N, K/32]
  int K;
  static constexpr int kPieces = 1;
  __device__ __forceinline__ static int slot(int q, int i) { return 2 * q + i; }
  __device__ __forceinline__ void fetch(uint4* p, int, uint32_t* word, size_t col, int c,
                                        int q) const {
    cp_async16(p, qs + col * K + 64 * c + 16 * q, 16);
    cp_async4(word, d + col * (K / 32) + 2 * c);
  }
  __device__ __forceinline__ void dequant(const uint4* p, const uint4*, int, uint32_t word,
                                          size_t, int, int q, uint4 (&v)[2]) const {
    const float sc = half_of(word, q >> 1);
    const uint4 b = p[0];
    const uint2 o0 = scale4(b.x, 0, sc, true), o1 = scale4(b.y, 0, sc, true),
                o2 = scale4(b.z, 0, sc, true), o3 = scale4(b.w, 0, sc, true);
    v[0] = make_uint4(o0.x, o0.y, o1.x, o1.y);
    v[1] = make_uint4(o2.x, o2.y, o3.x, o3.y);
  }
};

// four codes (the bytes of b, unsigned) less bias, times a, less c, as two
// bf16 pairs (the byte-to-float permute of scale4)
__device__ __forceinline__ uint2 affine4(uint32_t b, int bias, float a, float c) {
  const float off = 8388608.f + (float)bias;
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = (__int_as_float(__byte_perm(b, 0x4B000000u, 0x7440 | e)) - off) * a - c;
  return make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
}

// Q2_K (crumb * a - b) and Q3_K ((crumb | bit << 2) - 4) * a): thread q of
// a column decodes 16-group g = 4c + q of step c, k 16q..16q+15 (units 2q,
// 2q + 1); the crumb word of the group at ring bytes 0-3, the word of
// Q3_K's third bits or Q2_K's mins holding it at bytes 4-7, the scale
// pair holding it in `word`
template <bool kQ3>
struct CrumbSlice {
  const uint8_t* qs;  // [N, K/4]
  const uint8_t* qh;  // Q3_K: [N, K/8]
  const __half* a;    // [N, K/16]
  const __half* b;    // Q2_K: [N, K/16]
  int K;
  static constexpr int kPieces = 1;  // 8 of its 16 bytes used
  __device__ __forceinline__ static int slot(int q, int i) { return 2 * q + i; }
  __device__ __forceinline__ void fetch(uint4* p, int, uint32_t* word, size_t col, int c,
                                        int q) const {
    const int g = 4 * c + q;
    unsigned char* pc = reinterpret_cast<unsigned char*>(p);
    cp_async4(pc, qs + col * (K / 4) + 4 * g);
    if constexpr (kQ3)  // groups g & ~1 and g | 1: two bytes each
      cp_async4(pc + 4, qh + col * (K / 8) + 4 * (g >> 1));
    else
      cp_async4(pc + 4, b + col * (K / 16) + (g & ~1));
    cp_async4(word, a + col * (K / 16) + (g & ~1));
  }
  __device__ __forceinline__ void dequant(const uint4* p, const uint4*, int, uint32_t word,
                                          size_t, int, int q, uint4 (&v)[2]) const {
    const uint4 r = p[0];
    const float sc = half_of(word, q & 1);
    uint2 o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // elements 4i..4i+3 of the group
      uint32_t codes = (r.x >> (2 * i)) & 0x03030303u;
      if constexpr (kQ3) {
        codes |= zt::fifth_bits4(r.y >> (16 * (q & 1)), i) >> 2;  // the third bits at bit 2
        o[i] = scale4(codes, 4, sc, false);
      } else {
        o[i] = affine4(codes, 0, sc, half_of(r.y, q & 1));
      }
    }
    v[0] = make_uint4(o[0].x, o[0].y, o[1].x, o[1].y);
    v[1] = make_uint4(o[2].x, o[2].y, o[3].x, o[3].y);
  }
};

// IQ4_NL, IQ4_XS, the IQ2 / IQ3 forms (fp16 scales) and MXFP4 (E8M0
// exponent bytes): K3's NibbleSlice order, the indexes looked up in TABLE;
// kG = 16 (IQ2_XS, IQ2_S): a scale a 16-group
template <class TABLE, bool kE8M0, int kG = 32>
struct TableSlice {
  const uint8_t* qs;  // [N, K/2]
  const void* sc;     // fp16 [N, K/kG], or MXFP4's uint8 exponents [N, K/32]
  int K;
  static constexpr int kPieces = 1;  // 8 of its 16 bytes used (kG = 16: all)
  // v[0] (low nibbles) is k 8q.. of the step, v[1] (high) k 32 + 8q..
  __device__ __forceinline__ static int slot(int q, int i) { return q + 4 * i; }
  __device__ __forceinline__ void fetch(uint4* p, int, uint32_t* word, size_t col, int c,
                                        int q) const {
    cp_async8(p, qs + col * (K / 2) + 32 * c + 8 * q);
    if constexpr (kG == 16)  // halves 4c..4c+3, behind the codes
      cp_async8(reinterpret_cast<unsigned char*>(p) + 8,
                static_cast<const __half*>(sc) + col * (K / 16) + 4 * c);
    else if constexpr (kE8M0)  // bytes 2c, 2c + 1 of the column's row
      cp_async4(word, static_cast<const uint8_t*>(sc) + col * (K / 32) + (2 * c & ~3));
    else  // halves 2c, 2c + 1
      cp_async4(word, static_cast<const __half*>(sc) + col * (K / 32) + 2 * c);
  }
  __device__ __forceinline__ void dequant(const uint4* p, const uint4*, int, uint32_t word,
                                          size_t, int c, int q, uint4 (&v)[2]) const {
    float alo, ahi;
    if constexpr (kG == 16) {  // 16-groups 4c + q/2 (low nibbles), 4c + 2 + q/2 (high)
      alo = half_of(p[0].z, q >> 1);
      ahi = half_of(p[0].w, q >> 1);
    } else if constexpr (kE8M0) {
      const int sh = 8 * (2 * c & 3);
      alo = zt::e8m0_half((word >> sh) & 0xFFu);
      ahi = zt::e8m0_half((word >> (sh + 8)) & 0xFFu);
    } else {
      alo = half_of(word, 0);
      ahi = half_of(word, 1);
    }
    const uint4 b = p[0];
    const uint2 t0 = zt::lut16<TABLE>(b.x), t1 = zt::lut16<TABLE>(b.y);  // .x low, .y high
    const uint2 l0 = scale4(t0.x, 0, alo, true), l1 = scale4(t1.x, 0, alo, true),
                h0 = scale4(t0.y, 0, ahi, true), h1 = scale4(t1.y, 0, ahi, true);
    v[0] = make_uint4(l0.x, l0.y, l1.x, l1.y);
    v[1] = make_uint4(h0.x, h0.y, h1.x, h1.y);
  }
};

// IQ1_S (a, b per 32-group) and IQ1_M (a per 16-group, b per 8-group):
// Q2_K's crumbs, (crumb - 1) * a - b; kMin false, TQ1_0 and TQ2_0: IQ1_S's
// crumbs and 32-group scales without the min, (crumb - 1) * a, exact in
// bf16 (a is fp16: 11 bits).  Thread q of a column decodes 16-group g = 4c
// + q as CrumbSlice does, its crumb word at ring bytes 0-3, the word of
// mins holding it at bytes 4-7 (IQ1_M: its two 8-groups' mins), the scale
// pair holding it in `word`
template <bool kM, bool kMin = true>
struct IQ1CrumbSlice {
  const uint8_t* qs;  // [N, K/4]
  const __half* a;    // [N, K/32] (IQ1_M: [N, K/16])
  const __half* b;    // [N, K/32] (IQ1_M: [N, K/8]; kMin false: unused)
  int K;
  static constexpr int kPieces = 1;  // 8 of its 16 bytes used (kMin false: 4)
  __device__ __forceinline__ static int slot(int q, int i) { return 2 * q + i; }
  __device__ __forceinline__ void fetch(uint4* p, int, uint32_t* word, size_t col, int c,
                                        int q) const {
    const int g = 4 * c + q;
    unsigned char* pc = reinterpret_cast<unsigned char*>(p);
    cp_async4(pc, qs + col * (K / 4) + 4 * g);
    if constexpr (kM) {
      cp_async4(pc + 4, b + col * (K / 8) + 2 * g);
      cp_async4(word, a + col * (K / 16) + (g & ~1));
    } else {  // 32-groups 2c, 2c + 1
      if constexpr (kMin) cp_async4(pc + 4, b + col * (K / 32) + 2 * c);
      cp_async4(word, a + col * (K / 32) + 2 * c);
    }
  }
  __device__ __forceinline__ void dequant(const uint4* p, const uint4*, int, uint32_t word,
                                          size_t, int, int q, uint4 (&v)[2]) const {
    const uint4 r = p[0];
    const int h = kM ? (q & 1) : (q >> 1);
    const float sc = half_of(word, h);
    uint2 o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // elements 4i..4i+3 of the group
      const uint32_t codes = (r.x >> (2 * i)) & 0x03030303u;
      if constexpr (kMin)
        o[i] = affine4(codes, 1, sc, half_of(r.y, kM ? i >> 1 : h));
      else
        o[i] = scale4(codes, 1, sc, false);
    }
    v[0] = make_uint4(o[0].x, o[0].y, o[1].x, o[1].y);
    v[1] = make_uint4(o[2].x, o[2].y, o[3].x, o[3].y);
  }
};

}  // namespace

// fmt: 0 = Q6_K (p0 = ql, p1 = qh, p2 = a), 1 = Q8_0 (p0 = qs, p1 = d),
// 2 = Q2_K (qs, a, b), 3 = Q3_K (qs, qh, a), 4 = IQ4_NL (qs, d), 5 = IQ4_XS
// (qs, a), 6 = MXFP4 (qs, e), 7 = IQ2_XXS, 8 = IQ2_XS, 9 = IQ2_S, 10 =
// IQ3_XXS, 11 = IQ3_S (qs, a), 12 = IQ1_S, 13 = IQ1_M (qs, a, b), 14 = TQ1_0,
// 15 = TQ2_0 (qs, a).
// xdtype, xb, tk, form, spb and ws as for zt_slice::launch_slice_gemm: an
// f32 x adds a launch that rounds it into xb, a call with spb < K / tk one
// that reduces the slice partials in order.
extern "C" int zt_dequant_gemm(int fmt, const void* x, int xdtype, void* xb, const void* p0,
                               const void* p1, const void* p2, float* y, float* ws, int M, int K,
                               int N, int tk, int form, int spb, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (fmt == 0) {
    const Q6KSlice w{static_cast<const uint8_t*>(p0), static_cast<const uint8_t*>(p1),
                     static_cast<const __half*>(p2), K};
    return zt_slice::launch_slice_gemm(x, xdtype, xb, w, y, ws, M, K, N, tk, form, spb, s);
  }
  if (fmt == 1) {
    const Q80Slice w{static_cast<const int8_t*>(p0), static_cast<const __half*>(p1), K};
    return zt_slice::launch_slice_gemm(x, xdtype, xb, w, y, ws, M, K, N, tk, form, spb, s);
  }
  const auto* qs = static_cast<const uint8_t*>(p0);
  switch (fmt) {
    case 2:
      return zt_slice::launch_slice_gemm(
          x, xdtype, xb,
          CrumbSlice<false>{qs, nullptr, static_cast<const __half*>(p1),
                            static_cast<const __half*>(p2), K},
          y, ws, M, K, N, tk, form, spb, s);
    case 3:
      return zt_slice::launch_slice_gemm(
          x, xdtype, xb,
          CrumbSlice<true>{qs, static_cast<const uint8_t*>(p1), static_cast<const __half*>(p2),
                           nullptr, K},
          y, ws, M, K, N, tk, form, spb, s);
    case 4:
    case 5:
      return zt_slice::launch_slice_gemm(x, xdtype, xb, TableSlice<zt::IQ4Table, false>{qs, p1, K},
                                         y, ws, M, K, N, tk, form, spb, s);
    case 6:
      return zt_slice::launch_slice_gemm(x, xdtype, xb, TableSlice<zt::MXFP4Table, true>{qs, p1, K},
                                         y, ws, M, K, N, tk, form, spb, s);
    case 7:
      return zt_slice::launch_slice_gemm(x, xdtype, xb, TableSlice<zt::IQ2Table, false>{qs, p1, K},
                                         y, ws, M, K, N, tk, form, spb, s);
    case 8:
    case 9:
      return zt_slice::launch_slice_gemm(x, xdtype, xb,
                                         TableSlice<zt::IQ2Table, false, 16>{qs, p1, K}, y, ws, M,
                                         K, N, tk, form, spb, s);
    case 10:
      return zt_slice::launch_slice_gemm(x, xdtype, xb,
                                         TableSlice<zt::IQ3XXSTable, false>{qs, p1, K}, y, ws, M,
                                         K, N, tk, form, spb, s);
    case 11:
      return zt_slice::launch_slice_gemm(x, xdtype, xb, TableSlice<zt::IQ3STable, false>{qs, p1, K},
                                         y, ws, M, K, N, tk, form, spb, s);
    case 12:
    case 13: {
      const auto* a = static_cast<const __half*>(p1);
      const auto* b = static_cast<const __half*>(p2);
      return fmt == 12
                 ? zt_slice::launch_slice_gemm(x, xdtype, xb, IQ1CrumbSlice<false>{qs, a, b, K}, y,
                                               ws, M, K, N, tk, form, spb, s)
                 : zt_slice::launch_slice_gemm(x, xdtype, xb, IQ1CrumbSlice<true>{qs, a, b, K}, y,
                                               ws, M, K, N, tk, form, spb, s);
    }
    case 14:
    case 15:
      return zt_slice::launch_slice_gemm(
          x, xdtype, xb, IQ1CrumbSlice<false, false>{qs, static_cast<const __half*>(p1), nullptr, K},
          y, ws, M, K, N, tk, form, spb, s);
  }
  return (int)cudaErrorInvalidValue;
}
