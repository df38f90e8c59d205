// Decoding helpers of the low-bit formats K4 (int8_matvec.cu) and K5
// (dequant_gemm.cu) take besides Q6_K and Q8_0: the 16-entry int8 tables
// of IQ4_NL / IQ4_XS (IQ4NL_VALUES) and MXFP4 (the e2m1 values doubled,
// MXFP4_VALUES; zllm_torch/quant/blocks.py), and of the IQ grid formats'
// value indexes (IQ2_VALUES, IQ3XXS_VALUES, IQ3S_VALUES;
// zllm_torch/quant/repack.py), looked up four bytes at a time by byte
// permutes instead of a chain of selects, and MXFP4's E8M0 scale.

#pragma once

#include <stdint.h>

namespace zt {

constexpr uint32_t pack_i8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xFF) | ((uint32_t)(b & 0xFF) << 8) | ((uint32_t)(c & 0xFF) << 16) |
         ((uint32_t)(d & 0xFF) << 24);
}

// a table's 16 int8 values, four to a word (entry i in byte i % 4 of ti/4)
struct IQ4Table {
  static constexpr uint32_t t0 = pack_i8(-127, -104, -83, -65);
  static constexpr uint32_t t1 = pack_i8(-49, -35, -22, -10);
  static constexpr uint32_t t2 = pack_i8(1, 13, 25, 38);
  static constexpr uint32_t t3 = pack_i8(53, 69, 89, 113);
};
struct MXFP4Table {
  static constexpr uint32_t t0 = pack_i8(0, 1, 2, 3);
  static constexpr uint32_t t1 = pack_i8(4, 6, 8, 12);
  static constexpr uint32_t t2 = pack_i8(0, -1, -2, -3);
  static constexpr uint32_t t3 = pack_i8(-4, -6, -8, -12);
};

// IQ2_XXS / IQ2_XS / IQ2_S: magnitude index | sign << 2 (indexes 8..15
// never occur)
struct IQ2Table {
  static constexpr uint32_t t0 = pack_i8(8, 25, 43, 0);
  static constexpr uint32_t t1 = pack_i8(-8, -25, -43, 0);
  static constexpr uint32_t t2 = 0;
  static constexpr uint32_t t3 = 0;
};
// IQ3_XXS: magnitude index | sign << 3
struct IQ3XXSTable {
  static constexpr uint32_t t0 = pack_i8(4, 12, 20, 28);
  static constexpr uint32_t t1 = pack_i8(36, 44, 52, 62);
  static constexpr uint32_t t2 = pack_i8(-4, -12, -20, -28);
  static constexpr uint32_t t3 = pack_i8(-36, -44, -52, -62);
};
// IQ3_S: the odd values (2i + 1 for i < 8, then negated)
struct IQ3STable {
  static constexpr uint32_t t0 = pack_i8(1, 3, 5, 7);
  static constexpr uint32_t t1 = pack_i8(9, 11, 13, 15);
  static constexpr uint32_t t2 = pack_i8(-1, -3, -5, -7);
  static constexpr uint32_t t3 = pack_i8(-9, -11, -13, -15);
};

// The table values of the eight 4-bit indexes of w (nibble 2b: the low
// nibble of byte b, 2b + 1 its high one): .x holds those of the low
// nibbles (byte b of .x: byte b's), .y those of the high ones.  A byte
// permute picks one of eight bytes by the three low bits of a selector
// nibble, so each half of the table is looked up for four indexes at
// once, and a third permute keeps the half that bit 3 names; two more put
// the low and the high nibbles' values apart.
template <class T>
__device__ __forceinline__ uint2 lut16(uint32_t w) {
  uint32_t r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t s = (w >> (16 * h)) & 0xFFFFu;
    const uint32_t lo = __byte_perm(T::t0, T::t1, s & 0x7777u);
    const uint32_t hi = __byte_perm(T::t2, T::t3, s & 0x7777u);
    r[h] = __byte_perm(lo, hi, 0x3210u | ((s & 0x8888u) >> 1));
  }
  return make_uint2(__byte_perm(r[0], r[1], 0x6420u), __byte_perm(r[0], r[1], 0x7531u));
}

// MXFP4's scale 2^(e - 128) from its bits (ggml_e8m0_to_fp32_half): e = 0
// and 1 give the subnormals 2^-128 and 2^-127 (the library is built
// without fast math, so they are not flushed)
__device__ __forceinline__ float e8m0_half(uint32_t e) {
  return __uint_as_float(e < 2 ? 0x00200000u << e : (e - 1) << 23);
}

}  // namespace zt
