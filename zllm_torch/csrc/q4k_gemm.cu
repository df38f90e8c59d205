// K3: prefill GEMM of the nibble formats Q4_K, Q4_0, Q4_1, Q5_0, Q5_1 and
// Q5_K, y[M, N] (f32) = bf16(x)[M, K] @ bf16(dequant(W)).
//
// Replaces zllm/ops/qmatmul.py::_qmm_np_kernel (launched by _qmm_np_call):
// the weight is dequantized in f32 with zllm's expressions and rounded to
// bf16, round to nearest even (Q4_K: code * f32(d)*sc - f32(dmin)*mn, the
// exact two-level scales; Q4_1, Q5_1 and Q5_K: code * a - b, Q5_K's a and b
// the fp16-rounded products zllm's repack stores; Q4_0: (code - 8) * d;
// Q5_0: (code - 16) * d; every product is exact in f32, so each value is
// rounded at most twice, as zllm's expressions round it); x (f32 or bf16)
// is rounded to bf16, round to nearest even, as the Pallas kernel rounds
// it; the products are summed in f32 in K5's order, one partial per
// 512-wide (or 256-wide) k-slice added in slice order, so a row's bits do
// not depend on M.  zllm's own k-step here is 256 x a multiplier that
// depends on M (the VMEM window of _qmm_np_call): no one order matches it
// at every M, and the port keeps the one that is the same at every M.
//
// Bound on the H100: at the engine's decode M = 4 the weight bytes over
// 3.35 TB/s (144 bytes per 256 Q4_K weights); at prefill shapes (M = 256
// rows a chunk) the 2*M*K*N bf16 FLOPs over the 989 TFLOP/s tensor-core
// peak.  Design: the sliced loop of gemm_slice.cuh, K5's, so that M = 4
// runs its split-K row form (a grid of columns x slices instead of N/64
// blocks walking all of K) and a chunk its 128 x 128 tile form (a weight
// step dequantized once for 128 rows, a 4-stage cp.async ring, one barrier
// a step).  On the card (`python -m zllm_torch.k5_ablation --fmt q4_k`)
// the tile form is paced by its shared-memory fragment reloads, as K5's
// is, and the row form at M = 4 by its launches (the reduction's most).
// One decoder per format, `NibbleSlice`: byte 32c + i of a column's qs row
// holds the codes 64c + i (low nibble) and 64c + 32 + i (high), so in
// step c thread q of the column copies the 8 bytes 32c + 8q.. once, and
// dequantizes them to k = 64c + 8q.. (low) and 64c + 32 + 8q.. (high),
// the units q and 4 + q of the weight row.  Every thread needs the scales
// of groups 2c and 2c + 1, which lie in one 4-byte word of each plane: the
// column's four threads copy one word each (Q4_K: sc, mn, d, dmin; Q4_1,
// Q5_1, Q5_K: a, b, a, b; Q4_0, Q5_0: d each) and exchange them with
// __shfl_sync.  The 5-bit formats' thread q also copies the qh word 2c + q
// / 2 into the free half of its 16-byte ring piece (bytes q % 2 and 2 + q %
// 2 of it hold the fifth bits of its low and high nibbles' codes, the
// order of zllm_torch/quant/repack.py) and ORs them into bit 4 of each code
// byte before the byte permute (fifth_bits4, matvec_common.cuh).

#include "gemm_slice.cuh"
#include "matvec_common.cuh"

namespace {

using namespace zt;
using zt_slice::cp_async4;
using zt_slice::cp_async8;

__device__ __forceinline__ float half_of(uint32_t word, int i) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(word >> (16 * i))));
}

// four codes (the bytes of b) less `off`, times a, less c, as two bf16
// pairs; a byte u becomes the float 2^23 + u by a byte permute (no
// int-to-float conversion), exact, and less 2^23 + off the code, exact
__device__ __forceinline__ uint2 nibble4(uint32_t b, float off, float a, float c) {
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = (__int_as_float(__byte_perm(b, 0x4B000000u, 0x7440 | e)) - off) * a - c;
  return make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
}

template <int FMT>
struct NibbleSlice {
  NibblePlanes p;  // qs [N, K/2] and the format's scale planes
  int K;
  static constexpr int kPieces = 1;  // 8 of its 16 bytes used
  // v[0] (low nibbles) is k 8q.. of the step, v[1] (high) k 32 + 8q..
  __device__ __forceinline__ static int slot(int q, int i) { return q + 4 * i; }
  __device__ __forceinline__ void fetch(uint4* pc, int, uint32_t* word, size_t col, int c,
                                        int q) const {
    cp_async8(pc, p.qs + col * (K / 2) + 32 * c + 8 * q);
    const size_t G = K / 32;
    if constexpr (kHasQh<FMT>)  // bytes 8..11 of the piece: qh word 2c + q / 2
      cp_async4(reinterpret_cast<unsigned char*>(pc) + 8,
                static_cast<const uint32_t*>(p.s3) + col * G + 2 * c + (q >> 1));
    if constexpr (FMT == kQ4K) {  // sc, mn: bytes 2c, 2c + 1; d, dmin: superblock c / 4
      if (q < 2)
        cp_async4(word, static_cast<const uint8_t*>(q ? p.s1 : p.s0) + col * G + (2 * c & ~3));
      else
        cp_async4(word, static_cast<const __half*>(q == 2 ? p.s2 : p.s3) +
                            ((col * (K / 256) + (c >> 2)) & ~(size_t)1));
    } else {  // Q4_1, Q5_1, Q5_K a (even q), b (odd q); Q4_0, Q5_0 d: halves 2c, 2c + 1
      constexpr bool kHasB = FMT == kQ41 || FMT == kQ51 || FMT == kQ5K;
      const void* plane = (kHasB && (q & 1)) ? p.s1 : p.s0;
      cp_async4(word, static_cast<const __half*>(plane) + col * G + 2 * c);
    }
  }
  __device__ __forceinline__ void dequant(const uint4* pc, const uint4*, int, uint32_t word,
                                          size_t col, int c, int q, uint4 (&v)[2]) const {
    float alo, ahi, blo = 0.f, bhi = 0.f, off = 8388608.f;
    if constexpr (FMT == kQ4K) {
      const uint32_t wsc = __shfl_sync(kFull, word, 0, 4), wmn = __shfl_sync(kFull, word, 1, 4);
      const uint32_t wd = __shfl_sync(kFull, word, 2, 4), wdm = __shfl_sync(kFull, word, 3, 4);
      const int sh = 8 * (2 * c & 3), h = (int)((col * (K / 256) + (c >> 2)) & 1);
      const float d = half_of(wd, h), dm = half_of(wdm, h);
      alo = d * (float)((wsc >> sh) & 0xFFu);
      ahi = d * (float)((wsc >> (sh + 8)) & 0xFFu);
      blo = dm * (float)((wmn >> sh) & 0xFFu);
      bhi = dm * (float)((wmn >> (sh + 8)) & 0xFFu);
    } else if constexpr (FMT == kQ41 || FMT == kQ51 || FMT == kQ5K) {
      const uint32_t wa = __shfl_sync(kFull, word, 0, 4), wb = __shfl_sync(kFull, word, 1, 4);
      alo = half_of(wa, 0);
      ahi = half_of(wa, 1);
      blo = half_of(wb, 0);
      bhi = half_of(wb, 1);
    } else {
      alo = half_of(word, 0);
      ahi = half_of(word, 1);
      off += FMT == kQ50 ? 16.f : 8.f;
    }
    const uint4 b = pc[0];
    uint32_t cl0 = b.x & 0x0F0F0F0Fu, cl1 = b.y & 0x0F0F0F0Fu;
    uint32_t ch0 = (b.x >> 4) & 0x0F0F0F0Fu, ch1 = (b.y >> 4) & 0x0F0F0F0Fu;
    if constexpr (kHasQh<FMT>) {  // bits 0-15 of hq: the low nibbles', 16-31 the high ones'
      const uint32_t hq = b.z >> (8 * (q & 1));
      cl0 |= fifth_bits4(hq, 0);
      cl1 |= fifth_bits4(hq, 1);
      ch0 |= fifth_bits4(hq, 4);
      ch1 |= fifth_bits4(hq, 5);
    }
    const uint2 l0 = nibble4(cl0, off, alo, blo), l1 = nibble4(cl1, off, alo, blo),
                h0 = nibble4(ch0, off, ahi, bhi), h1 = nibble4(ch1, off, ahi, bhi);
    v[0] = make_uint4(l0.x, l0.y, l1.x, l1.y);
    v[1] = make_uint4(h0.x, h0.y, h1.x, h1.y);
  }
};

}  // namespace

// fmt: 0 = Q4_K, 1 = Q4_0, 2 = Q4_1, 3 = Q5_0, 4 = Q5_1, 5 = Q5_K (qs,
// scale planes s0..s3 and the 5-bit formats' qh as s3, as NibblePlanes in
// matvec_common.cuh).  xdtype, xb, tk, form, spb and ws as
// for zt_slice::launch_slice_gemm: an f32 x adds a launch that rounds it
// into xb, a call with spb < K / tk one that reduces the slice partials in
// order.
extern "C" int zt_q4k_gemm(int fmt, const void* x, int xdtype, void* xb, const uint8_t* qs,
                           const void* s0, const void* s1, const void* s2, const void* s3,
                           float* y, float* ws, int M, int K, int N, int tk, int form, int spb,
                           void* stream) {
  const NibblePlanes p{qs, s0, s1, s2, s3};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case kQ4K:
      return zt_slice::launch_slice_gemm(x, xdtype, xb, NibbleSlice<kQ4K>{p, K}, y, ws, M, K, N,
                                         tk, form, spb, s);
    case kQ40:
      return zt_slice::launch_slice_gemm(x, xdtype, xb, NibbleSlice<kQ40>{p, K}, y, ws, M, K, N,
                                         tk, form, spb, s);
    case kQ41:
      return zt_slice::launch_slice_gemm(x, xdtype, xb, NibbleSlice<kQ41>{p, K}, y, ws, M, K, N,
                                         tk, form, spb, s);
    case kQ50:
      return zt_slice::launch_slice_gemm(x, xdtype, xb, NibbleSlice<kQ50>{p, K}, y, ws, M, K, N,
                                         tk, form, spb, s);
    case kQ51:
      return zt_slice::launch_slice_gemm(x, xdtype, xb, NibbleSlice<kQ51>{p, K}, y, ws, M, K, N,
                                         tk, form, spb, s);
    case kQ5K:
      return zt_slice::launch_slice_gemm(x, xdtype, xb, NibbleSlice<kQ5K>{p, K}, y, ws, M, K, N,
                                         tk, form, spb, s);
  }
  return (int)cudaErrorInvalidValue;
}
