// K3: prefill GEMM of the nibble formats Q4_K, Q4_0 and Q4_1,
// y[M, N] (f32) = bf16(x)[M, K] @ bf16(dequant(W)).
//
// Replaces zllm/ops/qmatmul.py::_qmm_np_kernel (launched by _qmm_np_call):
// the weight is dequantized in f32 with zllm's expressions and rounded to
// bf16 (Q4_K: code * f32(d)*sc - f32(dmin)*mn, the exact two-level scales;
// Q4_1: code * a - b; Q4_0: (code - 8) * d); x (f32 or bf16) is rounded to
// bf16 in the kernel, round to nearest even, as the Pallas kernel rounds
// it; the products are accumulated in f32.
//
// Bound on the H100: at prefill shapes (M = 256 rows a chunk) the
// 2*M*K*N bf16 FLOPs over the 989 TFLOP/s tensor-core peak; the weight
// bytes are read once per 64-row block of x.  Design (simple first): the
// tile loop of gemm_tile.cuh (shared with K5), whose 64-wide K step is one
// 64-element chunk of the nibble layout: a thread takes 16 of a column's 32
// packed bytes, the low nibbles 16 codes of group 2c and the high nibbles
// 16 of group 2c+1; one decoder per format differs only in its scale
// fetch and its dequantizing expression.

#include "gemm_tile.cuh"
#include "matvec_common.cuh"

namespace {

using namespace zt;

template <int FMT>
struct NibbleTile {
  NibblePlanes p;  // qs [N, K/2] and the format's scale planes
  int K;
  struct Stage {
    uint4 wv;  // 32 packed nibbles
    float alo, blo, ahi, bhi;
  };
  __device__ __forceinline__ void fetch(Stage& st, size_t col, int c, int bh) const {
    const int G = K / 32;
    st.wv = *reinterpret_cast<const uint4*>(p.qs + col * (K / 2) + c * 32 + bh * 16);
    const int g = 2 * c;  // groups 2c (low nibbles) and 2c+1 (high)
    if constexpr (FMT == kQ4K) {  // one superblock
      const uint8_t* sc = static_cast<const uint8_t*>(p.s0);
      const uint8_t* mn = static_cast<const uint8_t*>(p.s1);
      const float dd = __half2float(static_cast<const __half*>(p.s2)[col * (K / 256) + (g >> 3)]);
      const float dm = __half2float(static_cast<const __half*>(p.s3)[col * (K / 256) + (g >> 3)]);
      st.alo = dd * (float)sc[col * G + g];
      st.blo = dm * (float)mn[col * G + g];
      st.ahi = dd * (float)sc[col * G + g + 1];
      st.bhi = dm * (float)mn[col * G + g + 1];
    } else {
      const __half* a = static_cast<const __half*>(p.s0);
      st.alo = __half2float(a[col * G + g]);
      st.ahi = __half2float(a[col * G + g + 1]);
      st.blo = st.bhi = 0.f;  // Q4_0 has no min term
      if constexpr (FMT == kQ41) {
        const __half* b = static_cast<const __half*>(p.s1);
        st.blo = __half2float(b[col * G + g]);
        st.bhi = __half2float(b[col * G + g + 1]);
      }
    }
  }
  __device__ __forceinline__ static float weight(uint32_t q, float a, float b) {
    if constexpr (FMT == kQ40) return ((float)q - 8.f) * a;
    return (float)q * a - b;
  }
  // v[0..1]: the low nibbles (k = 16bh .. 16bh+15 of the step), v[2..3]:
  // the high nibbles (k = 32 + 16bh ..)
  __device__ __forceinline__ void dequant(const Stage& st, uint4 (&v)[4]) const {
    uint32_t lo[8], hi[8];
    const uint32_t words[4] = {st.wv.x, st.wv.y, st.wv.z, st.wv.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t b0 = (words[w] >> (16 * h)) & 0xFFu;
        const uint32_t b1 = (words[w] >> (16 * h + 8)) & 0xFFu;
        lo[2 * w + h] = pack_bf16(weight(b0 & 0xFu, st.alo, st.blo),
                                  weight(b1 & 0xFu, st.alo, st.blo));
        hi[2 * w + h] = pack_bf16(weight(b0 >> 4, st.ahi, st.bhi),
                                  weight(b1 >> 4, st.ahi, st.bhi));
      }
    }
    v[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    v[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    v[2] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    v[3] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
  }
  __device__ __forceinline__ static int slot(int bh, int i) {
    return (i >> 1) * 4 + bh * 2 + (i & 1);
  }
};

}  // namespace

// fmt: 0 = Q4_K, 1 = Q4_0, 2 = Q4_1 (scale planes s0..s3 as NibblePlanes in
// matvec_common.cuh).  xdtype: 0 = f32, 1 = bf16.
extern "C" int zt_q4k_gemm(int fmt, const void* x, int xdtype, const uint8_t* qs, const void* s0,
                           const void* s1, const void* s2, const void* s3, float* y, int M,
                           int K, int N, void* stream) {
  const NibblePlanes p{qs, s0, s1, s2, s3};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case kQ4K: return zt::launch_gemm(x, xdtype, NibbleTile<kQ4K>{p, K}, y, M, K, N, s);
    case kQ40: return zt::launch_gemm(x, xdtype, NibbleTile<kQ40>{p, K}, y, M, K, N, s);
    case kQ41: return zt::launch_gemm(x, xdtype, NibbleTile<kQ41>{p, K}, y, M, K, N, s);
  }
  return (int)cudaErrorInvalidValue;
}
