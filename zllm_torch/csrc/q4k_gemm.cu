// K3: Q4_K prefill GEMM, y[M, N] (f32) = bf16(x)[M, K] @ bf16(dequant(W)).
//
// Replaces zllm/ops/qmatmul.py::_qmm_np_kernel (launched by _qmm_np_call):
// the weight is dequantized with the exact two-level Q4_K scales
// (w = code * f32(d)*sc - f32(dmin)*mn, in f32) and rounded to bf16; x
// (f32 or bf16) is rounded to bf16 in the kernel, round to nearest even,
// as the Pallas kernel rounds it; the products are accumulated in f32.
//
// Bound on the H100: at prefill shapes (M = 256 rows a chunk) the
// 2*M*K*N bf16 FLOPs over the 989 TFLOP/s tensor-core peak; the weight
// bytes are read once per 64-row block of x.  Design (simple first): the
// tile loop of gemm_tile.cuh (shared with K5), whose 64-wide K step is one
// Q4_K chunk: a thread takes 16 of a column's 32 packed bytes, the low
// nibbles 16 codes of group 2c and the high nibbles 16 of group 2c+1.

#include "gemm_tile.cuh"

namespace {

using namespace zt;

struct Q4KTile {
  const uint8_t* qs;    // [N, K/2]
  const uint8_t* sc;    // [N, K/32]
  const uint8_t* mn;    // [N, K/32]
  const __half* d;      // [N, K/256]
  const __half* dmin;   // [N, K/256]
  int K;
  struct Stage {
    uint4 wv;  // 32 packed nibbles
    float alo, blo, ahi, bhi;
  };
  __device__ __forceinline__ void fetch(Stage& st, size_t col, int c, int bh) const {
    const int G = K / 32;
    st.wv = *reinterpret_cast<const uint4*>(qs + col * (K / 2) + c * 32 + bh * 16);
    const int g = 2 * c;  // groups 2c (low nibbles) and 2c+1 (high); one superblock
    const float dd = __half2float(d[col * (K / 256) + (g >> 3)]);
    const float dm = __half2float(dmin[col * (K / 256) + (g >> 3)]);
    st.alo = dd * (float)sc[col * G + g];
    st.blo = dm * (float)mn[col * G + g];
    st.ahi = dd * (float)sc[col * G + g + 1];
    st.bhi = dm * (float)mn[col * G + g + 1];
  }
  // v[0..1]: the low nibbles (k = 16bh .. 16bh+15 of the step), v[2..3]:
  // the high nibbles (k = 32 + 16bh ..)
  __device__ __forceinline__ void dequant(const Stage& st, uint4 (&v)[4]) const {
    uint32_t lo[8], hi[8];
    const uint32_t words[4] = {st.wv.x, st.wv.y, st.wv.z, st.wv.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint32_t b0 = (words[w] >> (16 * p)) & 0xFFu;
        const uint32_t b1 = (words[w] >> (16 * p + 8)) & 0xFFu;
        lo[2 * w + p] = pack_bf16((float)(b0 & 0xFu) * st.alo - st.blo,
                                  (float)(b1 & 0xFu) * st.alo - st.blo);
        hi[2 * w + p] = pack_bf16((float)(b0 >> 4) * st.ahi - st.bhi,
                                  (float)(b1 >> 4) * st.ahi - st.bhi);
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

// xdtype: 0 = f32, 1 = bf16
extern "C" int zt_q4k_gemm(const void* x, int xdtype, const uint8_t* qs, const uint8_t* sc,
                           const uint8_t* mn, const void* d, const void* dmin, float* y,
                           int M, int K, int N, void* stream) {
  const Q4KTile w{qs, sc, mn, static_cast<const __half*>(d), static_cast<const __half*>(dmin),
                  K};
  return zt::launch_gemm(x, xdtype, w, y, M, K, N, static_cast<cudaStream_t>(stream));
}
