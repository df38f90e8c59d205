// K5: dequant GEMM for the formats without a nibble-pair layout, Q6_K and
// Q8_0: y[M, N] (f32) = bf16(x)[M, K] @ bf16(dequant(W)).
//
// Replaces zllm/ops/qmatmul.py::_qmm_kernel (launched by _qmm_call from
// qmatmul), instantiated for these two of its formats: the weight tile is
// dequantized in f32 as _dequant_tile does (Q6_K: ((ql | qh << 4) - 32) *
// f32(a); Q8_0: qs * f32(d)) and rounded to bf16; x (f32 or bf16) is
// rounded to bf16 in the kernel; the products are accumulated in f32.
//
// Bound on the H100: at prefill shapes (M = 256 rows a chunk) the 2*M*K*N
// bf16 FLOPs over the 989 TFLOP/s tensor-core peak.  Design: K3's tile
// loop (gemm_tile.cuh) with a decoder per format; a thread takes 32
// consecutive k of one column in each 64-wide step:
//   Q6_K step c (superblock c/4, quarter c%4): the 32 ql bytes whose low
//     (even quarter) or high (odd quarter) nibbles hold the 32 codes, the
//     32 qh bytes whose crumb 2(c%2) + half holds their top bits, and the
//     two 16-group scales.  ql is read twice and qh four times over a
//     superblock's four steps (from L1/L2): the GEMM is bound by its FLOPs.
//   Q8_0 step c: group 2c + half, 32 int8 codes and one scale.

#include "gemm_tile.cuh"

namespace {

using namespace zt;

__device__ __forceinline__ uint4 ld16(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ uint32_t byte_of(const uint4 (&v)[2], int i) {
  const uint32_t w[8] = {v[0].x, v[0].y, v[0].z, v[0].w, v[1].x, v[1].y, v[1].z, v[1].w};
  return (w[i >> 2] >> (8 * (i & 3))) & 0xFFu;
}

struct Q6KTile {
  const uint8_t* ql;  // [N, K/2]
  const uint8_t* qh;  // [N, K/4]
  const __half* a;    // [N, K/16]
  int K;
  struct Stage {
    uint4 l[2], h[2];
    float a0, a1;
    int nsh, csh;  // nibble and crumb shifts
  };
  __device__ __forceinline__ void fetch(Stage& st, size_t col, int c, int bh) const {
    const int sb = c >> 2, quarter = c & 3, half = quarter >> 1, odd = quarter & 1;
    const uint8_t* lp = ql + col * (K / 2) + sb * 128 + half * 64 + bh * 32;
    const uint8_t* hp = qh + col * (K / 4) + sb * 64 + half * 32;
    st.l[0] = ld16(lp);
    st.l[1] = ld16(lp + 16);
    st.h[0] = ld16(hp);
    st.h[1] = ld16(hp + 16);
    const int g = 4 * c + 2 * bh;  // the 16-groups of k = 64c + 32bh + [0, 32)
    st.a0 = __half2float(a[col * (K / 16) + g]);
    st.a1 = __half2float(a[col * (K / 16) + g + 1]);
    st.nsh = 4 * odd;
    st.csh = 2 * (2 * odd + bh);
  }
  __device__ __forceinline__ void dequant(const Stage& st, uint4 (&v)[4]) const {
    uint32_t o[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      float f[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t q = ((byte_of(st.l, i + e) >> st.nsh) & 0xFu) |
                           (((byte_of(st.h, i + e) >> st.csh) & 0x3u) << 4);
        f[e] = (float)((int)q - 32) * (i < 16 ? st.a0 : st.a1);
      }
      o[i >> 1] = pack_bf16(f[0], f[1]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = make_uint4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
  }
  __device__ __forceinline__ static int slot(int bh, int i) { return 4 * bh + i; }
};

struct Q80Tile {
  const int8_t* qs;  // [N, K]
  const __half* d;   // [N, K/32]
  int K;
  struct Stage {
    uint4 q[2];
    float d;
  };
  __device__ __forceinline__ void fetch(Stage& st, size_t col, int c, int bh) const {
    const int g = 2 * c + bh;
    const uint8_t* p = reinterpret_cast<const uint8_t*>(qs) + col * K + g * 32;
    st.q[0] = ld16(p);
    st.q[1] = ld16(p + 16);
    st.d = __half2float(d[col * (K / 32) + g]);
  }
  __device__ __forceinline__ void dequant(const Stage& st, uint4 (&v)[4]) const {
    uint32_t o[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float f0 = (float)(int8_t)byte_of(st.q, i) * st.d;
      const float f1 = (float)(int8_t)byte_of(st.q, i + 1) * st.d;
      o[i >> 1] = pack_bf16(f0, f1);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = make_uint4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
  }
  __device__ __forceinline__ static int slot(int bh, int i) { return 4 * bh + i; }
};

}  // namespace

// fmt: 0 = Q6_K (p0 = ql, p1 = qh, p2 = a), 1 = Q8_0 (p0 = qs, p1 = d).
// xdtype: 0 = f32, 1 = bf16.
extern "C" int zt_dequant_gemm(int fmt, const void* x, int xdtype, const void* p0,
                               const void* p1, const void* p2, float* y, int M, int K, int N,
                               void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (fmt == 0) {
    const Q6KTile w{static_cast<const uint8_t*>(p0), static_cast<const uint8_t*>(p1),
                    static_cast<const __half*>(p2), K};
    return zt::launch_gemm(x, xdtype, w, y, M, K, N, s);
  }
  if (fmt == 1) {
    const Q80Tile w{static_cast<const int8_t*>(p0), static_cast<const __half*>(p1), K};
    return zt::launch_gemm(x, xdtype, w, y, M, K, N, s);
  }
  return (int)cudaErrorInvalidValue;
}
