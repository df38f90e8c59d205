// K4: decode matvec (M = 1) on the int8 path for the formats whose weight
// is a signed integer code times one scale a group, with no min term:
// Q6_K (16-groups) and Q8_0 (32-groups).
//
// Replaces zllm/ops/qmatmul.py::_w4a8_kernel (launched by _qmm_w4a8_call
// from qmatmul_w4a8, qmatvec_norm and qmatvec_glu), instantiated for these
// two of its _INT_FMT formats: y[n] = sum_g pi_g * a_g * dx_g, where the
// activation row is quantized to int8 per group (the prologue of
// matvec_common.cuh, shared with K1: group 16 for Q6_K, 32 for Q8_0) and
// pi_g is the exact integer dot of the group's int8 activations with the
// weight's signed codes (Q6_K: (ql | qh << 4) - 32 in -32..31; Q8_0: the
// stored int8), a_g the group scale (Q6_K: the fp16 plane a; Q8_0: d).
//
// Bound on the H100: the weight bytes, read once (Q6_K: 210 bytes per 256
// weights in the GGUF, 224 in this layout, whose scale plane a is fp16 per
// 16-group; Q8_0: 34 per 32); 2*K*N int8 operations are ~1000x under the
// int8 peak.  Design, as K1's: every block quantizes the activation row
// into shared memory, then each warp streams whole output columns, the
// column's planes contiguous along K (Q6KWeight / Q80Weight layouts,
// zllm_torch/quant/repack.py).  A lane takes one 32-element slot a round,
// so a warp reads 1024 weights of a column per round with 16-byte loads:
//   Q6_K slot c (superblock c/8, half h, quarter t): 16 ql bytes whose low
//     nibbles are the 16 codes of one group and high nibbles those of the
//     group 64 elements on, and the 16 qh bytes that hold their top bits
//     (crumbs t/2 and 2 + t/2); four __dp4a a group;
//   Q8_0 slot c: the 32 codes of group c, eight __dp4a.
// Q6_K's unsigned codes q = ql | qh << 4 (0..63) go into __dp4a as they
// are and the bias comes off the integer dot: sum (q - 32) x = sum q x -
// 32 sum x, with sum x the group's code sum from the prologue; a 16-group
// dot is at most 16 * 63 * 127 < 2^24, so both are exact.  A warp issues
// all loads of up to kRounds rounds of a column before it uses any, and
// its first column's loads before the prologue.

#include "matvec_common.cuh"

namespace {

using namespace zt;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;  // slot rounds (32 slots each) held in registers

__device__ __forceinline__ uint4 ld16(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

struct Q6K {
  static constexpr int kGroup = 16;
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
  static constexpr int kGroup = 32;
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

template <typename TX, int MODE, class F>
__global__ void __launch_bounds__(kThreads) int8_matvec_kernel(
    const TX* __restrict__ x, const float* __restrict__ aux, const F f,
    float* __restrict__ y, int K, int N, int cols_per_warp, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const QuantRow<F::kGroup> row(smem, K);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nslot = K / 32;
  typename F::Slot sl[kRounds];

  auto fetch = [&](int n, int base) {
#pragma unroll
    for (int it = 0; it < kRounds; ++it) {
      const int c = base + it * 32 + lane;
      if (c < nslot) f.fetch(sl[it], (size_t)n, K, c);
    }
  };

  // the first column's weights are in flight while the activations are
  // prepared
  const int n0 = blockIdx.x * cols_per_warp * kWarps + warp;
  if (n0 < N) fetch(n0, 0);
  quantize_row<TX, MODE, F::kGroup, kThreads>(x, aux, K, eps, row);

  for (int j = 0; j < cols_per_warp; ++j) {
    const int n = (blockIdx.x * cols_per_warp + j) * kWarps + warp;
    if (n >= N) break;
    float acc = 0.f;
    for (int base = 0; base < nslot; base += 32 * kRounds) {
      if (j > 0 || base > 0) fetch(n, base);
#pragma unroll
      for (int it = 0; it < kRounds; ++it) {
        const int c = base + it * 32 + lane;
        if (c < nslot) acc += f.dot(sl[it], c, row);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) y[n] = acc;
  }
}

template <typename TX, int MODE, class F>
int launch(const void* x, const float* aux, const F& f, float* y, int K, int N, float eps,
           cudaStream_t stream) {
  // more columns per warp when N is wide, so a block's prologue is shared
  // by more columns while the grid still covers every SM twice (as K1)
  int cpw = N / (kWarps * 2 * 132);
  cpw = cpw < 1 ? 1 : (cpw > 4 ? 4 : cpw);
  const int per_block = kWarps * cpw;
  const dim3 grid((N + per_block - 1) / per_block);
  int8_matvec_kernel<TX, MODE, F><<<grid, kThreads, QuantRow<F::kGroup>::bytes(K), stream>>>(
      static_cast<const TX*>(x), aux, f, y, K, N, cpw, eps);
  return (int)cudaGetLastError();
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

// fmt: 0 = Q6_K (p0 = ql, p1 = qh, p2 = a), 1 = Q8_0 (p0 = qs, p1 = d).
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
  return (int)cudaErrorInvalidValue;
}
