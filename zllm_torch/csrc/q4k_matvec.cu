// K1: Q4_K decode matvec (M = 1) on the int8 path.
//
// Replaces zllm/ops/qmatmul.py::_w4a8np_kernel (launched by
// _qmm_w4a8np_call): y[n] = sum_k prologue(x)[k] * W[k, n], with the
// activation row quantized to int8 per 32-group and the weight codes kept
// as 4-bit integers, so each group's dot is an exact integer:
//   c_g = pi_g * a_g * dx_g - b_g * (dx_g * sum(xq_g)),
//   a_g = f32(d) * sc_g, b_g = f32(dmin) * mn_g   (exact two-level Q4_K)
// Prologues: "q" (x as is), "norm" (rms_norm(x) * w, the full-row mean
// square reduced first), "glu" (silu(g) * u over the fused gate|up row),
// shared with K4 in matvec_common.cuh.
//
// Bound on the H100: the Q4_K bytes of the weight (4.5 bits a weight; this
// layout, with sc/mn unpacked to bytes, reads 4.625), read once; the arithmetic is 2*K*N int8 ops, ~1000x under the
// int8 peak.  Design: each block quantizes the activation row once into
// shared memory (int8 codes, f32 dx, int32 sums per group; eight lanes a
// group), then each warp
// streams whole output columns: a column's packed nibbles are contiguous
// along K (Q4KWeight layout, zllm_torch/quant/repack.py), so two lanes read
// one 64-element chunk as two 16-byte loads.  A warp issues all loads of
// a column (packed bytes and scales, up to 4 chunk rounds, in registers)
// before it uses any, and issues its first column's loads before the
// activation prologue, so HBM latency overlaps the quantization.  The low
// nibbles of four bytes are four codes of group 2c and the high nibbles
// four codes of group 2c+1, each against four int8 activations in one
// __dp4a.  A lane-pair shuffle joins the two halves of a chunk into exact
// integer group dots, and each lane applies its group's scales.

#include "matvec_common.cuh"

namespace {

using namespace zt;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

constexpr int kRounds = 4;  // chunk rounds (16 chunks each) held in registers

// one column's weight data for up to kRounds rounds of this lane
struct ColRegs {
  uint4 wv[kRounds];
  uint8_t scb[kRounds], mnb[kRounds];
  __half dh[kRounds], dmh[kRounds];
};

__device__ __forceinline__ void fetch_col(ColRegs& cr, const uint8_t* qs, const uint8_t* sc,
                                          const uint8_t* mn, const __half* d,
                                          const __half* dmin, int n, int K, int c_base,
                                          int lane) {
  const int nchunk = K / 64, G = K / 32, part = lane & 1;
#pragma unroll
  for (int it = 0; it < kRounds; ++it) {
    const int c = c_base + it * 16 + (lane >> 1);
    if (c < nchunk) {
      const int g = 2 * c + part;
      cr.wv[it] = *reinterpret_cast<const uint4*>(qs + (size_t)n * (K / 2) + c * 32 + part * 16);
      cr.scb[it] = sc[(size_t)n * G + g];
      cr.mnb[it] = mn[(size_t)n * G + g];
      cr.dh[it] = d[(size_t)n * (K / 256) + (g >> 3)];
      cr.dmh[it] = dmin[(size_t)n * (K / 256) + (g >> 3)];
    }
  }
}

template <typename TX, int MODE>
__global__ void __launch_bounds__(kThreads) q4k_matvec_kernel(
    const TX* __restrict__ x, const float* __restrict__ aux,
    const uint8_t* __restrict__ qs, const uint8_t* __restrict__ sc,
    const uint8_t* __restrict__ mn, const __half* __restrict__ d,
    const __half* __restrict__ dmin, float* __restrict__ y, int K, int N,
    int cols_per_warp, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const QuantRow<32> row(smem, K);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nchunk = K / 64;
  const int part = lane & 1;

  // the first column's weights are in flight while the activations are
  // prepared
  ColRegs cr;
  const int n0 = blockIdx.x * cols_per_warp * kWarps + warp;
  if (n0 < N) fetch_col(cr, qs, sc, mn, d, dmin, n0, K, 0, lane);
  quantize_row<TX, MODE, 32, kThreads>(x, aux, K, eps, row);

  for (int j = 0; j < cols_per_warp; ++j) {
    const int n = (blockIdx.x * cols_per_warp + j) * kWarps + warp;
    if (n >= N) break;
    float acc = 0.f;
    for (int c_base = 0; c_base < nchunk; c_base += 16 * kRounds) {
      if (j > 0 || c_base > 0) fetch_col(cr, qs, sc, mn, d, dmin, n, K, c_base, lane);
#pragma unroll
      for (int it = 0; it < kRounds; ++it) {
        if (c_base + it * 16 >= nchunk) break;  // uniform across the warp
        const int c = c_base + it * 16 + (lane >> 1);
        int plo = 0, phi = 0;
        if (c < nchunk) {
          const uint4 wv = cr.wv[it];
          const int4 xl = *reinterpret_cast<const int4*>(row.xq + c * 64 + part * 16);
          const int4 xh = *reinterpret_cast<const int4*>(row.xq + c * 64 + 32 + part * 16);
          plo = __dp4a((int)(wv.x & 0x0F0F0F0Fu), xl.x, plo);
          phi = __dp4a((int)((wv.x >> 4) & 0x0F0F0F0Fu), xh.x, phi);
          plo = __dp4a((int)(wv.y & 0x0F0F0F0Fu), xl.y, plo);
          phi = __dp4a((int)((wv.y >> 4) & 0x0F0F0F0Fu), xh.y, phi);
          plo = __dp4a((int)(wv.z & 0x0F0F0F0Fu), xl.z, plo);
          phi = __dp4a((int)((wv.z >> 4) & 0x0F0F0F0Fu), xh.z, phi);
          plo = __dp4a((int)(wv.w & 0x0F0F0F0Fu), xl.w, plo);
          phi = __dp4a((int)((wv.w >> 4) & 0x0F0F0F0Fu), xh.w, phi);
        }
        plo += __shfl_xor_sync(kFull, plo, 1);
        phi += __shfl_xor_sync(kFull, phi, 1);
        if (c < nchunk) {
          // even lane takes group 2c (low nibbles), odd lane group 2c+1
          const int g = 2 * c + part;
          const int pi = part ? phi : plo;
          const float a = __half2float(cr.dh[it]) * (float)cr.scb[it];
          const float b = __half2float(cr.dmh[it]) * (float)cr.mnb[it];
          const float dx = row.dx[g];
          acc += (float)pi * a * dx - b * (dx * (float)row.sx[g]);
        }
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) y[n] = acc;
  }
}

template <typename TX, int MODE>
int launch(const void* x, const float* aux, const uint8_t* qs, const uint8_t* sc,
           const uint8_t* mn, const __half* d, const __half* dmin, float* y, int K, int N,
           float eps, cudaStream_t stream) {
  // more columns per warp when N is wide, so a block's prologue is shared
  // by more columns while the grid still covers every SM twice
  int cpw = N / (kWarps * 2 * 132);
  cpw = cpw < 1 ? 1 : (cpw > 4 ? 4 : cpw);
  const int per_block = kWarps * cpw;
  const dim3 grid((N + per_block - 1) / per_block);
  q4k_matvec_kernel<TX, MODE><<<grid, kThreads, QuantRow<32>::bytes(K), stream>>>(
      static_cast<const TX*>(x), aux, qs, sc, mn, d, dmin, y, K, N, cpw, eps);
  return (int)cudaGetLastError();
}

template <typename TX>
int launch_mode(int mode, const void* x, const float* aux, const uint8_t* qs,
                const uint8_t* sc, const uint8_t* mn, const __half* d, const __half* dmin,
                float* y, int K, int N, float eps, cudaStream_t s) {
  switch (mode) {
    case kQ: return launch<TX, kQ>(x, aux, qs, sc, mn, d, dmin, y, K, N, eps, s);
    case kNorm: return launch<TX, kNorm>(x, aux, qs, sc, mn, d, dmin, y, K, N, eps, s);
    case kGlu: return launch<TX, kGlu>(x, aux, qs, sc, mn, d, dmin, y, K, N, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16.  mode: 0 = q, 1 = norm, 2 = glu.
extern "C" int zt_q4k_matvec(const void* x, int x_dtype, const float* aux,
                             const uint8_t* qs, const uint8_t* sc, const uint8_t* mn,
                             const void* d, const void* dmin, float* y, int K, int N,
                             int mode, float eps, void* stream) {
  if (K % 256 != 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const __half* dh = static_cast<const __half*>(d);
  const __half* dmh = static_cast<const __half*>(dmin);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return launch_mode<float>(mode, x, aux, qs, sc, mn, dh, dmh, y, K, N, eps, s);
  if (x_dtype == 1)
    return launch_mode<__nv_bfloat16>(mode, x, aux, qs, sc, mn, dh, dmh, y, K, N, eps, s);
  return (int)cudaErrorInvalidValue;
}
