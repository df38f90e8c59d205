// K1: decode matvec (M = 1) of the nibble formats Q4_K, Q4_0 and Q4_1 on
// the int8 path.
//
// Replaces zllm/ops/qmatmul.py::_w4a8np_kernel (launched by
// _qmm_w4a8np_call): y[n] = sum_k prologue(x)[k] * W[k, n], with the
// activation row quantized to int8 per 32-group and the weight codes kept
// as 4-bit integers, so each group's dot is an exact integer; each group
// then takes zllm's f32 epilogue (GroupScale in matvec_common.cuh):
//   Q4_K: pi_g * a_g * dx_g - b_g * (dx_g * sum(xq_g)),
//         a_g = f32(d) * sc_g, b_g = f32(dmin) * mn_g   (exact two-level)
//   Q4_1: the same with a = d and b = -m of the group (fp16 planes)
//   Q4_0: (pi_g - 8 * sum(xq_g)) * d_g * dx_g, the -8 applied in integers
// Prologues: "q" (x as is), "norm" (rms_norm(x) * w, the full-row mean
// square reduced first), "glu" (silu(g) * u over the fused gate|up row),
// shared with K4 in matvec_common.cuh.
//
// Bound on the H100: the weight bytes, read once (Q4_K 4.5 bits a weight,
// this layout with sc/mn unpacked to bytes 4.625; Q4_0 4.5; Q4_1 5); the
// arithmetic is 2*K*N int8 ops, ~1000x under the int8 peak.  Design: each
// block quantizes the activation row once into shared memory (int8 codes,
// f32 dx, int32 sums per group; eight lanes a group), then each warp
// streams whole output columns: a column's packed nibbles are contiguous
// along K in every format (zllm_torch/quant/repack.py), so two lanes read
// one 64-element chunk as two 16-byte loads.  A warp issues all loads of
// a column (packed bytes and scales, up to 4 chunk rounds, in registers)
// before it uses any, and issues its first column's loads before the
// activation prologue, so HBM latency overlaps the quantization.  The low
// nibbles of four bytes are four codes of group 2c and the high nibbles
// four codes of group 2c+1, each against four int8 activations in one
// __dp4a.  A lane-pair shuffle joins the two halves of a chunk into exact
// integer group dots, and each lane applies its group's scales.  Only the
// scale fetch and the epilogue depend on the format (template FMT).

#include "matvec_common.cuh"

namespace {

using namespace zt;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

constexpr int kRounds = 4;  // chunk rounds (16 chunks each) held in registers

// At least four blocks an SM (at most 64 registers a thread): left free,
// nvcc gives the Q4_K form 104 registers, two blocks an SM, and a decode
// step's matvecs then take 13-16 % longer on the H100.
template <typename TX, int MODE, int FMT>
__global__ void __launch_bounds__(kThreads, 4) q4k_matvec_kernel(
    const TX* __restrict__ x, const float* __restrict__ aux, const NibblePlanes w,
    float* __restrict__ y, int K, int N, int cols_per_warp, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const QuantRow<32> row(smem, K);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nchunk = K / 64;
  const int part = lane & 1;

  // the first column's weights are in flight while the activations are
  // prepared
  ColRegs<FMT, kRounds> cr;
  const int n0 = blockIdx.x * cols_per_warp * kWarps + warp;
  if (n0 < N) fetch_col(cr, w, n0, K, 0, lane);
  quantize_row<TX, MODE, 32, kThreads>(x, aux, K, eps, row);

  for (int j = 0; j < cols_per_warp; ++j) {
    const int n = (blockIdx.x * cols_per_warp + j) * kWarps + warp;
    if (n >= N) break;
    float acc = 0.f;
    for (int c_base = 0; c_base < nchunk; c_base += 16 * kRounds) {
      if (j > 0 || c_base > 0) fetch_col(cr, w, n, K, c_base, lane);
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
          acc += group_term(cr.s[it], part ? phi : plo, row.sx[g], row.dx[g]);
        }
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) y[n] = acc;
  }
}

template <typename TX, int MODE, int FMT>
int launch(const void* x, const float* aux, const NibblePlanes& w, float* y, int K, int N,
           float eps, cudaStream_t stream) {
  // more columns per warp when N is wide, so a block's prologue is shared
  // by more columns while the grid still covers every SM twice
  int cpw = N / (kWarps * 2 * 132);
  cpw = cpw < 1 ? 1 : (cpw > 4 ? 4 : cpw);
  const int per_block = kWarps * cpw;
  const dim3 grid((N + per_block - 1) / per_block);
  q4k_matvec_kernel<TX, MODE, FMT><<<grid, kThreads, QuantRow<32>::bytes(K), stream>>>(
      static_cast<const TX*>(x), aux, w, y, K, N, cpw, eps);
  return (int)cudaGetLastError();
}

template <typename TX, int FMT>
int launch_mode(int mode, const void* x, const float* aux, const NibblePlanes& w, float* y,
                int K, int N, float eps, cudaStream_t s) {
  switch (mode) {
    case kQ: return launch<TX, kQ, FMT>(x, aux, w, y, K, N, eps, s);
    case kNorm: return launch<TX, kNorm, FMT>(x, aux, w, y, K, N, eps, s);
    case kGlu: return launch<TX, kGlu, FMT>(x, aux, w, y, K, N, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename TX>
int launch_fmt(int fmt, int mode, const void* x, const float* aux, const NibblePlanes& w,
               float* y, int K, int N, float eps, cudaStream_t s) {
  switch (fmt) {
    case kQ4K: return launch_mode<TX, kQ4K>(mode, x, aux, w, y, K, N, eps, s);
    case kQ40: return launch_mode<TX, kQ40>(mode, x, aux, w, y, K, N, eps, s);
    case kQ41: return launch_mode<TX, kQ41>(mode, x, aux, w, y, K, N, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// fmt: 0 = Q4_K, 1 = Q4_0, 2 = Q4_1 (scale planes s0..s3 as NibblePlanes in
// matvec_common.cuh).  x_dtype: 0 = float32, 1 = bfloat16.  mode: 0 = q,
// 1 = norm, 2 = glu.
extern "C" int zt_q4k_matvec(int fmt, const void* x, int x_dtype, const float* aux,
                             const uint8_t* qs, const void* s0, const void* s1, const void* s2,
                             const void* s3, float* y, int K, int N, int mode, float eps,
                             void* stream) {
  if (K % 256 != 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const NibblePlanes w{qs, s0, s1, s2, s3};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return launch_fmt<float>(fmt, mode, x, aux, w, y, K, N, eps, s);
  if (x_dtype == 1) return launch_fmt<__nv_bfloat16>(fmt, mode, x, aux, w, y, K, N, eps, s);
  return (int)cudaErrorInvalidValue;
}
