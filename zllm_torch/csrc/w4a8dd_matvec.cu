// K11: decode matvec (M = 1) of a Q4_0 or Q4_1 weight on an activation row
// quantized beforehand, each packed byte dotted whole through two signed
// views.
//
// Replaces zllm/ops/qmatmul.py::_w4a8dd_kernel (launched by
// _qmm_w4a8dd_call, which zllm takes under ZLLM_QMM_DUALDOT=1).  Two
// launches, as zllm's two steps:
//   1. zt_quantize_acts: the row x [K] -> int8 codes xq [K], dx [K/32] and
//      e = dx * sum(xq) [K/32] per 32-group, in global memory (zllm's
//      _quant_acts, which XLA computes there): one block runs K1's "q"
//      prologue (quantize_row, matvec_common.cuh), so the codes are K1's
//      and the plain version's bit for bit (rintf is round half to even,
//      as torch.round and jnp.round).
//   2. zt_w4a8dd_matvec: y[n] = sum_g of zllm's K11 epilogue
//        Q4_0: (pi_g - 8 * s_g) * d_g * dx_g
//        Q4_1: pi_g * a_g * dx_g - b_g * e_g
//      over exact integer group dots pi_g and code sums s_g.
//
// The dual view: with byte = lo + 16 * hi (the nibble layout of
// zllm_torch/quant/repack.py: the low nibbles of a chunk's bytes are
// group 2c's codes, the high nibbles group 2c+1's), the two signed views
//   B1 = byte ^ 0x80 = lo + 16 * hi - 128,   B2 = (byte & 0x0F) ^ 0x80 = lo - 128
// give, dotted with a group's activation codes x (sum S),
//   Plo = B2 . x_lo + 128 * S_lo,   Phi = (B1 . x_hi - B2 . x_hi) >> 4,
// exact in int32 ((B1 - B2) = 16 * hi, so the shift divides exactly), with
// no shift or mask of the high nibble.  The dots are __dp4a on the two
// views, four bytes against four codes, rather than mma.sync m16n8k32: at
// M = 1 the tensor core's A operand would be one row padded to 16 (or
// zllm's block-diagonal C, 2*G rows of mostly zeros), so the MMA buys no
// throughput, while __dp4a keeps each lane on its own 16 bytes, K1's lane
// layout, and the epilogue on the lane that owns the group.  S comes from a
// __dp4a of the codes with ones.
//
// Bound on the H100: the weight bytes, read once: Q4_0 18 bytes and Q4_1
// 20 bytes a 32-group (4.5 and 5 bits a weight), over 3.35 TB/s; the
// activation buffers (K + 8 K/32 bytes) are read once per block, from L2.
// Design: K1's grid and lane layout (a warp streams whole columns, two
// lanes a 64-element chunk with 16-byte loads, up to 4 chunk rounds in
// registers, the first column's loads issued before anything else); where
// K1 re-runs its whole-row quantize prologue in every block, here every
// block copies the quantized row (K int8 codes and 2 * K/32 floats) into
// shared memory with 16-byte loads, once.

#include "matvec_common.cuh"

namespace {

using namespace zt;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;  // chunk rounds (16 chunks each) held in registers
constexpr unsigned kOnes = 0x01010101u;
constexpr unsigned kFlip = 0x80808080u;

template <typename TX>
__global__ void __launch_bounds__(kThreads) quantize_acts_kernel(const TX* __restrict__ x,
                                                                 int8_t* __restrict__ xq,
                                                                 float* __restrict__ dx,
                                                                 float* __restrict__ e, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const QuantRow<32> row(smem, K);
  quantize_row<TX, kQ, 32, kThreads>(x, nullptr, K, 0.f, row);
  for (int i = threadIdx.x; i < K / 16; i += kThreads)
    reinterpret_cast<int4*>(xq)[i] = reinterpret_cast<const int4*>(row.xq)[i];
  for (int g = threadIdx.x; g < K / 32; g += kThreads) {
    dx[g] = row.dx[g];
    e[g] = row.dx[g] * (float)row.sx[g];
  }
}

// one 4-byte word of packed nibbles against its four low-nibble codes xl
// and four high-nibble codes xh: accumulate B2.xl + 128 S_lo, B1.xh - B2.xh,
// S_lo and S_hi
__device__ __forceinline__ void dual_dot(unsigned wd, int xl, int xh, int& plo, int& phi16,
                                         int& slo, int& shi) {
  const int b1 = (int)(wd ^ kFlip);
  const int b2 = (int)((wd & 0x0F0F0F0Fu) ^ kFlip);
  const int sl = __dp4a(xl, (int)kOnes, 0);
  plo = __dp4a(b2, xl, plo) + 128 * sl;
  phi16 = __dp4a(b1, xh, phi16) - __dp4a(b2, xh, 0);
  slo += sl;
  shi = __dp4a(xh, (int)kOnes, shi);
}

// four blocks an SM, as K1 (at most 64 registers a thread)
template <int FMT>
__global__ void __launch_bounds__(kThreads, 4) w4a8dd_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ dx, const float* __restrict__ e,
    const NibblePlanes w, float* __restrict__ y, int K, int N, int cols_per_warp) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sxq = reinterpret_cast<int8_t*>(smem);
  float* sdx = reinterpret_cast<float*>(smem + K);
  float* se = sdx + K / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nchunk = K / 64;
  const int part = lane & 1;

  // the first column's weights are in flight while the row is copied in
  ColRegs<FMT, kRounds> cr;
  const int n0 = blockIdx.x * cols_per_warp * kWarps + warp;
  if (n0 < N) fetch_col(cr, w, n0, K, 0, lane);
  for (int i = threadIdx.x; i < K / 16; i += kThreads)
    reinterpret_cast<int4*>(sxq)[i] = reinterpret_cast<const int4*>(xq)[i];
  for (int g = threadIdx.x; g < K / 32; g += kThreads) {
    sdx[g] = dx[g];
    se[g] = e[g];
  }
  __syncthreads();

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
        int plo = 0, phi16 = 0, slo = 0, shi = 0;
        if (c < nchunk) {
          const uint4 wv = cr.wv[it];
          const int4 xl = *reinterpret_cast<const int4*>(sxq + c * 64 + part * 16);
          const int4 xh = *reinterpret_cast<const int4*>(sxq + c * 64 + 32 + part * 16);
          dual_dot(wv.x, xl.x, xh.x, plo, phi16, slo, shi);
          dual_dot(wv.y, xl.y, xh.y, plo, phi16, slo, shi);
          dual_dot(wv.z, xl.z, xh.z, plo, phi16, slo, shi);
          dual_dot(wv.w, xl.w, xh.w, plo, phi16, slo, shi);
        }
        plo += __shfl_xor_sync(kFull, plo, 1);
        phi16 += __shfl_xor_sync(kFull, phi16, 1);
        slo += __shfl_xor_sync(kFull, slo, 1);
        shi += __shfl_xor_sync(kFull, shi, 1);
        if (c < nchunk) {
          // even lane takes group 2c (low nibbles), odd lane group 2c+1
          const int g = 2 * c + part;
          const int pi = part ? (phi16 >> 4) : plo;
          acc += cr.s[it].term_e(pi, part ? shi : slo, sdx[g], se[g]);
        }
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) y[n] = acc;
  }
}

template <int FMT>
int launch(const int8_t* xq, const float* dx, const float* e, const NibblePlanes& w, float* y,
           int K, int N, cudaStream_t stream) {
  // K1's columns per warp, so the blocks cover the same columns
  int cpw = N / (kWarps * 2 * 132);
  cpw = cpw < 1 ? 1 : (cpw > 4 ? 4 : cpw);
  const int per_block = kWarps * cpw;
  const dim3 grid((N + per_block - 1) / per_block);
  w4a8dd_kernel<FMT><<<grid, kThreads, QuantRow<32>::bytes(K), stream>>>(xq, dx, e, w, y, K, N,
                                                                         cpw);
  return (int)cudaGetLastError();
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16.  xq int8 [K] (16-byte aligned), dx and
// e f32 [K/32]; K % 256 == 0.
extern "C" int zt_quantize_acts(const void* x, int x_dtype, int8_t* xq, float* dx, float* e,
                                int K, void* stream) {
  if (K % 256 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = QuantRow<32>::bytes(K);
  if (x_dtype == 0)
    quantize_acts_kernel<float><<<1, kThreads, bytes, s>>>(static_cast<const float*>(x), xq, dx,
                                                           e, K);
  else if (x_dtype == 1)
    quantize_acts_kernel<__nv_bfloat16><<<1, kThreads, bytes, s>>>(
        static_cast<const __nv_bfloat16*>(x), xq, dx, e, K);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// fmt: 1 = Q4_0 (s0 = d), 2 = Q4_1 (s0 = a, s1 = b), the NibbleFmt codes of
// matvec_common.cuh; qs [N, K/2] and the fp16 planes [N, K/32], 16-byte
// aligned; the quantized row from zt_quantize_acts.
extern "C" int zt_w4a8dd_matvec(int fmt, const int8_t* xq, const float* dx, const float* e,
                                const uint8_t* qs, const void* s0, const void* s1, float* y,
                                int K, int N, void* stream) {
  if (K % 256 != 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const NibblePlanes w{qs, s0, s1, nullptr, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fmt == kQ40) return launch<kQ40>(xq, dx, e, w, y, K, N, s);
  if (fmt == kQ41) return launch<kQ41>(xq, dx, e, w, y, K, N, s);
  return (int)cudaErrorInvalidValue;
}
