// K11: decode matvec (M = 1) of a Q4_0 or Q4_1 weight on the int8-quantized
// activation row, each packed byte dotted whole through two signed views;
// one launch a call, the activation quantize fused.
//
// Replaces zllm/ops/qmatmul.py::_w4a8dd_kernel (launched by
// _qmm_w4a8dd_call, which zllm takes under ZLLM_QMM_DUALDOT=1).  zllm runs
// it on a row its XLA code quantized beforehand (_quant_acts: int8 codes,
// dx and e = dx * sum(xq) per 32-group); here every block quantizes the
// row itself into shared memory with K1's "q" prologue (quantize_row,
// matvec_common.cuh: the codes are K1's and the plain version's bit for
// bit, rintf rounding half to even as torch.round and jnp.round), then
//   y[n] = sum_g of zllm's K11 epilogue
//     Q4_0: (pi_g - 8 * s_g) * d_g * dx_g
//     Q4_1: pi_g * a_g * dx_g - b_g * e_g
// over exact integer group dots pi_g and code sums s_g, with e_g =
// dx_g * (float)sx_g (sx_g the group's code sum from the prologue): the f32
// product _quant_acts stores, taken in the lane's epilogue.
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
// M = 1 the tensor core's A operand would be one row padded to 16, so the
// MMA buys no throughput, while __dp4a keeps each lane on its own 16 bytes,
// K1's lane layout, and the epilogue on the lane that owns the group.  S
// comes from a __dp4a of the codes with ones.
//
// Bound on the H100: the weight bytes, read once: Q4_0 18 bytes and Q4_1
// 20 bytes a 32-group (4.5 and 5 bits a weight), over 3.35 TB/s.
//
// Design: K1's (q4k_matvec.cu) grid, lane layout and launch machinery
// (matvec_common.cuh: launch_matvec with programmatic dependent launch,
// one wave of 16-warp blocks at most two an SM; a warp walks whole columns
// in units of 32 chunks, two register sets of weight units in flight).
// Before griddepcontrol.wait a block loads only its warps' first two
// units of packed nibbles and scales (no kernel writes them); x, the
// previous op's output, is read only after the wait, and so is every y
// store.  A block calls griddepcontrol.launch_dependents at its start.
// Each lane adds its group terms in K1's order (chunk c = c_base + 16 * it
// + lane / 2, group 2c + lane % 2, then warp_sum), so the output is K1's
// bit for bit.  The earlier form made two launches a call: a one-block
// quantize kernel (one SM busy, 131 idle) writing xq, dx and e to global
// memory, then the dot in 8-warp blocks copying them in; neither used PDL.
//
// Where trouble lies: the quantize runs once per block (at most two an SM,
// as K1's "q" prologue).  e is taken in each lane's epilogue from the
// row's dx and code sum: a pass storing e over the row in shared memory
// and its barrier cost 0.13-0.16 us a launch (NVIDIA H100 80GB HBM3,
// 700.00 W; PERF.md §6), bits equal.
// zt_quantize_acts (zllm's _quant_acts as an op of its own: the row's
// codes, dx and e in global memory, one block) stays for quantize_acts;
// the matvec no longer calls it.

#include "matvec_common.cuh"

namespace {

using namespace zt;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 2;           // chunk rounds (16 chunks each) a register set holds
constexpr int kUnit = 16 * kRounds;  // chunks a unit: a K = 2048 column
constexpr int kQuantThreads = 256;   // zt_quantize_acts' one block
constexpr unsigned kOnes = 0x01010101u;
constexpr unsigned kFlip = 0x80808080u;

template <typename TX>
__global__ void __launch_bounds__(kQuantThreads) quantize_acts_kernel(const TX* __restrict__ x,
                                                                      int8_t* __restrict__ xq,
                                                                      float* __restrict__ dx,
                                                                      float* __restrict__ e,
                                                                      int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const QuantRow<32> row(smem, K);
  quantize_row<TX, kQ, 32, kQuantThreads>(x, nullptr, K, 0.f, row);
  for (int i = threadIdx.x; i < K / 16; i += kQuantThreads)
    reinterpret_cast<int4*>(xq)[i] = reinterpret_cast<const int4*>(row.xq)[i];
  for (int g = threadIdx.x; g < K / 32; g += kQuantThreads) {
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

template <typename TX, int FMT>
__global__ void __launch_bounds__(kThreads, 2) w4a8dd_kernel(const TX* __restrict__ x,
                                                             const NibblePlanes w,
                                                             float* __restrict__ y, int K, int N,
                                                             int cols_per_warp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const QuantRow<32> row(smem, K);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nchunk = K / 64, part = lane & 1;
  const int upc = (nchunk + kUnit - 1) / kUnit;  // units a column
  // this warp's columns n0 + j * kWarps (j < cpw, < N), unit u = (column
  // u / upc, chunks from (u % upc) * kUnit)
  const int n0 = blockIdx.x * cols_per_warp * kWarps + warp;
  const int ncols = n0 < N ? min(cols_per_warp, (N - 1 - n0) / kWarps + 1) : 0;
  const int nu = ncols * upc;
  auto fetch = [&](ColRegs<FMT, kRounds>& cr, int u) {
    if (u < nu) fetch_col(cr, w, n0 + (u / upc) * kWarps, K, (u % upc) * kUnit, lane);
  };

  // before the wait: weights only
  ColRegs<FMT, kRounds> ca, cb;
  fetch(ca, 0);
  fetch(cb, 1);
  launch_dependents();
  grid_wait();
  quantize_row<TX, kQ, 32, kThreads>(x, nullptr, K, 0.f, row);

  float acc = 0.f;
  auto dots = [&](const ColRegs<FMT, kRounds>& cr, int u) {
    if (u >= nu) return;  // uniform across the warp
    const int c_base = (u % upc) * kUnit;
#pragma unroll
    for (int it = 0; it < kRounds; ++it) {
      if (c_base + it * 16 >= nchunk) break;  // uniform across the warp
      const int c = c_base + it * 16 + (lane >> 1);
      int plo = 0, phi16 = 0, slo = 0, shi = 0;
      if (c < nchunk) {
        const uint4 wv = cr.wv[it];
        const int4 xl = *reinterpret_cast<const int4*>(row.xq + c * 64 + part * 16);
        const int4 xh = *reinterpret_cast<const int4*>(row.xq + c * 64 + 32 + part * 16);
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
        const float dx = row.dx[g];  // e = dx * sum(xq), the f32 product _quant_acts stores
        acc += cr.s[it].term_e(pi, part ? shi : slo, dx, dx * (float)row.sx[g]);
      }
    }
    if (u % upc == upc - 1) {  // the column's last unit
      acc = warp_sum(acc);
      if (lane == 0) y[n0 + (u / upc) * kWarps] = acc;
      acc = 0.f;
    }
  };
  for (int u = 0; u < nu; u += 2) {
    dots(ca, u);
    fetch(ca, u + 2);
    dots(cb, u + 1);
    fetch(cb, u + 3);
  }
}

template <typename TX, int FMT>
int launch(const void* x, const NibblePlanes& w, float* y, int K, int N, cudaStream_t stream) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  // one wave of at most two blocks an SM, K1's columns per warp
  const int cpw = wave_cols(N, sms, kWarps);
  const int per_block = kWarps * cpw;
  return launch_matvec(w4a8dd_kernel<TX, FMT>, (N + per_block - 1) / per_block, kThreads,
                       QuantRow<32>::bytes(K), 1, stream, static_cast<const TX*>(x), w, y, K, N,
                       cpw);
}

template <typename TX>
int launch_fmt(int fmt, const void* x, const NibblePlanes& w, float* y, int K, int N,
               cudaStream_t s) {
  if (fmt == kQ40) return launch<TX, kQ40>(x, w, y, K, N, s);
  if (fmt == kQ41) return launch<TX, kQ41>(x, w, y, K, N, s);
  return (int)cudaErrorInvalidValue;
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
    quantize_acts_kernel<float><<<1, kQuantThreads, bytes, s>>>(static_cast<const float*>(x),
                                                                xq, dx, e, K);
  else if (x_dtype == 1)
    quantize_acts_kernel<__nv_bfloat16><<<1, kQuantThreads, bytes, s>>>(
        static_cast<const __nv_bfloat16*>(x), xq, dx, e, K);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// fmt: 1 = Q4_0 (s0 = d), 2 = Q4_1 (s0 = a, s1 = b), the NibbleFmt codes of
// matvec_common.cuh; x [K] float32 (x_dtype 0) or bfloat16 (1); qs [N, K/2]
// and the fp16 planes [N, K/32], 16-byte aligned; K % 256 == 0.
extern "C" int zt_w4a8dd_matvec(int fmt, const void* x, int x_dtype, const uint8_t* qs,
                                const void* s0, const void* s1, float* y, int K, int N,
                                void* stream) {
  if (K % 256 != 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const NibblePlanes w{qs, s0, s1, nullptr, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return launch_fmt<float>(fmt, x, w, y, K, N, s);
  if (x_dtype == 1) return launch_fmt<__nv_bfloat16>(fmt, x, w, y, K, N, s);
  return (int)cudaErrorInvalidValue;
}
