// K1: decode matvec (M = 1) of the nibble formats Q4_K, Q4_0, Q4_1, Q5_0,
// Q5_1 and Q5_K on the int8 path.
//
// Replaces zllm/ops/qmatmul.py::_w4a8np_kernel (launched by
// _qmm_w4a8np_call): y[n] = sum_k prologue(x)[k] * W[k, n], with the
// activation row quantized to int8 per 32-group and the weight codes kept
// as 4- or 5-bit integers, so each group's dot is an exact integer (|pi| <=
// 32 * 31 * 127); each group then takes zllm's f32 epilogue (GroupScale in
// matvec_common.cuh):
//   Q4_K: pi_g * a_g * dx_g - b_g * (dx_g * sum(xq_g)),
//         a_g = f32(d) * sc_g, b_g = f32(dmin) * mn_g   (exact two-level)
//   Q4_1, Q5_1: the same with a = d and b = -m of the group (fp16 planes)
//   Q5_K: the same with zllm's fp16-rounded a = d * sc and b = dmin * mn
//   Q4_0: (pi_g - 8 * sum(xq_g)) * d_g * dx_g, the -8 applied in integers
//   Q5_0: (pi_g - 16 * sum(xq_g)) * d_g * dx_g
// Prologues: "q" (x as is), "norm" (rms_norm(x) * w, the full-row mean
// square reduced first), "glu" (silu(g) * u over the fused gate|up row),
// shared with K4 in matvec_common.cuh.
//
// Bound on the H100: the weight bytes, read once (Q4_K 4.5 bits a weight,
// this layout with sc/mn unpacked to bytes 4.625; Q4_0 4.5; Q4_1 5; Q5_0
// 5.5; Q5_1 6; Q5_K 5.5, this layout with its fp16 a and b 6); the
// arithmetic is 2*K*N int8 ops, ~1000x under the int8 peak.  At 1B scale
// a launch moves 2-19 MB (0.7-5.6 us of bytes), so what paces a decode
// step's 65-99 launches is each launch's fixed part.  The earlier form
// (8 warps a block, up to 4 blocks an SM, one column in flight a warp)
// took 8.5 us a launch on the H100, of which 1.1 the graph's launch,
// 1.4-6.5 the activation prologue (norm 2.5, glu 6.5: every block on an
// SM redid it) and a serial trip to HBM a column
// (python -m zllm_torch.k1_ablation, PERF.md §6).
//
// Design.  Each block quantizes the activation row into shared memory
// (int8 codes, f32 dx, int32 sums per group; eight lanes a group), then
// each warp streams whole output columns: a column's packed nibbles are
// contiguous along K in every format (zllm_torch/quant/repack.py), so two
// lanes read one 64-element chunk as two 16-byte loads.  The low nibbles
// of four bytes are four codes of group 2c and the high nibbles four codes
// of group 2c+1, each against four int8 activations in one __dp4a.  A
// lane-pair shuffle joins the two halves of a chunk into exact integer
// group dots, and each lane applies its group's scales.  Only the scale
// fetch and the epilogue depend on the format (template FMT), and in the
// 5-bit formats the fifth bits: a lane loads the one u32 of the qh plane
// that covers its 16 bytes (bits 0-15 the low nibbles' codes, 16-31 the
// high nibbles'), beside its 16 bytes and before the wait, and ORs four of
// its bits into bit 4 of the four code bytes of each __dp4a word
// (fifth_bits4: a multiply and a mask, no table); codes 0..31 stay positive
// int8.  The 4-bit forms compile without that code (if constexpr) and keep
// their bits.
//   * One wave of 16-warp blocks, at most two an SM (a warp walks cpw =
//     ceil(N / (2 * SMs * 16)) columns): the prologue is done by at most
//     two blocks an SM, where the earlier form had up to eight (one block
//     an SM, leaving room for the next launch's, took 0.63 ms a step
//     against 0.50: too few loads in flight for gate|up and the head).
//   * "glu" (ffn_down, K 5632): the blocks of a thread-block cluster of 4
//     (2 where K / 32 is not a multiple of 16) share the prologue: each
//     quantizes a quarter of the groups and stores them into every peer's
//     row over distributed shared memory (done by each block alone, the
//     glu prologue took 5.1 us of an 8.2 us launch; shared, 2.5 of 7.4).
//   * Cross-column prefetch: a warp's columns are cut into units of 32
//     chunks (a whole K = 2048 column), held in two register sets; the next
//     unit's loads are in flight while the current one's dots run.
//   * Programmatic dependent launch (the machinery of matvec_common.cuh,
//     shared with K4: launch_matvec, grid_wait, launch_dependents,
//     quantize_glu_cluster): the entry launches with programmatic
//     stream serialization.  Before griddepcontrol.wait a block issues only
//     loads of what no kernel writes -- its warps' first two units of
//     packed nibbles and scale planes, and an L2 prefetch of the RMS weight
//     (`aux`) for "norm" -- so a launch that follows K1 has its weights in
//     flight while its predecessor drains.  A block calls
//     griddepcontrol.launch_dependents at its start, so the next launch's
//     blocks take the room beside this one's as early as they can (after
//     the last weight loads, the step took 0.63-0.65 ms).
//   * Each lane adds the same group terms in the same order as before (chunk
//     c = c_base + 16 * it + lane / 2, group 2c + lane % 2, then warp_sum),
//     and every group is quantized as before (quantize_group; the mean
//     square in one order for any block size), so the output is
//     bit-identical to the earlier form's, to K12's and to K11's.
//   * Tried and dropped: loading a thread's next prologue group before
//     reducing the current one (no change: taking out the sigmoid or the
//     divisions moved the prologue, prefetching its loads did not).
//
// Where trouble lies:
//   * Nothing before griddepcontrol.wait may read what an earlier kernel
//     writes or write anything: x is the previous K1's output in "glu"
//     (gate|up -> down) or a torch op's, and y comes from the caching
//     allocator, whose block a draining predecessor may still read.  The
//     x reads (the prologue), the dots and every y store follow the wait.
//   * A predecessor that never triggers (K2, a torch op) triggers at its
//     end: the launch is then as safe as a plain one, and gains only the
//     prefetch.
//   * Under CUDA-graph capture the attribute becomes a programmatic edge; a
//     launch the runtime refuses returns its error, which the wrapper
//     raises.
//   * Co-residency: a launch is one wave of at most two blocks an SM, so
//     none of its blocks queues behind a successor that started early; a
//     successor's blocks take only the room this launch leaves.
//   * The cluster's DSMEM stores wait until every peer runs (the cluster
//     barrier's arrive at the block's start, its wait before the first
//     store), and no block reads its row before the closing cluster.sync().
//   * Registers: __launch_bounds__(512, 2) holds a thread to 64; the two
//     sets cost what the earlier form's four rounds of one column cost (a
//     5-bit form holds one more u32 a round, four a thread).
//     `-Xptxas -v` must show no spill (chip_smoke.py's build report fails
//     on one).

#include "matvec_common.cuh"

namespace {

using namespace zt;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 2;           // chunk rounds (16 chunks each) a register set holds
constexpr int kUnit = 16 * kRounds;  // chunks a unit: a K = 2048 column

template <typename TX, int MODE, int FMT>
__global__ void __launch_bounds__(kThreads, 2) q4k_matvec_kernel(
    const TX* __restrict__ x, const float* __restrict__ aux, const NibblePlanes w,
    float* __restrict__ y, int K, int N, int cols_per_warp, float eps) {
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

  // before the wait: weights and the norm weight only
  ColRegs<FMT, kRounds> ca, cb;
  fetch(ca, 0);
  fetch(cb, 1);
  if (MODE == kNorm) {
    for (int k = threadIdx.x * 32; k < K; k += kThreads * 32)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(aux + k));
  }
  launch_dependents();
  if (MODE == kGlu) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  grid_wait();
  if constexpr (MODE == kGlu) {
    quantize_glu_cluster<TX, 32, kThreads>(x, K, row);
  } else {
    quantize_row<TX, MODE, 32, kThreads>(x, aux, K, eps, row);
  }

  float acc = 0.f;
  auto dots = [&](const ColRegs<FMT, kRounds>& cr, int u) {
    if (u >= nu) return;  // uniform across the warp
    const int c_base = (u % upc) * kUnit;
#pragma unroll
    for (int it = 0; it < kRounds; ++it) {
      if (c_base + it * 16 >= nchunk) break;  // uniform across the warp
      const int c = c_base + it * 16 + (lane >> 1);
      int plo = 0, phi = 0;
      if (c < nchunk) {
        const uint4 wv = cr.wv[it];
        const int4 xl = *reinterpret_cast<const int4*>(row.xq + c * 64 + part * 16);
        const int4 xh = *reinterpret_cast<const int4*>(row.xq + c * 64 + 32 + part * 16);
        // the code bytes of word j of the low (high) nibbles: qh bits 4j..
        // (16 + 4j..)
        auto lo = [&](uint32_t v, int j) {
          uint32_t q = v & 0x0F0F0F0Fu;
          if constexpr (kHasQh<FMT>) q |= fifth_bits4(cr.qh[it], j);
          return (int)q;
        };
        auto hi = [&](uint32_t v, int j) {
          uint32_t q = (v >> 4) & 0x0F0F0F0Fu;
          if constexpr (kHasQh<FMT>) q |= fifth_bits4(cr.qh[it], 4 + j);
          return (int)q;
        };
        plo = __dp4a(lo(wv.x, 0), xl.x, plo);
        phi = __dp4a(hi(wv.x, 0), xh.x, phi);
        plo = __dp4a(lo(wv.y, 1), xl.y, plo);
        phi = __dp4a(hi(wv.y, 1), xh.y, phi);
        plo = __dp4a(lo(wv.z, 2), xl.z, plo);
        phi = __dp4a(hi(wv.z, 2), xh.z, phi);
        plo = __dp4a(lo(wv.w, 3), xl.w, plo);
        phi = __dp4a(hi(wv.w, 3), xh.w, phi);
      }
      plo += __shfl_xor_sync(kFull, plo, 1);
      phi += __shfl_xor_sync(kFull, phi, 1);
      if (c < nchunk) {
        // even lane takes group 2c (low nibbles), odd lane group 2c+1
        const int g = 2 * c + part;
        acc += group_term(cr.s[it], part ? phi : plo, row.sx[g], row.dx[g]);
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

template <typename TX, int MODE, int FMT>
int launch(const void* x, const float* aux, const NibblePlanes& w, float* y, int K, int N,
           float eps, cudaStream_t stream) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  // one wave of at most two blocks an SM
  const int cpw = wave_cols(N, sms, kWarps);
  const int per_block = kWarps * cpw;
  // glu: clusters of cl blocks share the prologue (a multiple of cl blocks,
  // the last ones perhaps without a column)
  const int cl = MODE == kGlu ? glu_cluster<32>(K) : 1;
  return launch_matvec(q4k_matvec_kernel<TX, MODE, FMT>, (N + per_block - 1) / per_block,
                       kThreads, QuantRow<32>::bytes(K), cl, stream, static_cast<const TX*>(x),
                       aux, w, y, K, N, cpw, eps);
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
    case kQ50: return launch_mode<TX, kQ50>(mode, x, aux, w, y, K, N, eps, s);
    case kQ51: return launch_mode<TX, kQ51>(mode, x, aux, w, y, K, N, eps, s);
    case kQ5K: return launch_mode<TX, kQ5K>(mode, x, aux, w, y, K, N, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// fmt: 0 = Q4_K, 1 = Q4_0, 2 = Q4_1, 3 = Q5_0, 4 = Q5_1, 5 = Q5_K (scale
// planes s0..s3, and the 5-bit formats' qh as s3, as NibblePlanes in
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
