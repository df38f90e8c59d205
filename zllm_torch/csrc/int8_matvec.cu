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
// int8 peak.  A Q4_K_M step's 34 launches move 0.2-2.3 MB each (0.07-0.7
// us of bytes), so what paces them is each launch's fixed part: the earlier
// form (8-warp blocks, up to four an SM each redoing the prologue, a plain
// <<<>>> launch, a column's loads issued only after the previous column's
// dots) took 7.3 us a launch (python -m zllm_torch.k1_ablation --kernel k4,
// PERF.md §6).
//
// Design: K1's (q4k_matvec.cu), with its launch machinery from
// matvec_common.cuh.  Every block quantizes the activation row into shared
// memory, then each warp streams whole output columns, the column's planes
// contiguous along K (Q6KWeight / Q80Weight layouts,
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
// dot is at most 16 * 63 * 127 < 2^24, so both are exact.
//   * One wave of 16-warp blocks, at most two an SM (cpw columns a warp);
//     a narrow N (wv, 256 columns) is spread over the SMs a few warps'
//     columns a block, the block's other warps only helping the prologue
//     (packed sixteen columns a block, wv ran on 16 SMs).
//   * "glu" (ffn_down, K 5632): the blocks of a thread-block cluster of 4
//     share the prologue over distributed shared memory
//     (quantize_glu_cluster, 16-groups for Q6_K).
//   * Cross-column prefetch: a warp's columns are cut into units of one
//     round (32 slots), held in two register sets; the next unit's loads
//     are in flight while the current one's dots run (two rounds a set took
//     0.163 ms a step against 0.176, but spilled under the 64 registers of
//     two blocks an SM).
//   * Programmatic dependent launch (launch_matvec): before
//     griddepcontrol.wait a block issues only loads of what no kernel
//     writes -- its warps' first two units of weight planes, and an L2
//     prefetch of the RMS weight for "norm" -- so a K4 that follows a K1
//     (wk -> wv, gate|up -> down) has its weights in flight while its
//     predecessor drains; launch_dependents at the block's start.
//   * Each lane adds the same slot terms in the same order as the earlier
//     form (slot c = lane + 32 i, i rising, then warp_sum), and the row is
//     quantized as before, so the output is bit-identical to it.
//
// Where trouble lies: as K1's (q4k_matvec.cu) -- nothing before the wait
// reads x or writes y; a predecessor that never triggers (a torch op, K2)
// makes the launch as safe as a plain one; `-Xptxas -v` must show no spill
// under __launch_bounds__(512, 2) (chip_smoke.py's build report fails on
// one).

#include "matvec_common.cuh"

namespace {

using namespace zt;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

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
__global__ void __launch_bounds__(kThreads, 2) int8_matvec_kernel(
    const TX* __restrict__ x, const float* __restrict__ aux, const F f,
    float* __restrict__ y, int K, int N, int cols_per_warp, int wpb, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const QuantRow<F::kGroup> row(smem, K);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nslot = K / 32;
  const int upc = (nslot + 31) / 32;  // units (rounds of 32 slots) a column
  // this warp's columns n0 + j * wpb (j < cpw, < N; warps >= wpb none),
  // unit u = (column u / upc, slots from (u % upc) * 32)
  const int n0 = blockIdx.x * cols_per_warp * wpb + warp;
  const int ncols = warp < wpb && n0 < N ? min(cols_per_warp, (N - 1 - n0) / wpb + 1) : 0;
  const int nu = ncols * upc;
  auto fetch = [&](typename F::Slot& sl, int u) {
    const int c = (u % upc) * 32 + lane;
    if (u < nu && c < nslot) f.fetch(sl, (size_t)(n0 + (u / upc) * wpb), K, c);
  };

  // before the wait: weights and the norm weight only
  typename F::Slot ca, cb;
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
    quantize_glu_cluster<TX, F::kGroup, kThreads>(x, K, row);
  } else {
    quantize_row<TX, MODE, F::kGroup, kThreads>(x, aux, K, eps, row);
  }

  float acc = 0.f;
  auto dots = [&](const typename F::Slot& sl, int u) {
    if (u >= nu) return;  // uniform across the warp
    const int c = (u % upc) * 32 + lane;
    if (c < nslot) acc += f.dot(sl, c, row);
    if (u % upc == upc - 1) {  // the column's last unit
      acc = warp_sum(acc);
      if (lane == 0) y[n0 + (u / upc) * wpb] = acc;
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

// warps of a block that take columns: as many as spread the columns over
// every SM, at most all of them (N >= 16 * cpw * SMs)
inline int spread_warps(int N, int cpw, int sms, int warps) {
  const int w = (N + cpw * sms - 1) / (cpw * sms);
  return w < 1 ? 1 : (w > warps ? warps : w);
}

template <typename TX, int MODE, class F>
int launch(const void* x, const float* aux, const F& f, float* y, int K, int N, float eps,
           cudaStream_t stream) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  // one wave of at most two blocks an SM
  const int cpw = wave_cols(N, sms, kWarps);
  const int wpb = spread_warps(N, cpw, sms, kWarps);
  // glu: clusters of cl blocks share the prologue (a multiple of cl blocks,
  // the last ones perhaps without a column)
  const int cl = MODE == kGlu ? glu_cluster<F::kGroup>(K) : 1;
  return launch_matvec(int8_matvec_kernel<TX, MODE, F>, (N + cpw * wpb - 1) / (cpw * wpb),
                       kThreads, QuantRow<F::kGroup>::bytes(K), cl, stream,
                       static_cast<const TX*>(x), aux, f, y, K, N, cpw, wpb, eps);
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
