// K12: decode matvec (M = 1) of the nibble formats Q4_K, Q4_0 and Q4_1 on
// the int8 path, with the packed weight nibbles streamed global -> shared by
// the Tensor Memory Accelerator's bulk copies into a ring of stages a warp.
//
// Replaces zllm/ops/qmatmul.py::_w4a8np_hbm_kernel (launched by
// _qmm_w4a8np_hbm_call when ZLLM_QMM_HBM=1): K1's maths (q4k_matvec.cu),
// y[n] = sum_g of zllm's per-group epilogue over the int8-quantized
// activation row (GroupScale, matvec_common.cuh), with K1's prologues ("q",
// "norm", "glu").  The TPU kernel keeps the weight planes in HBM (memory
// space ANY) and runs its own double-buffered chain of
// pltpu.make_async_copy with DMA semaphores; on Hopper that is a bulk copy
// (cp.async.bulk) completed on an mbarrier in shared memory.
//
// Bound on the H100: the weight bytes, read once (as K1's: Q4_K 4.625 bits
// a weight in this layout, Q4_0 4.5, Q4_1 5); the arithmetic is 2*K*N int8
// ops, ~1000x under the int8 peak.
//
// Design.  K1's launch machinery (matvec_common.cuh: launch_matvec with
// programmatic dependent launch, one wave of 16-warp blocks at most two an
// SM, the glu prologue shared by a thread-block cluster through
// quantize_glu_cluster) and K1's lane layout; only the weight fetch
// differs.  Each warp streams its columns (n0 + j * 16, as K1) stage by
// stage, a stage being one column's 32 chunks of 64 weights (2048
// weights), through its own ring of kStages = 2 slots in shared memory:
//   * a stage's packed nibbles are one 1024-byte bulk copy (a column's
//     nibbles are contiguous along K; a last stage of fewer chunks, a
//     multiple of 4, is a shorter one), issued by lane 0 and completed on
//     the slot's mbarrier, armed by mbarrier.arrive.expect_tx;
//   * the stage's scales (Q4_K sc, mn, d, dmin; Q4_0 d; Q4_1 a, b) are
//     loaded by each lane into registers as K1 loads them (GroupScale::load),
//     a register set a slot, issued with the slot's copy.  Copied through
//     the slots instead (one bulk copy a plane and stage, 16-64 bytes; the
//     Q4_K d / dmin runs, 2-byte aligned, by cp.async words tracked on the
//     same barrier), the scales cost 0.04-0.06 ms an OLMo-2 step (NVIDIA
//     H100 80GB HBM3, 700.00 W): small bulk copies are paid by the copy,
//     not by the byte;
//   * after a stage's dots a __syncwarp frees its slot and the warp refills
//     it with the stage kStages ahead (across column boundaries), so a warp
//     never waits on another warp: no block-wide barrier in the K loop (the
//     earlier form waited on the whole block's cp.async groups at every
//     stage);
//   * before griddepcontrol.wait a warp initializes its barriers and issues
//     only its first kStages stages (weights: no kernel writes them) and,
//     for "norm", an L2 prefetch of the RMS weight; the x reads (the
//     prologue), the dots and every y store follow the wait.  A block calls
//     griddepcontrol.launch_dependents before its prologue, as K1;
//   * a lane computes exactly what it computes in K1 (chunk c = 32 * stage +
//     16 * it + lane / 2 -- K1's unit is a stage --, its group 2c + lane % 2,
//     group_term, accumulated round by round, then warp_sum), on the row
//     K1's prologue quantizes, so the result is K1's bit for bit in every
//     format, prologue and x dtype.
// Shared memory a block: the quantized row (K + K / 4 bytes), 16 x 2
// mbarriers and 16 x 2 slots of 1024 bytes: 43 KB at K = 8192.
//
// By part (python -m zllm_torch.k1_ablation --kernel k12, NVIDIA H100 80GB
// HBM3, 700.00 W; PERF.md §6): the earlier form took 0.703 ms an
// OLMo-2 Q4_K step (K1 0.457), 0.30 of it before its first dot; the first
// TMA form (16-chunk stages, 4 a warp, scales copied) 0.736, 32-chunk
// stages 0.54, 3 stages 0.52, the scales in registers at 2 stages 0.48
// (K1 0.46 in the same run).  A producer warp filling the other 15 warps'
// rings through "empty" barriers took 2.8 ms (it serializes the warps'
// refills); 4 or 6 stages, 16- or 64-chunk stages, copies issued by five
// lanes at once and the largest shared-memory carveout were no faster.
//
// Where trouble lies:
//   * Barrier setup: lane 0 initializes the warp's barriers, then
//     fence.mbarrier_init and a __syncwarp, all before the first copy; a
//     slot's phase parity is (unit / kStages) & 1.
//   * A slot is read by the warp's generic loads and then rewritten by a
//     bulk copy (the async proxy): the refill follows a __syncwarp and a
//     fence.proxy.async by the issuing lane.
//   * The scale register sets are indexed by slot: the consume loop is
//     unrolled kStages times so each index is a constant (no local memory;
//     -Xptxas -v must show no spill, chip_smoke.py's build report fails on
//     one).
//   * A warp without a column (n >= N) issues no copy and waits on no
//     barrier; it still takes part in the prologue's block and cluster
//     barriers, so every block of a glu cluster reaches them.
//   * Alignment: a bulk copy needs 16-byte aligned ends and a multiple of
//     16 bytes; a column's nibbles start at n * K / 2 and a stage at 1024 t,
//     and a stage holds a multiple of 4 chunks (128 bytes), so every K %
//     256 == 0 that K1 takes works (the wrapper checks the planes' 16-byte
//     alignment).
//   * Under CUDA-graph capture the PDL attribute becomes a programmatic
//     edge (tests/test_torch_cuda.py::test_k12_chain_in_a_graph).
//   * Dynamic shared memory above 48 KB (K above 12 K) needs the function
//     attribute, set before such a launch.

#include "matvec_common.cuh"

namespace {

using namespace zt;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;              // ring slots a warp
constexpr int kChunks = 32;             // 64-weight chunks a stage holds (a K = 2048 column)
constexpr int kRounds = kChunks / 16;   // rounds of 16 chunks (a lane pair each) a stage
constexpr int kQsBytes = kChunks * 32;  // packed nibbles a column a stage: a slot

// the dynamic shared memory of a block: the quantized row (QuantRow<32>),
// the barriers, the rings
__host__ __device__ constexpr size_t row_bytes(int K) { return (size_t)K + (size_t)(K / 32) * 8; }
__host__ __device__ constexpr size_t smem_bytes(int K) {
  return row_bytes(K) + (size_t)kWarps * kStages * 8 + (size_t)kWarps * kStages * kQsBytes;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// global -> shared bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned), completed on the barrier's transaction count
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <typename TX, int MODE, int FMT>
__global__ void __launch_bounds__(kThreads, 2) q4k_matvec_hbm_kernel(
    const TX* __restrict__ x, const float* __restrict__ aux, const NibblePlanes w,
    float* __restrict__ y, int K, int N, int cols_per_warp, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const QuantRow<32> row(smem, K);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nchunk = K / 64, part = lane & 1;
  const int upc = (nchunk + kChunks - 1) / kChunks;  // units (stages) a column
  // this warp's columns n0 + j * kWarps (j < cpw, < N); unit u = (column
  // u / upc, stage u % upc), in slot u % kStages of the warp's ring
  const int n0 = blockIdx.x * cols_per_warp * kWarps + warp;
  const int ncols = n0 < N ? min(cols_per_warp, (N - 1 - n0) / kWarps + 1) : 0;
  const int nu = ncols * upc;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + row_bytes(K)) + warp * kStages;
  unsigned char* ring =
      smem + row_bytes(K) + kWarps * kStages * 8 + (size_t)warp * kStages * kQsBytes;
  // slot si's unit's scales, loaded with its copy
  GroupScale<FMT> scales[kStages][kRounds];

  // unit u into slot si: lane 0's bulk copy of the nibbles, every lane's
  // scale loads (the whole warp calls this)
  auto fill = [&](int si, int u) {
    const uint32_t bar = smem_u32(bars + si);
    const int n = n0 + (u / upc) * kWarps, t = u % upc;
    const int cr = min(kChunks, nchunk - t * kChunks);  // chunks this stage, a multiple of 4
    if (lane == 0) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive_expect_tx(bar, cr * 32);
      bulk_g2s(smem_u32(ring + si * kQsBytes),
               w.qs + (size_t)n * (K / 2) + (size_t)t * kQsBytes, cr * 32, bar);
    }
#pragma unroll
    for (int it = 0; it < kRounds; ++it) {
      const int c = t * kChunks + it * 16 + (lane >> 1);
      if (c < nchunk) scales[si][it].load(w, (size_t)n, 2 * c + part, K);
    }
  };

  // before the wait: the barriers, the first stages' weights and the norm
  // weight only
  if (lane == 0) {
    for (int si = 0; si < kStages; ++si) mbar_init(smem_u32(bars + si), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
#pragma unroll
  for (int si = 0; si < kStages; ++si)
    if (si < nu) fill(si, si);
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
  for (int u0 = 0; u0 < nu; u0 += kStages) {
#pragma unroll
    for (int si = 0; si < kStages; ++si) {
      const int u = u0 + si;
      if (u >= nu) break;  // uniform across the warp
      const unsigned char* slot = ring + si * kQsBytes;
      mbar_wait(smem_u32(bars + si), (u / kStages) & 1);
      const int t = u % upc;
#pragma unroll
      for (int it = 0; it < kRounds; ++it) {
        if (t * kChunks + it * 16 >= nchunk) break;  // uniform across the warp
        const int c = t * kChunks + it * 16 + (lane >> 1);
        int plo = 0, phi = 0;
        if (c < nchunk) {
          const uint4 wv = *reinterpret_cast<const uint4*>(slot + it * 512 + lane * 16);
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
          acc += group_term(scales[si][it], part ? phi : plo, row.sx[g], row.dx[g]);
        }
      }
      if (t == upc - 1) {  // the column's last stage
        acc = warp_sum(acc);
        if (lane == 0) y[n0 + (u / upc) * kWarps] = acc;
        acc = 0.f;
      }
      __syncwarp();  // every lane is done with the slot
      if (u + kStages < nu) fill(si, u + kStages);
    }
  }
}

template <typename TX, int MODE, int FMT>
int launch(const void* x, const float* aux, const NibblePlanes& w, float* y, int K, int N,
           float eps, cudaStream_t stream) {
  int sms = 0;
  int err = sm_count(&sms);
  if (err != 0) return err;
  // one wave of at most two blocks an SM, K1's columns per warp
  const int cpw = wave_cols(N, sms, kWarps);
  const int per_block = kWarps * cpw;
  const int cl = MODE == kGlu ? glu_cluster<32>(K) : 1;
  const size_t bytes = smem_bytes(K);
  auto kern = q4k_matvec_hbm_kernel<TX, MODE, FMT>;
  if (bytes > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != 0) return err;
  }
  return launch_matvec(kern, (N + per_block - 1) / per_block, kThreads, bytes, cl, stream,
                       static_cast<const TX*>(x), aux, w, y, K, N, cpw, eps);
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

// fmt: 0 = Q4_K, 1 = Q4_0, 2 = Q4_1.  x_dtype: 0 = float32, 1 = bfloat16.
// mode: 0 = q, 1 = norm, 2 = glu.  Planes as K1 takes them (NibblePlanes,
// matvec_common.cuh); every plane 16-byte aligned.
extern "C" int zt_q4k_matvec_hbm(int fmt, const void* x, int x_dtype, const float* aux,
                                 const uint8_t* qs, const void* s0, const void* s1,
                                 const void* s2, const void* s3, float* y, int K, int N, int mode,
                                 float eps, void* stream) {
  if (K % 256 != 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const NibblePlanes w{qs, s0, s1, s2, s3};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return launch_fmt<float>(fmt, mode, x, aux, w, y, K, N, eps, s);
  if (x_dtype == 1) return launch_fmt<__nv_bfloat16>(fmt, mode, x, aux, w, y, K, N, eps, s);
  return (int)cudaErrorInvalidValue;
}

// The ring's depth (stages a warp) and a block's dynamic shared memory in
// bytes at K (the same for the three formats and prologues); 0.
extern "C" int zt_q4k_matvec_hbm_layout(int K, int* stages, long long* smem) {
  *stages = kStages;
  *smem = (long long)smem_bytes(K);
  return 0;
}
