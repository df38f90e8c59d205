// K12: decode matvec (M = 1) of the nibble formats Q4_K, Q4_0 and Q4_1 on
// the int8 path, with the weight planes brought global -> shared through an
// explicit multi-stage pipeline.
//
// Replaces zllm/ops/qmatmul.py::_w4a8np_hbm_kernel (launched by
// _qmm_w4a8np_hbm_call when ZLLM_QMM_HBM=1): K1's maths (q4k_matvec.cu),
// y[n] = sum_g of zllm's per-group epilogue over the int8-quantized
// activation row (GroupScale, matvec_common.cuh), with K1's prologues ("q",
// "norm", "glu").  The TPU kernel keeps the weight planes in HBM and
// double-buffers its own DMAs of the next K-step's tiles while the current
// one computes, the per-256 super planes fetched once per N tile.
//
// Bound on the H100: the weight bytes, read once (as K1's).  Design: where
// K1 loads each column's packed nibbles and scales straight into
// registers, here a block owns NB = 8 * cpw columns (a warp takes columns
// warp, warp + 8, ...) and walks K in stages of 1024 weights: each stage is
// the block's qs (512 bytes a column) and per-group scale planes for that
// K-step (Q4_K sc and mn, 32 bytes each; Q4_0 d, 64 bytes; Q4_1 a and b, 64
// bytes each), copied by all threads with cp.async (16- and 8-byte copies,
// one commit group a stage) into a ring of kStages shared buffers, so
// kStages - 1 K-steps are in flight while one computes.  For Q4_K the
// block's d / dmin runs (contiguous over its columns: K/256 halves a
// column) come with the first stage's group, once per block, as the TPU
// kernel fetches its super planes once per N tile; they are copied in
// 4-byte words from the word holding the first half (the run need not be
// 4-byte aligned), the last word cut to the plane's end.  The first stages
// are issued before the activation prologue, so HBM latency overlaps the
// quantization.  A lane computes exactly what it computes in K1 (chunk
// c = 16 * stage + lane / 2, its group 2c + lane % 2, the same epilogue,
// accumulated in the same order, then the same warp sum), so the result is
// K1's bit for bit in every format.
// At the decode shapes (K of at most eight stages, so the ring rarely
// refills) it runs slower than K1: a stage waits on the whole block's
// copies, where K1's warps each run on as their own loads land (PERF.md).

#include "matvec_common.cuh"

namespace {

using namespace zt;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;
constexpr int kChunks = 16;             // 64-weight chunks a stage holds per column
constexpr int kQsBytes = kChunks * 32;  // packed nibbles a column a stage

// a stage's per-group scale planes: how many, and their bytes a column
// (2 * kChunks groups; Q4_K one byte a group, Q4_0/Q4_1 one fp16)
template <int FMT>
struct StagePlanes {
  static constexpr int kCount = FMT == kQ40 ? 1 : 2;
  static constexpr int kBytes = FMT == kQ4K ? 2 * kChunks : 4 * kChunks;
  static constexpr int kCol = kQsBytes + kCount * kBytes;  // a column's stage bytes
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}
// a 4-byte copy of which only the first src_bytes are read (the rest zeroed)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// the dynamic shared memory of a block: the quantized row, the stage ring,
// then (Q4_K) the d and dmin runs (NB * K/256 halves each, plus one word of
// slack for the alignment shift)
template <int FMT>
struct Layout {
  size_t row, stages, dbuf, total;
  __host__ __device__ Layout(int K, int NB) {
    row = 0;
    stages = align16((size_t)K + (size_t)(K / 32) * 8);  // QuantRow<32>::bytes(K)
    dbuf = stages + (size_t)kStages * NB * StagePlanes<FMT>::kCol;
    total = dbuf + (FMT == kQ4K ? 2 * dbytes(K, NB) : 0);
  }
  __host__ __device__ static size_t dbytes(int K, int NB) {
    return align16((size_t)NB * (K / 256) * 2 + 4);
  }
};

// copy the fp16 plane run [e0, e1) (in halves) into dst, in 4-byte words
// from the word holding e0: dst[e0 % 2 + i] is then entry e0 + i
__device__ __forceinline__ void copy_run(unsigned char* dst, const __half* plane, size_t e0,
                                         size_t e1, size_t plane_halves) {
  const size_t w0 = (2 * e0) & ~(size_t)3;  // byte offset of the first word
  const size_t end = 2 * e1, plane_bytes = 2 * plane_halves;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(plane);
  for (size_t off = w0 + 4 * threadIdx.x; off < end; off += 4 * kThreads) {
    const size_t left = plane_bytes - off;
    cp_async4(dst + (off - w0), src + off, left < 4 ? (int)left : 4);
  }
}

template <typename TX, int MODE, int FMT>
__global__ void __launch_bounds__(kThreads) q4k_matvec_hbm_kernel(
    const TX* __restrict__ x, const float* __restrict__ aux, const NibblePlanes w,
    float* __restrict__ y, int K, int N, int cpw, float eps) {
  using SP = StagePlanes<FMT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int NB = kWarps * cpw;
  const int nchunk = K / 64, G = K / 32, KS = K / 256;
  const int n_stages = (nchunk + kChunks - 1) / kChunks;
  const Layout<FMT> lay(K, NB);
  const QuantRow<32> row(smem + lay.row, K);
  unsigned char* stages = smem + lay.stages;
  const size_t dbytes = Layout<FMT>::dbytes(K, NB);
  unsigned char* dsm = smem + lay.dbuf;
  unsigned char* dmsm = dsm + dbytes;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, part = lane & 1;
  const int n0 = blockIdx.x * NB;
  const int n_cols = min(NB, N - n0);  // the block's columns that exist
  // a group's bytes in a scale plane: Q4_K one, Q4_0/Q4_1 one fp16
  constexpr int kGroupBytes = FMT == kQ4K ? 1 : 2;
  const unsigned char* planes[2] = {static_cast<const unsigned char*>(w.s0),
                                    static_cast<const unsigned char*>(w.s1)};

  auto issue = [&](int t) {
    unsigned char* st = stages + (size_t)(t % kStages) * NB * SP::kCol;
    const int cr = min(kChunks, nchunk - t * kChunks);  // chunks this stage, a multiple of 4
    const int qp = cr * 2;                              // 16-byte pieces a column
    for (int i = threadIdx.x; i < n_cols * qp; i += kThreads) {
      const int ci = i / qp, p = i % qp;
      cp_async16(st + ci * kQsBytes + p * 16,
                 w.qs + (size_t)(n0 + ci) * (K / 2) + (size_t)t * kQsBytes + p * 16);
    }
    const int sp = cr * kGroupBytes / 4;  // 8-byte pieces a column, of each scale plane
    for (int i = threadIdx.x; i < n_cols * sp; i += kThreads) {
      const int ci = i / sp, p = i % sp;
      const size_t off = ((size_t)(n0 + ci) * G + (size_t)t * 2 * kChunks) * kGroupBytes + p * 8;
#pragma unroll
      for (int m = 0; m < SP::kCount; ++m)
        cp_async8(st + NB * (kQsBytes + m * SP::kBytes) + ci * SP::kBytes + p * 8,
                  planes[m] + off);
    }
    if (FMT == kQ4K && t == 0) {  // the block's super-block scales, once
      const size_t e0 = (size_t)n0 * KS, e1 = (size_t)(n0 + n_cols) * KS;
      copy_run(dsm, static_cast<const __half*>(w.s2), e0, e1, (size_t)N * KS);
      copy_run(dmsm, static_cast<const __half*>(w.s3), e0, e1, (size_t)N * KS);
    }
  };

  // the first K-steps are in flight while the activations are prepared
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_stages) issue(t);
    cp_commit();
  }
  quantize_row<TX, MODE, 32, kThreads>(x, aux, K, eps, row);

  const int shift = (int)((size_t)n0 * KS % 2);  // d/dmin runs start this many halves in
  const __half* dh = reinterpret_cast<const __half*>(dsm) + shift;
  const __half* dmh = reinterpret_cast<const __half*>(dmsm) + shift;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t = 0; t < n_stages; ++t) {
    cp_wait<kStages - 2>();  // this thread's copies of stage t have landed
    __syncthreads();         // everyone's have, and stage t - 1's slot is free
    if (t + kStages - 1 < n_stages) issue(t + kStages - 1);
    cp_commit();

    const unsigned char* st = stages + (size_t)(t % kStages) * NB * SP::kCol;
    const unsigned char* sp0 = st + NB * kQsBytes;
    const unsigned char* sp1 = sp0 + NB * SP::kBytes;
    const int c = t * kChunks + (lane >> 1);
    int4 xl = make_int4(0, 0, 0, 0), xh = xl;
    if (c < nchunk) {
      xl = *reinterpret_cast<const int4*>(row.xq + c * 64 + part * 16);
      xh = *reinterpret_cast<const int4*>(row.xq + c * 64 + 32 + part * 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= cpw) break;
      const int ci = j * kWarps + warp;
      if (ci >= n_cols) break;  // uniform across the warp
      int plo = 0, phi = 0;
      if (c < nchunk) {
        const uint4 wv = *reinterpret_cast<const uint4*>(st + ci * kQsBytes + lane * 16);
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
        // even lane takes group 2c (low nibbles), odd lane group 2c+1; the
        // group's place in the stage is the lane
        const int g = 2 * c + part;
        GroupScale<FMT> s;
        if constexpr (FMT == kQ4K) {
          s.sc = sp0[ci * SP::kBytes + lane];
          s.mn = sp1[ci * SP::kBytes + lane];
          s.d = dh[ci * KS + (g >> 3)];
          s.dmin = dmh[ci * KS + (g >> 3)];
        } else if constexpr (FMT == kQ40) {
          s.d = reinterpret_cast<const __half*>(sp0 + ci * SP::kBytes)[lane];
        } else {
          s.a = reinterpret_cast<const __half*>(sp0 + ci * SP::kBytes)[lane];
          s.b = reinterpret_cast<const __half*>(sp1 + ci * SP::kBytes)[lane];
        }
        acc[j] += group_term(s, part ? phi : plo, row.sx[g], row.dx[g]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= cpw) break;
    const int ci = j * kWarps + warp;
    if (ci >= n_cols) break;
    const float v = warp_sum(acc[j]);
    if (lane == 0) y[n0 + ci] = v;
  }
}

template <typename TX, int MODE, int FMT>
int launch(const void* x, const float* aux, const NibblePlanes& w, float* y, int K, int N,
           float eps, cudaStream_t stream) {
  // K1's choice of columns per warp, so the blocks cover the same columns
  int cpw = N / (kWarps * 2 * 132);
  cpw = cpw < 1 ? 1 : (cpw > 4 ? 4 : cpw);
  const int per_block = kWarps * cpw;
  const size_t bytes = Layout<FMT>(K, per_block).total;
  auto kern = q4k_matvec_hbm_kernel<TX, MODE, FMT>;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((N + per_block - 1) / per_block);
  kern<<<grid, kThreads, bytes, stream>>>(static_cast<const TX*>(x), aux, w, y, K, N, cpw, eps);
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
