// The activation prologue shared by the decode matvecs K1 (q4k_matvec.cu),
// K12 (q4k_matvec_hbm.cu), K4 (int8_matvec.cu) and K11 (w4a8dd_matvec.cu),
// their launch machinery (programmatic dependent launch, the glu prologue
// shared by a thread-block cluster, one wave of blocks), and the nibble
// formats' scales and epilogue (below):
// the counterpart of zllm/ops/qmatmul.py::
// _prologue_quant.  prologue(x) is "q" (x as is), "norm" (rms_norm(x) * w,
// the full-row mean square reduced first) or "glu" (silu(g) * u over the
// fused gate|up row); the f32 row is then quantized to int8 per GROUP-wide
// group: dx = max(max|v| / 127, 1e-12), q = clip(rint(v / dx), -127, 127),
// with IEEE division, as the Pallas kernel rounds (the library is built
// without fast math).  Every block quantizes the whole row into its shared
// memory (for "glu" in K1 and K4: the blocks of a cluster share the work);
// GROUP/4 lanes take a group, four elements a lane; the blocks are 512
// threads (K11's one-block quantize_acts op: 256).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

namespace zt {

constexpr unsigned kFull = 0xffffffffu;

enum Fuse { kQ = 0, kNorm = 1, kGlu = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Shared memory the prologue fills, carved from the dynamic buffer `smem`
// (K + 8 * K / GROUP bytes): int8 codes [K], f32 scales [K/GROUP], int32
// code sums [K/GROUP].
template <int GROUP>
struct QuantRow {
  int8_t* xq;
  float* dx;
  int* sx;
  __device__ QuantRow(unsigned char* smem, int K)
      : xq(reinterpret_cast<int8_t*>(smem)),
        dx(reinterpret_cast<float*>(smem + K)),
        sx(reinterpret_cast<int*>(smem + K) + K / GROUP) {}
  static size_t bytes(int K) { return (size_t)K + (size_t)(K / GROUP) * 8; }
};

// The f32 value prologue(x)[k] ("norm": r is the row's rsqrt(mean square + eps))
template <typename TX, int MODE>
__device__ __forceinline__ float prologue_value(const TX* __restrict__ x,
                                                const float* __restrict__ aux, int K, int k,
                                                float r) {
  if (MODE == kNorm) return to_f(x[k]) * aux[k] * r;
  if (MODE == kGlu) {
    const float gg = to_f(x[k]);
    const float u = to_f(x[K + k]);
    return gg * (1.f / (1.f + expf(-gg))) * u;
  }
  return to_f(x[k]);
}

// One GROUP-wide group quantized by its GROUP/4 lanes (adjacent, all of the
// warp's lanes in step), four values v a lane: the lane's int8 codes, and
// the group's dx and code sum in every one of its lanes.
template <int GROUP>
__device__ __forceinline__ void quantize_group(const float (&v)[4], char4& codes, float& dx,
                                               int& sx) {
  constexpr int kLanes = GROUP / 4;
  float am = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3])));
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) am = fmaxf(am, __shfl_xor_sync(kFull, am, o));
  dx = fmaxf(am / 127.f, 1e-12f);
  int q[4];
  sx = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    q[i] = (int)fminf(fmaxf(rintf(v[i] / dx), -127.f), 127.f);
    sx += q[i];
  }
  codes = make_char4(q[0], q[1], q[2], q[3]);
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) sx += __shfl_xor_sync(kFull, sx, o);
}

// All THREADS threads of the block call this together.  K / GROUP must be a
// multiple of 32 * 4 / GROUP groups (K % 256 == 0 covers GROUP 16 and 32),
// so that every lane of a warp takes part in each round's shuffles.  Ends
// with a barrier: the row is ready in shared memory.
template <typename TX, int MODE, int GROUP, int THREADS>
__device__ __forceinline__ void quantize_row(const TX* __restrict__ x,
                                             const float* __restrict__ aux, int K, float eps,
                                             QuantRow<GROUP> row) {
  constexpr int kLanes = GROUP / 4;  // lanes per group
  // the mean square is summed as 256 threads sum it, whatever THREADS is,
  // so that every caller gives a row the same bits
  constexpr int kSum = 256;
  static_assert(THREADS % kSum == 0, "THREADS: a multiple of 256");
  __shared__ float red[kSum / 32];
  __shared__ float rscale;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float r = 1.f;
  if (MODE == kNorm) {
    if (tid < kSum) {
      float s = 0.f;
      for (int k = tid; k < K; k += kSum) {
        const float v = to_f(x[k]);
        s += v * v;
      }
      s = warp_sum(s);
      if (lane == 0) red[warp] = s;
    }
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < kSum / 32; ++w) t += red[w];
      rscale = rsqrtf(t / (float)K + eps);
    }
    __syncthreads();
    r = rscale;
  }

  const int sub = lane & (kLanes - 1);
  const int G = K / GROUP;
  for (int g = tid / kLanes; g < G; g += THREADS / kLanes) {
    const int k0 = g * GROUP + sub * 4;
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = prologue_value<TX, MODE>(x, aux, K, k0 + i, r);
    char4 codes;
    float dx;
    int sx;
    quantize_group<GROUP>(v, codes, dx, sx);
    *reinterpret_cast<char4*>(row.xq + k0) = codes;
    if (sub == 0) {
      row.dx[g] = dx;
      row.sx[g] = sx;
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The launch machinery of K1, K4, K11 and K12: programmatic dependent
// launch (PDL), the glu prologue split over a thread-block cluster, one
// wave of blocks.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void grid_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// The glu row quantized by the blocks of a thread-block cluster together
// (a launch without clusters: by the block alone).  Block `rank` of n takes
// groups [rank * G / n, (rank + 1) * G / n) -- G / n a multiple of the
// 128 / GROUP groups a warp quantizes at once, so a warp's lanes take whole
// groups in step -- and stores each group's codes, dx and code sum into
// every block's shared row.  The caller arrived on the cluster barrier at
// its start; the wait here makes sure every peer runs (its shared memory
// exists) before the first store to it, and the closing cluster.sync()
// that every store has landed before any block reads.
template <typename TX, int GROUP, int THREADS>
__device__ __forceinline__ void quantize_glu_cluster(const TX* __restrict__ x, int K,
                                                     const QuantRow<GROUP>& row) {
  namespace cg = cooperative_groups;
  constexpr int kLanes = GROUP / 4;  // lanes per group
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int G = K / GROUP, g1 = (rank + 1) * G / n;
  const int sub = threadIdx.x & (kLanes - 1);
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  for (int g = rank * G / n + threadIdx.x / kLanes; g < g1; g += THREADS / kLanes) {
    const int k0 = g * GROUP + sub * 4;
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = prologue_value<TX, kGlu>(x, nullptr, K, k0 + i, 1.f);
    char4 codes;
    float dx;
    int sx;
    quantize_group<GROUP>(v, codes, dx, sx);
    for (int r = 0; r < n; ++r) {
      *reinterpret_cast<char4*>(cluster.map_shared_rank(row.xq, r) + k0) = codes;
      if (sub == 0) {
        cluster.map_shared_rank(row.dx, r)[g] = dx;
        cluster.map_shared_rank(row.sx, r)[g] = sx;
      }
    }
  }
  cluster.sync();
}

// blocks a cluster for a glu row of K: 4 where a quarter of its K / GROUP
// groups is a multiple of the 128 / GROUP a warp takes at once, else 2 (K
// % 256 == 0 makes half of them one); for both GROUP 16 and 32 the rule is
// K % 512 == 0
template <int GROUP>
inline int glu_cluster(int K) {
  return (K / GROUP) % (4 * (128 / GROUP)) == 0 ? 4 : 2;
}

// the card's SM count in *sms; a CUDA error code
inline int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

// columns a warp for one wave of at most two blocks an SM of `warps` warps
inline int wave_cols(int N, int sms, int warps) {
  return (N + 2 * sms * warps - 1) / (2 * sms * warps);
}

// The launch of a decode matvec: `blocks` blocks (rounded up to a multiple
// of the cluster) of `threads`, `smem` bytes of dynamic shared memory, a
// cluster of `cluster` blocks where it is > 1, and programmatic stream
// serialization, through cudaLaunchKernelEx; a CUDA error code.
template <typename... KArgs, typename... Args>
int launch_matvec(void (*kernel)(KArgs...), int blocks, int threads, size_t smem, int cluster,
                  cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((blocks + cluster - 1) / cluster * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  int na = 0;
  if (cluster > 1) {
    attr[na].id = cudaLaunchAttributeClusterDimension;
    attr[na].val.clusterDim.x = cluster;
    attr[na].val.clusterDim.y = 1;
    attr[na].val.clusterDim.z = 1;
    ++na;
  }
  attr[na].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[na].val.programmaticStreamSerializationAllowed = 1;
  ++na;
  cfg.attrs = attr;
  cfg.numAttrs = na;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The nibble formats of K1, K11, K12 (and K3's decoders, q4k_gemm.cu): one code
// plane qs [N, K/2] (byte 32c + i holds the low four bits of codes 64c + i
// and 64c + 32 + i, zllm_torch/quant/repack.py) and per-format planes,
// passed as s0..s3:
//   Q4_K: s0 = sc, s1 = mn (uint8 [N, K/32]), s2 = d, s3 = dmin (fp16 [N, K/256])
//   Q4_0: s0 = d (fp16 [N, K/32])
//   Q4_1: s0 = a, s1 = b (fp16 [N, K/32]; b = -m)
//   Q5_0: s0 = d (fp16 [N, K/32]), s3 = qh
//   Q5_1: s0 = a, s1 = b (fp16 [N, K/32]; b = -m), s3 = qh
//   Q5_K: s0 = a, s1 = b (fp16 [N, K/32]; fp16(d * sc), fp16(dmin * mn)), s3 = qh
// qh (uint8 [N, K/8], the 5-bit formats' fifth bits; K1 and K3 only): its
// u32 word 2c + p holds in bit j the fifth bit of code 64c + 16p + j and in
// bit 16 + j that of code 64c + 32 + 16p + j (j < 16): the bits of the
// bytes [16p, 16p + 16) of chunk c's 32 qs bytes, low nibbles then high.
// GroupScale<FMT> holds one 32-group's scales in registers and applies
// zllm's f32 epilogue to the group's exact integer dot pi (sx: the group's
// activation code sum, e = dx * sx):
//   Q4_K, Q4_1, Q5_1, Q5_K: pi * a * dx - b * e
//   Q4_0: (pi - 8 * sx) * d * dx, Q5_0: (pi - 16 * sx) * d * dx, the
//   offset applied to the integers
// ---------------------------------------------------------------------------

enum NibbleFmt { kQ4K = 0, kQ40 = 1, kQ41 = 2, kQ50 = 3, kQ51 = 4, kQ5K = 5 };

// the 5-bit formats, whose codes take their fifth bit from the qh plane
template <int FMT>
constexpr bool kHasQh = FMT == kQ50 || FMT == kQ51 || FMT == kQ5K;

// bits 4j .. 4j + 3 of h, as bit 4 of the four bytes of a word: the fifth
// bits of the four codes whose low nibbles a __dp4a word holds (bit 4j + e
// -> bit 8e + 4; the four shifted copies of the multiply do not overlap)
__device__ __forceinline__ uint32_t fifth_bits4(uint32_t h, int j) {
  return (((h >> (4 * j)) & 0xFu) * 0x02040810u) & 0x10101010u;
}

struct NibblePlanes {
  const uint8_t* qs;
  const void* s0;
  const void* s1;
  const void* s2;
  const void* s3;
};

template <int FMT>
struct GroupScale;

template <>
struct GroupScale<kQ4K> {
  uint8_t sc, mn;
  __half d, dmin;
  __device__ __forceinline__ void load(const NibblePlanes& p, size_t n, int g, int K) {
    const int G = K / 32;
    sc = static_cast<const uint8_t*>(p.s0)[n * G + g];
    mn = static_cast<const uint8_t*>(p.s1)[n * G + g];
    d = static_cast<const __half*>(p.s2)[n * (K / 256) + (g >> 3)];
    dmin = static_cast<const __half*>(p.s3)[n * (K / 256) + (g >> 3)];
  }
  __device__ __forceinline__ float term_e(int pi, int, float dx, float e) const {
    const float a = __half2float(d) * (float)sc;
    const float b = __half2float(dmin) * (float)mn;
    return (float)pi * a * dx - b * e;
  }
};

template <>
struct GroupScale<kQ40> {
  __half d;
  __device__ __forceinline__ void load(const NibblePlanes& p, size_t n, int g, int K) {
    d = static_cast<const __half*>(p.s0)[n * (K / 32) + g];
  }
  __device__ __forceinline__ float term_e(int pi, int sx, float dx, float) const {
    return (float)(pi - 8 * sx) * __half2float(d) * dx;
  }
};

template <>
struct GroupScale<kQ41> {
  __half a, b;
  __device__ __forceinline__ void load(const NibblePlanes& p, size_t n, int g, int K) {
    a = static_cast<const __half*>(p.s0)[n * (K / 32) + g];
    b = static_cast<const __half*>(p.s1)[n * (K / 32) + g];
  }
  __device__ __forceinline__ float term_e(int pi, int, float dx, float e) const {
    return (float)pi * __half2float(a) * dx - __half2float(b) * e;
  }
};

// Q5_1 and Q5_K: Q4_1's planes and arithmetic over 5-bit codes
template <>
struct GroupScale<kQ51> : GroupScale<kQ41> {};
template <>
struct GroupScale<kQ5K> : GroupScale<kQ41> {};

template <>
struct GroupScale<kQ50> {
  __half d;
  __device__ __forceinline__ void load(const NibblePlanes& p, size_t n, int g, int K) {
    d = static_cast<const __half*>(p.s0)[n * (K / 32) + g];
  }
  __device__ __forceinline__ float term_e(int pi, int sx, float dx, float) const {
    return (float)(pi - 16 * sx) * __half2float(d) * dx;
  }
};

// the epilogue with e computed from the code sum, as K1 and K12 take it
template <int FMT>
__device__ __forceinline__ float group_term(const GroupScale<FMT>& s, int pi, int sx, float dx) {
  return s.term_e(pi, sx, dx, dx * (float)sx);
}

// one column's nibble-weight data for up to ROUNDS rounds of 16 chunks, in
// the registers of the lane pair that takes chunk c_base + 16 * round +
// lane / 2: lane % 2 holds bytes [16 * (lane % 2), +16) of the chunk's 32,
// the scales of its group 2c + lane % 2 and, in a 5-bit format, the qh
// word 2c + lane % 2 (K1 and K11)
template <int FMT, int ROUNDS>
struct ColRegs {
  uint4 wv[ROUNDS];
  GroupScale<FMT> s[ROUNDS];
  uint32_t qh[kHasQh<FMT> ? ROUNDS : 1];  // unused in the 4-bit formats
};

template <int FMT, int ROUNDS>
__device__ __forceinline__ void fetch_col(ColRegs<FMT, ROUNDS>& cr, const NibblePlanes& w, int n,
                                          int K, int c_base, int lane) {
  const int nchunk = K / 64, part = lane & 1;
#pragma unroll
  for (int it = 0; it < ROUNDS; ++it) {
    const int c = c_base + it * 16 + (lane >> 1);
    if (c < nchunk) {
      cr.wv[it] =
          *reinterpret_cast<const uint4*>(w.qs + (size_t)n * (K / 2) + c * 32 + part * 16);
      cr.s[it].load(w, (size_t)n, 2 * c + part, K);
      if constexpr (kHasQh<FMT>)
        cr.qh[it] = static_cast<const uint32_t*>(w.s3)[(size_t)n * (K / 32) + 2 * c + part];
    }
  }
}

}  // namespace zt
