// The sliced dequant-GEMM loop of K3 (q4k_gemm.cu: Q4_K, Q4_0, Q4_1) and
// K5 (dequant_gemm.cu: Q6_K, Q8_0): y[M, N] (f32) = bf16(x)[M, K] @
// bf16(dequant(W)), templated on the weight decoder W, in zllm's sum order
// (_qmm_kernel): K is cut into slices of tk = 512 (256 when K % 512 != 0);
// each slice's product P_s is a chain of
// mma.sync m16n8k16 (bf16 x bf16 -> f32) over the slice's 16-wide k-steps
// in k order, from zero, and y = ((0 + P_0) + P_1) + ... in slice order.
// An MMA's output element depends only on its own row of A and column of
// B, so every row's bits are the same whatever M is, whatever the other
// rows hold, and whichever form below ran it.
//
// One loop, two shapes (the `Form`s below):
//   RowForm (the engine's 4-row decode step, and any call whose 128 x 128
//     tiles times slices would not fill the SMs): blocks of 16 rows x 32
//     columns, 4 warps, one n8 tile each; one slice a block, so the grid is
//     rows x columns x slices and every slice's bytes are in flight at once.
//   TileForm (prefill chunks, the engine's mixed step): blocks of 128 rows
//     x 128 columns, 16 warps of 32 x 32, so a weight step is dequantized
//     once for 128 rows and an x step serves 128 columns; when the output
//     tiles alone leave SMs idle the slices are split over blocks too.
// The caller picks the form; the bits do not depend on it.  Any even N:
// the last column block masks the columns past N (their weights zeroed,
// their outputs not stored).
// A block walks its slices in 64-wide steps.  Each step's x piece (bf16)
// and raw weight bytes go into a ring of NST stages in shared memory with
// cp.async (x rows XOR-swizzled in 16-byte units, so ldmatrix reads them
// where they land, without bank conflicts); each thread dequantizes exactly
// the weight bytes it copied itself (through W's exact dequant, rounded to
// bf16, round to nearest even), so that needs no barrier before it (a
// decoder may pass scale words it copied to the other threads of its column
// through registers, with __shfl_sync).  The
// dequantized weight tiles are double-buffered: step c's MMAs run while
// step c+1 is dequantized into the other buffer, one barrier a step.
// x comes in bf16: an f32 x is first rounded to bf16 (round to nearest
// even, as the Pallas kernels round it) by `round_x_kernel`, once a call
// instead of once a column block.
//
// What bounds it on the H100 (`python -m zllm_torch.k5_ablation` times each
// part taken out): in TileForm, shared memory bandwidth, most of it the
// ldmatrix fragment loads (a 32 x 32 warp tile reloads 2 KB for 8 MMAs),
// then the barrier and the weight copies; in RowForm at M = 4, the
// latency of each call and its launches.  wgmma, which reads both operands
// from shared memory without staging them in registers, is the next step.
//
// Reduction.  With one split (gridDim.z == 1) a block folds its slices in
// registers and writes y.  With more, the first split folds its slices
// 0..spb-1 and writes that prefix, every other block writes each of its
// slices' P_s to a workspace, and `slice_reduce_kernel` (a second launch)
// continues the fold in slice order: the same bits as one block's fold,
// with no float atomics, the same on every call.
//
// A decoder W (4 threads a column, the lanes 4j..4j+3 of a warp, each 16
// of a step's 64 k) provides
//   static constexpr int kPieces;    16-byte pieces a thread copies a step,
//                                    besides one 4-byte scale word
//   void fetch(uint4* p, int stride, uint32_t* word, size_t col, int c, int q) const;
//        cp.async the bytes of step c (64-wide, global index; a block's
//        first step is even) for thread q of the column into p[0],
//        p[stride], ... and *word
//   void dequant(const uint4* p, const uint4* prev, int stride, uint32_t word,
//                size_t col, int c, int q, uint4 (&v)[2]) const;
//        16 bf16 values, two 16-byte units of the step's 64-wide weight
//        row; prev holds this thread's pieces of step c-1 (still in the
//        ring), so an odd step may reuse bytes the even one fetched; called
//        by every thread of the block at once (a shuffle may exchange the
//        column's scale words)
//   static int slot(int q, int i);   the unit (k / 8, 0..7) v[i] fills

#pragma once

#include "mma_ptx.cuh"

namespace zt_slice {

using zt::cp_async16;
using zt::cp_async_commit;
using zt::ldmatrix_x4;
using zt::mma_bf16;

constexpr int BK = 64, PAD = 8, LDS = BK + PAD;

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 or 8 bytes global -> shared, asynchronous
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(a), "l"(gmem) : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* smem_row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a)
               : "memory");
}

// warps WGM x WGN, each MI m16 x NI n8 tiles; NST ring stages; at least
// kMinBlocks blocks an SM (a register cap for ptxas)
template <int WGM_, int WGN_, int MI_, int NI_, int NST_, int kMinBlocks_>
struct Form {
  static constexpr int WGM = WGM_, WGN = WGN_, MI = MI_, NI = NI_, NST = NST_;
  static constexpr int kMinBlocks = kMinBlocks_;
  static constexpr int BM = WGM * MI * 16, BN = WGN * NI * 8, kThreads = 32 * WGM * WGN;
  static_assert(kThreads == 4 * BN, "four threads a weight column");
  static_assert(NI == 1 || NI % 2 == 0, "B fragments come in n16 pairs");
};
using RowForm = Form<1, 4, 1, 1, 4, 4>;
using TileForm = Form<4, 4, 2, 4, 4, 1>;

template <class F, class W>
constexpr size_t smem_bytes() {
  return (size_t)F::NST * F::BM * BK * sizeof(__nv_bfloat16)         // x ring
         + (size_t)F::NST * F::kThreads * (16 * W::kPieces + 4)      // weight ring
         + (size_t)2 * F::BN * LDS * sizeof(__nv_bfloat16);          // weight tiles
}

// 16-byte unit j of x row r within a ring stage (rows of BK bf16)
__device__ __forceinline__ int xswz(int r, int j) { return r * BK + ((j ^ (r & 7)) << 3); }

// sps: 64-wide steps a slice; spb: slices a split (blockIdx.z); ws: the
// workspace from the first split's prefix slot on (unused when gridDim.z == 1)
template <class F, class W>
__global__ void __launch_bounds__(F::kThreads, F::kMinBlocks) slice_gemm_kernel(
    const __nv_bfloat16* __restrict__ x, const W w, float* __restrict__ y,
    float* __restrict__ ws, int M, int K, int N, int sps, int spb) {
  constexpr int BM = F::BM, BN = F::BN, T = F::kThreads, NST = F::NST;
  constexpr int MI = F::MI, NI = F::NI;
  constexpr int kXPieces = BM * (BK / 8) / T;  // 16-byte x pieces a thread copies a step
  static_assert(kXPieces * T == BM * (BK / 8), "x pieces split evenly");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem);           // [NST][BM][BK]
  uint4* Rp = reinterpret_cast<uint4*>(Xs + NST * BM * BK);             // [NST][kPieces][T]
  uint32_t* Rw = reinterpret_cast<uint32_t*>(Rp + NST * W::kPieces * T);  // [NST][T]
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(Rw + NST * T);   // [2][BN][LDS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // row blocks fastest, so the blocks that share a weight tile run together
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int wm = (warp / F::WGN) * MI * 16, wn = (warp % F::WGN) * NI * 8;
  const int gid = lane >> 2, tig = lane & 3;
  const int S = K / (sps * BK);
  const int s0 = blockIdx.z * spb, s1 = min(S, s0 + spb);
  const int c0 = s0 * sps, nsteps = (s1 - s0) * sps;
  const bool first = blockIdx.z == 0;

  // weight thread -> (column, k quarter of the step)
  const int bn = tid >> 2, bq = tid & 3;
  const bool col_ok = n0 + bn < N;
  const size_t ccol = col_ok ? (size_t)(n0 + bn) : 0;

  auto issue = [&](int c) {  // local step c into ring stage c % NST
    if (c < nsteps) {
      const int st = c % NST, g = c0 + c;
      __nv_bfloat16* xs = Xs + st * BM * BK;
#pragma unroll
      for (int i = 0; i < kXPieces; ++i) {
        const int p = tid + T * i, r = p >> 3, j = p & 7;
        const bool ok = m0 + r < M;
        cp_async16(xs + xswz(r, j), x + (size_t)(ok ? m0 + r : 0) * K + g * BK + j * 8,
                   ok ? 16 : 0);
      }
      w.fetch(Rp + st * W::kPieces * T + tid, T, Rw + st * T + tid, ccol, g, bq);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  auto convert = [&](int c) {  // ring stage c % NST -> weight tile c & 1
    const int st = c % NST;
    uint4 v[2];
    w.dequant(Rp + st * W::kPieces * T + tid, Rp + (c + NST - 1) % NST * W::kPieces * T + tid,
              T, Rw[st * T + tid], ccol, c0 + c, bq, v);
    if (!col_ok) v[0] = v[1] = make_uint4(0u, 0u, 0u, 0u);
    uint4* brow = reinterpret_cast<uint4*>(Bs + (c & 1) * BN * LDS + bn * LDS);
    brow[W::slot(bq, 0)] = v[0];
    brow[W::slot(bq, 1)] = v[1];
  };
  auto store = [&](float* out, const float (&a)[MI][NI][4]) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = n0 + wn + ni * 8 + tig * 2;  // N is even
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm + mi * 16 + gid + h * 8;
          if (row < M && col < N)
            *reinterpret_cast<float2*>(out + (size_t)row * N + col) =
                make_float2(a[mi][ni][2 * h], a[mi][ni][2 * h + 1]);
        }
      }
  };

  float acc[MI][NI][4], tot[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = tot[mi][ni][e] = 0.f;

#pragma unroll
  for (int i = 0; i < NST - 1; ++i) issue(i);
  cp_async_wait<NST - 2>();
  convert(0);
  __syncthreads();

  for (int c = 0; c < nsteps; ++c) {
    issue(c + NST - 1);
    const __nv_bfloat16* xs = Xs + (c % NST) * BM * BK;
    const __nv_bfloat16* bs = Bs + (c & 1) * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MI][4], bf[NI][2];
      // A (16x16 at rows wm+16mi..): matrices (rows 0-7 | 8-15) x (k | k+8)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(af[mi], xs + xswz(wm + mi * 16 + (lane & 15), (kk >> 3) + (lane >> 4)));
      if constexpr (NI == 1) {
        // B (one n8 tile): matrices (n 0-7, k) (n 0-7, k+8)
        ldmatrix_x2(bf[0], bs + (wn + (lane & 7)) * LDS + kk + ((lane >> 3) & 1) * 8);
      } else {
        // B (n8 pairs): matrices (n 0-7, k) (n 0-7, k+8) (n 8-15, k) (n 8-15, k+8)
#pragma unroll
        for (int np = 0; np < NI / 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4(r, bs + (wn + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS + kk +
                             ((lane >> 3) & 1) * 8);
          bf[2 * np][0] = r[0];
          bf[2 * np][1] = r[1];
          bf[2 * np + 1][0] = r[2];
          bf[2 * np + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
    }
    if ((c + 1) % sps == 0) {  // the end of slice s: fold it, or hand it over
      const int s = s0 + (c + 1) / sps - 1;
      if (first) {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) tot[mi][ni][e] += acc[mi][ni][e];
      } else {
        store(ws + (size_t)(s - spb + 1) * M * N, acc);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
    if (c + 1 < nsteps) {
      cp_async_wait<NST - 2>();  // this thread's copies of step c+1 have landed
      convert(c + 1);
    }
    __syncthreads();  // every thread's step c+1 in place; step c's stage free
  }
  if (first) store(gridDim.z == 1 ? y : ws, tot);
}

// y = ws[0] + ws[1] + ... + ws[n - 1], in that order (the partials M*N =
// mn floats apart), four elements a thread; float4 loads when mn % 4 == 0
__global__ void slice_reduce_kernel(const float* __restrict__ ws, float* __restrict__ y, int mn,
                                    int n) {
  const int i = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= mn) return;
  if (!(mn & 3)) {
    float4 a = *reinterpret_cast<const float4*>(ws + i);
    for (int s = 1; s < n; ++s) {
      const float4 b = *reinterpret_cast<const float4*>(ws + (size_t)s * mn + i);
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    *reinterpret_cast<float4*>(y + i) = a;
  } else {
    for (int j = i; j < min(i + 4, mn); ++j) {
      float a = ws[j];
      for (int s = 1; s < n; ++s) a += ws[(size_t)s * mn + j];
      y[j] = a;
    }
  }
}

// xb = bf16(x), round to nearest even; n4 = M*K/4
__global__ void round_x_kernel(const float4* __restrict__ x, uint2* __restrict__ xb, int n4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4 v = x[i];
  xb[i] = make_uint2(zt::pack_bf16(v.x, v.y), zt::pack_bf16(v.z, v.w));
}

template <class F, class W>
int launch_form(const __nv_bfloat16* x, const W& w, float* y, float* ws, int M, int K, int N,
                int sps, int spb, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<F, W>();
  static bool attr = false;  // raise the dynamic shared memory cap once
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        slice_gemm_kernel<F, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const int S = K / (sps * BK), nsplit = (S + spb - 1) / spb;
  const dim3 grid((M + F::BM - 1) / F::BM, (N + F::BN - 1) / F::BN, nsplit);
  slice_gemm_kernel<F, W><<<grid, F::kThreads, smem, s>>>(x, w, y, ws, M, K, N, sps, spb);
  if (nsplit > 1) {
    const int mn = M * N, threads = (mn + 3) / 4;
    slice_reduce_kernel<<<(threads + 255) / 256, 256, 0, s>>>(ws, y, mn, S - spb + 1);
  }
  return (int)cudaGetLastError();
}

// xdtype: 0 = f32 (rounded into xb, M*K bf16, first), 1 = bf16 (xb
// unused).  tk: the slice width (256 or 512, dividing K); form: 0 = RowForm
// (spb = 1), 1 = TileForm; spb: slices a split, ws: (S - spb + 1) * M * N
// floats when spb < S (S = K / tk), else unused.  Any even N.
template <class W>
int launch_slice_gemm(const void* x, int xdtype, void* xb, const W& w, float* y, float* ws,
                      int M, int K, int N, int tk, int form, int spb, cudaStream_t s) {
  if (M <= 0 || N <= 0 || N % 2 || (tk != 256 && tk != 512) || K % tk || spb < 1 ||
      (xdtype != 0 && xdtype != 1) || (xdtype == 0 && !xb) || (form != 0 && form != 1) ||
      (form == 0 && spb != 1) || (spb < K / tk && !ws))
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* xr = static_cast<const __nv_bfloat16*>(x);
  if (xdtype == 0) {
    const int n4 = M * K / 4;
    round_x_kernel<<<(n4 + 255) / 256, 256, 0, s>>>(static_cast<const float4*>(x),
                                                    static_cast<uint2*>(xb), n4);
    xr = static_cast<const __nv_bfloat16*>(xb);
  }
  const int sps = tk / BK;
  return form == 0 ? launch_form<RowForm>(xr, w, y, ws, M, K, N, sps, spb, s)
                   : launch_form<TileForm>(xr, w, y, ws, M, K, N, sps, spb, s);
}

}  // namespace zt_slice
