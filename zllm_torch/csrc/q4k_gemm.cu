// K3: Q4_K prefill GEMM, y[M, N] (f32) = bf16(x)[M, K] @ bf16(dequant(W)).
//
// Replaces zllm/ops/qmatmul.py::_qmm_np_kernel (launched by _qmm_np_call):
// the weight is dequantized with the exact two-level Q4_K scales
// (w = code * f32(d)*sc - f32(dmin)*mn, in f32) and rounded to bf16; x
// (f32 or bf16) is rounded to bf16 in the kernel, round to nearest even,
// as the Pallas kernel rounds it; the products are accumulated in f32.
//
// Bound on the H100: at prefill shapes (M = 256 rows a chunk) the
// 2*M*K*N bf16 FLOPs over the 989 TFLOP/s tensor-core peak; the weight
// bytes are read once per 64-row block of x.  Design (simple first):
// 64x64 output tiles, four warps of 32x32, K in steps of 64 (one Q4_K
// chunk: 32 packed bytes per column, groups 2c and 2c+1).  The x tile of
// the next step is copied with cp.async into a staging tile in x's own
// dtype (16-byte pieces, consecutive threads on consecutive pieces), so
// it costs no registers while it is in flight; each thread later rounds
// the pieces it copied itself to bf16 into the mma tile, which needs no
// barrier between the copy and the read.  The next step's packed nibbles
// and scales are loaded into registers before this step's mma (a register
// double buffer) and dequantized into shared memory with 16-byte stores.
// mma.sync m16n8k16 bf16 -> f32 is fed with ldmatrix.  Rows and columns
// past M and N are masked.  No TMA pipeline and no wgmma yet.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 64, PAD = 8;
constexpr int kThreads = 128;

// four 8x8 b16 matrices from shared memory; lane l gives the row address
// of matrix l/8
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem_row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared, asynchronous; src_bytes = 0 fills zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the per-thread weight data of one K step, held in registers
struct Stage {
  uint4 wv;  // 32 packed nibbles
  float alo, blo, ahi, bhi;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// one 16-byte piece of x rounded to bf16 and stored at dst
__device__ __forceinline__ void round_piece(const float* src, __nv_bfloat16* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}
__device__ __forceinline__ void round_piece(const __nv_bfloat16* src, __nv_bfloat16* dst) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

template <typename XT>
__global__ void __launch_bounds__(kThreads) q4k_gemm_kernel(
    const XT* __restrict__ x, const uint8_t* __restrict__ qs, const uint8_t* __restrict__ sc,
    const uint8_t* __restrict__ mn, const __half* __restrict__ d,
    const __half* __restrict__ dmin, float* __restrict__ y, int M, int K, int N) {
  constexpr int kPer = 16 / sizeof(XT);             // x elements in a 16-byte piece
  constexpr int kRowPieces = BK / kPer;              // pieces in a row of the x tile
  constexpr int kPieces = BM * kRowPieces / kThreads;  // pieces a thread copies a step
  __shared__ __align__(16) XT Xs[BM][BK];                    // x tile as stored, staging
  __shared__ __align__(16) __nv_bfloat16 As[BM][BK + PAD];  // x tile [m][k], bf16
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][BK + PAD];  // w tile [n][k]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int G = K / 32, nk = K / BK;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // weight loader: thread -> (column, 16-byte half of the chunk)
  const int bn = tid >> 1, bh = tid & 1;
  const int ncol = n0 + bn;
  const bool col_ok = ncol < N;
  const size_t ccol = col_ok ? (size_t)ncol : 0;

  // x pieces of this thread: piece p = tid + kThreads * i of the tile
  auto copy_x = [&](int c) {
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int p = tid + kThreads * i, r = p / kRowPieces, col = (p % kRowPieces) * kPer;
      const bool ok = m0 + r < M;
      const XT* src = x + (size_t)(ok ? m0 + r : 0) * K + c * BK + col;
      cp_async16(&Xs[r][col], src, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  auto round_x = [&]() {
    cp_async_wait_all();  // this thread's own pieces have landed
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int p = tid + kThreads * i, r = p / kRowPieces, col = (p % kRowPieces) * kPer;
      round_piece(&Xs[r][col], &As[r][col]);
    }
  };
  auto fetch_w = [&](int c, Stage& st) {
    st.wv = *reinterpret_cast<const uint4*>(qs + ccol * (K / 2) + c * 32 + bh * 16);
    const int g = 2 * c;  // groups 2c (low nibbles) and 2c+1 (high); one superblock
    const float dd = __half2float(d[ccol * (K / 256) + (g >> 3)]);
    const float dm = __half2float(dmin[ccol * (K / 256) + (g >> 3)]);
    st.alo = dd * (float)sc[ccol * G + g];
    st.blo = dm * (float)mn[ccol * G + g];
    st.ahi = dd * (float)sc[ccol * G + g + 1];
    st.bhi = dm * (float)mn[ccol * G + g + 1];
  };
  auto store_w = [&](const Stage& st) {
    uint32_t lo[8], hi[8];
    const uint32_t words[4] = {st.wv.x, st.wv.y, st.wv.z, st.wv.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint32_t b0 = (words[w] >> (16 * p)) & 0xFFu, b1 = (words[w] >> (16 * p + 8)) & 0xFFu;
        lo[2 * w + p] = pack_bf16((float)(b0 & 0xFu) * st.alo - st.blo,
                                  (float)(b1 & 0xFu) * st.alo - st.blo);
        hi[2 * w + p] = pack_bf16((float)(b0 >> 4) * st.ahi - st.bhi,
                                  (float)(b1 >> 4) * st.ahi - st.bhi);
      }
    }
    if (!col_ok) {
#pragma unroll
      for (int i = 0; i < 8; ++i) lo[i] = hi[i] = 0u;
    }
    uint4* brow = reinterpret_cast<uint4*>(&Bs[bn][0]);
    brow[bh * 2] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    brow[bh * 2 + 1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    brow[4 + bh * 2] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    brow[4 + bh * 2 + 1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
  };

  Stage st;
  copy_x(0);
  fetch_w(0, st);
  for (int c = 0; c < nk; ++c) {
    round_x();
    store_w(st);
    __syncthreads();
    if (c + 1 < nk) {  // in flight during this step's mma
      copy_x(c + 1);
      fetch_w(c + 1, st);
    }

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4], bf[4][2];
      // A (16x16, rows wm+16mi..): matrices (rows 0-7 | 8-15) x (k | k+8)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], &As[wm + mi * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
      // B (two n8 tiles): matrices (n 0-7, k) (n 0-7, k+8) (n 8-15, k) (n 8-15, k+8)
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, &Bs[wn + np * 16 + (lane & 7) + ((lane >> 4) << 3)]
                          [kk + ((lane >> 3) & 1) * 8]);
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + tig * 2;
#pragma unroll
      for (int hrow = 0; hrow < 2; ++hrow) {
        const int row = m0 + wm + mi * 16 + gid + hrow * 8;
        if (row >= M) continue;
        if (col < N) y[(size_t)row * N + col] = acc[mi][ni][2 * hrow];
        if (col + 1 < N) y[(size_t)row * N + col + 1] = acc[mi][ni][2 * hrow + 1];
      }
    }
  }
}

}  // namespace

// xdtype: 0 = f32, 1 = bf16
extern "C" int zt_q4k_gemm(const void* x, int xdtype, const uint8_t* qs, const uint8_t* sc,
                           const uint8_t* mn, const void* d, const void* dmin, float* y,
                           int M, int K, int N, void* stream) {
  if (K % 256 != 0 || M <= 0 || N <= 0 || (xdtype != 0 && xdtype != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto dh = static_cast<const __half*>(d);
  const auto dmh = static_cast<const __half*>(dmin);
  if (xdtype == 0)
    q4k_gemm_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), qs, sc, mn,
                                                       dh, dmh, y, M, K, N);
  else
    q4k_gemm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), qs, sc, mn, dh, dmh, y, M, K, N);
  return (int)cudaGetLastError();
}
