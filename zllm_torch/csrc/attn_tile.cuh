// The multi-token attention tile loop on the CUDA cores, used by K6's f32
// K/V (flash_attn.cu, a contiguous cache) and by K10's f32 pools
// (paged_attn.cu, a page pool read through a page table), where bf16
// tensor-core operands would round K/V.  K10's bf16 pools and K7's
// multi-row form take the one-pass tensor-core loop of attn_mma.cuh
// instead, K6's bf16 K/V its own two-pass one (flash_attn.cu); the helpers
// to_f / from_f are shared from here.  The users
// differ only in where a tile of K/V rows lives, which the KV
// addressor type answers: `k_rows(b, h, s0)` / `v_rows(b, h, s0)` point at
// the row of slot s0, and the KT rows from s0 on are contiguous.
//
// Queries q[B, T, Hq, D] at consecutive positions pos0[b] + t attend slots
// 0 .. S-1 that are <= pos (and > pos - window), with optional logit
// softcap and per-head attention sinks in the softmax denominator.  Scores
// are f32; the probabilities are normalized, then cast to V's
// dtype before P.V (f32 accumulate), as zllm's `_attn_kernel` (K6) does;
// for f32 pools the cast is the identity, so K10's f32 form equals zllm's
// page-by-page rounding too.
//
// Design (simple first, CUDA cores, no tensor cores yet): a block takes 32
// query rows of one kv head (rows t-major, group-minor, so the grouped
// query heads share every K/V tile) and streams K/V in tiles of 64 slots
// through shared memory.  Each thread computes a 4x4 block of scores and a
// 4-row block of P.V outputs in registers, so one shared load feeds four
// FMAs.  Sweep 1 keeps an online (max, sum) per row (four lanes a row); the
// sinks join after it.  Sweep 2 recomputes the scores, forms the normalized
// probabilities rounded to V's dtype, and accumulates P.V.  Tiles wholly
// outside the causal/window band are skipped.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace zt_attn {

constexpr int QR = 32, KT = 64, kThreads = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)QR * D + (size_t)KT * (D + 1) + (size_t)KT * D +
                          (size_t)QR * (KT + 1) + 2 * QR);
}

template <typename TQ, typename TKV, int D, typename KV>
__global__ void __launch_bounds__(kThreads) attn_tile_kernel(
    const TQ* __restrict__ q, const KV kv, const int* __restrict__ pos0,
    const float* __restrict__ sinks, TQ* __restrict__ out, int T, int Hq, int Hkv, int S,
    float scale, float softcap, int window) {
  extern __shared__ __align__(16) float smem[];
  float* qsh = smem;                      // [QR][D]
  float* ksh = qsh + QR * D;              // [KT][D+1]
  float* vsh = ksh + KT * (D + 1);        // [KT][D]
  float* ssh = vsh + KT * D;              // [QR][KT+1]
  float* mrow = ssh + QR * (KT + 1);      // [QR]
  float* lrow = mrow + QR;                // [QR]
  const int tid = threadIdx.x;
  const int G = Hq / Hkv, R = T * G;
  const int r0 = blockIdx.x * QR, h = blockIdx.y, b = blockIdx.z;
  const int p0 = pos0[b];
  const int r_end = r0 + QR < R ? r0 + QR : R;

  for (int e = tid; e < QR * D; e += kThreads) {
    const int rr = e / D, dd = e % D, r = r0 + rr;
    float val = 0.f;
    if (r < R) {
      const int t = r / G, head = h * G + r % G;
      val = to_f(q[(((size_t)b * T + t) * Hq + head) * D + dd]);
    }
    qsh[e] = val;
  }
  if (tid < QR) {
    mrow[tid] = -INFINITY;
    lrow[tid] = 0.f;
  }

  const int qp_min = p0 + r0 / G, qp_max = p0 + (r_end - 1) / G;
  const int col_hi = qp_max < S - 1 ? qp_max : S - 1;
  int col_lo = window > 0 ? qp_min - window + 1 : 0;
  col_lo = col_lo < 0 ? 0 : col_lo;
  const int tlo = col_lo / KT, thi = col_hi / KT;
  __syncthreads();

  // scores of the tile (into ssh), -inf where masked: each thread a 4x4
  // block, rows 4*tr.. and slots tc + 16*j, so a shared load feeds 4 FMAs
  const int tr = tid >> 4, tc = tid & 15;
  auto tile_scores = [&](int s0) {
    float a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      float qv[4], kv4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qsh[(4 * tr + i) * D + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv4[j] = ksh[(tc + 16 * j) * (D + 1) + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) a[i][j] += qv[i] * kv4[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = 4 * tr + i, r = r0 + rr, qp = p0 + r / G;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jj = tc + 16 * j, col = s0 + jj;
        const bool ok = r < R && col < S && col <= qp && (window <= 0 || col > qp - window);
        float sc = a[i][j] * scale;
        if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
        ssh[rr * (KT + 1) + jj] = ok ? sc : -INFINITY;
      }
    }
  };
  // the KT rows of slots s0.. from `src` (the row of slot s0)
  auto load_tile = [&](const TKV* src, float* dst, int s0, int stride) {
    for (int e = tid; e < KT * D; e += kThreads) {
      const int j = e / D, dd = e % D, s = s0 + j;
      dst[j * stride + dd] = s < S ? to_f(src[(size_t)j * D + dd]) : 0.f;
    }
  };

  // sweep 1: online row max and denominator
  for (int tile = tlo; tile <= thi; ++tile) {
    const int s0 = tile * KT;
    load_tile(kv.k_rows(b, h, s0), ksh, s0, D + 1);
    __syncthreads();
    tile_scores(s0);
    __syncthreads();
    {  // four adjacent lanes per row, 16 slots each
      const int rr = tid >> 2, sub = tid & 3;
      const float* sr = ssh + rr * (KT + 1) + sub * 16;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) tmax = fmaxf(tmax, sr[j]);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_old = mrow[rr];
      const float m_new = fmaxf(m_old, tmax);
      float l = 0.f;
      if (tmax > -INFINITY) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (sr[j] > -INFINITY) l += expf(sr[j] - m_new);
      }
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      __syncthreads();  // every lane has read mrow before it changes
      if (sub == 0 && tmax > -INFINITY) {
        lrow[rr] = lrow[rr] * expf(m_old - m_new) + l;
        mrow[rr] = m_new;
      }
    }
    __syncthreads();
  }
  if (sinks != nullptr && tid < QR && r0 + tid < R) {
    const float sk = sinks[h * G + (r0 + tid) % G];
    const float m_old = mrow[tid];
    const float m_new = fmaxf(m_old, sk);
    lrow[tid] = lrow[tid] * expf(m_old - m_new) + expf(sk - m_new);
    mrow[tid] = m_new;
  }
  __syncthreads();

  // sweep 2: normalized probabilities, rounded to V's dtype, times V; each
  // thread a block of 4 rows x D/16 dims (dims td + 16*j)
  constexpr int kDims = D / 16;
  float acc[4][kDims];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDims; ++j) acc[i][j] = 0.f;
  for (int tile = tlo; tile <= thi; ++tile) {
    const int s0 = tile * KT;
    load_tile(kv.k_rows(b, h, s0), ksh, s0, D + 1);
    load_tile(kv.v_rows(b, h, s0), vsh, s0, D);
    __syncthreads();
    tile_scores(s0);
    __syncthreads();
    for (int e = tid; e < QR * KT; e += kThreads) {
      const int rr = e / KT, jj = e % KT;
      const float sc = ssh[rr * (KT + 1) + jj];
      const float l = lrow[rr];
      const float p = (sc > -INFINITY && l > 0.f) ? expf(sc - mrow[rr]) / l : 0.f;
      ssh[rr * (KT + 1) + jj] = to_f(from_f<TKV>(p));
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < KT; ++jj) {
      float pv[4], vv[kDims];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ssh[(4 * tr + i) * (KT + 1) + jj];
#pragma unroll
      for (int j = 0; j < kDims; ++j) vv[j] = vsh[jj * D + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDims; ++j) acc[i][j] += pv[i] * vv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * tr + i;
    if (r >= R) continue;
    const int t = r / G, head = h * G + r % G;
#pragma unroll
    for (int j = 0; j < kDims; ++j)
      out[(((size_t)b * T + t) * Hq + head) * D + tc + 16 * j] = from_f<TQ>(acc[i][j]);
  }
}

// One launch of the tile kernel: grid (row tiles of T*G, Hkv, B).
template <typename TQ, typename TKV, int D, typename KV>
int launch_tiles(const void* q, const KV& kv, const int* pos0, const float* sinks, void* out,
                 int B, int T, int Hq, int Hkv, int S, float scale, float softcap, int window,
                 cudaStream_t stream) {
  constexpr size_t shmem = smem_bytes<D>();
  static_assert(shmem <= 232448, "the tile loop's shared memory");
  auto kern = attn_tile_kernel<TQ, TKV, D, KV>;
  static bool attr_set = false;  // once per instantiation, not inside graph captures
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int G = Hq / Hkv;
  const dim3 grid((T * G + QR - 1) / QR, Hkv, B);
  kern<<<grid, kThreads, shmem, stream>>>(static_cast<const TQ*>(q), kv, pos0, sinks,
                                          static_cast<TQ*>(out), T, Hq, Hkv, S, scale,
                                          softcap, window);
  return (int)cudaGetLastError();
}

}  // namespace zt_attn
