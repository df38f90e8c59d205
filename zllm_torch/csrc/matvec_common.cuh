// The activation prologue shared by the decode matvecs K1 (q4k_matvec.cu)
// and K4 (int8_matvec.cu): the counterpart of zllm/ops/qmatmul.py::
// _prologue_quant.  prologue(x) is "q" (x as is), "norm" (rms_norm(x) * w,
// the full-row mean square reduced first) or "glu" (silu(g) * u over the
// fused gate|up row); the f32 row is then quantized to int8 per GROUP-wide
// group: dx = max(max|v| / 127, 1e-12), q = clip(rint(v / dx), -127, 127),
// with IEEE division, as the Pallas kernel rounds (the library is built
// without fast math).  Every block quantizes the whole row into its shared
// memory; GROUP/4 lanes take a group, four elements a lane.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// All THREADS threads of the block call this together.  K / GROUP must be a
// multiple of 32 * 4 / GROUP groups (K % 256 == 0 covers GROUP 16 and 32),
// so that every lane of a warp takes part in each round's shuffles.  Ends
// with a barrier: the row is ready in shared memory.
template <typename TX, int MODE, int GROUP, int THREADS>
__device__ __forceinline__ void quantize_row(const TX* __restrict__ x,
                                             const float* __restrict__ aux, int K, float eps,
                                             QuantRow<GROUP> row) {
  constexpr int kLanes = GROUP / 4;  // lanes per group
  constexpr int kWarps = THREADS / 32;
  __shared__ float red[kWarps];
  __shared__ float rscale;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float r = 1.f;
  if (MODE == kNorm) {
    float s = 0.f;
    for (int k = tid; k < K; k += THREADS) {
      const float v = to_f(x[k]);
      s += v * v;
    }
    s = warp_sum(s);
    if (lane == 0) red[warp] = s;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t += red[w];
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
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + i;
      if (MODE == kNorm) {
        v[i] = to_f(x[k]) * aux[k] * r;
      } else if (MODE == kGlu) {
        const float gg = to_f(x[k]);
        const float u = to_f(x[K + k]);
        v[i] = gg * (1.f / (1.f + expf(-gg))) * u;
      } else {
        v[i] = to_f(x[k]);
      }
    }
    float am = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3])));
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1) am = fmaxf(am, __shfl_xor_sync(kFull, am, o));
    const float dx = fmaxf(am / 127.f, 1e-12f);
    int q[4], sx = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      q[i] = (int)fminf(fmaxf(rintf(v[i] / dx), -127.f), 127.f);
      sx += q[i];
    }
    *reinterpret_cast<char4*>(row.xq + k0) = make_char4(q[0], q[1], q[2], q[3]);
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1) sx += __shfl_xor_sync(kFull, sx, o);
    if (sub == 0) {
      row.dx[g] = dx;
      row.sx[g] = sx;
    }
  }
  __syncthreads();
}

}  // namespace zt
