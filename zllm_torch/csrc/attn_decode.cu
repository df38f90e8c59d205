// K2: the whole decode (T = 1) attention block of one layer.
//
// Replaces zllm/ops/attention.py::_attn_decode_qkv_kernel (launched by
// attn_decode_qkv): split the fused [B, Hq+2Hkv, D] projection row into
// q / new k / new v, optional per-head RMS norms of q and k, rope (here a
// per-row cos/sin table; it computes what the Pallas kernel's [D, D]
// rotation matmul computes), write the new K/V row into the cache in place
// at row min(pos, S-1), then GQA attention over slots <= pos (and
// > pos - window) with optional logit softcap.
//
// Rounding points kept from the Pallas kernel: the roped q and the new
// K/V rows are cast to the cache dtype; scores and softmax are f32; the
// normalized probabilities are cast to the cache dtype before P.V, which
// accumulates in f32.
//
// Bound on the H100: the cache bytes it must read, 2 * Hkv * (pos+1) * D *
// sizeof(cache) per row, over 3.35 TB/s; the work is a few FLOPs a byte.
// Design: one block per (query head, batch row), so a TinyLlama layer
// spreads over 32 blocks; each block reads only the first pos+1 cache rows
// of its kv head (the blocks of one group share them through L2).  Three
// sweeps over the visible slots: scores (thread per slot, its K row read
// as 16-byte loads all issued before the dot, kept in a global f32 scratch
// row) with the block max; the softmax denominator; then probabilities in
// tiles of the block width, each thread summing one output dim over its
// share of the tile with eight V loads in flight.  The head dim is a
// template parameter (64 or 128) so these loops unroll.  The new row is
// read from shared memory, never from the cache, so the one block of a
// group that writes it races with no reader.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// q (f32, shared) . one cache row, the row read as 16-byte loads first
template <int D>
__device__ __forceinline__ float dot_row(const float* q, const float* row) {
  float4 buf[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) buf[i] = reinterpret_cast<const float4*>(row)[i];
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    acc += q[4 * i] * buf[i].x;
    acc += q[4 * i + 1] * buf[i].y;
    acc += q[4 * i + 2] * buf[i].z;
    acc += q[4 * i + 3] * buf[i].w;
  }
  return acc;
}
template <int D>
__device__ __forceinline__ float dot_row(const float* q, const __nv_bfloat16* row) {
  uint4 buf[D / 8];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) buf[i] = reinterpret_cast<const uint4*>(row)[i];
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&buf[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h2[j]);
      acc += q[8 * i + 2 * j] * f.x;
      acc += q[8 * i + 2 * j + 1] * f.y;
    }
  }
  return acc;
}

// block-wide reduction; every thread gets the result
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  for (int o = 16; o; o >>= 1) {
    const float w = __shfl_xor_sync(kFull, v, o);
    v = MAX ? fmaxf(v, w) : v + w;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
  for (int i = 1; i < kWarps; ++i) t = MAX ? fmaxf(t, red[i]) : t + red[i];
  return t;
}

// rope one head row: x (f32, shared) -> out (f32, shared).  Products and
// the sum are rounded separately (no FMA contraction), as the reference's
// x1*cos - x2*sin is.
__device__ void rope_row(const float* x, float* out, const float* cosr, const float* sinr,
                         int D, int R, int neox) {
  const int hr = R / 2;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    float o = x[i];
    if (i < R) {
      const int j = neox ? (i < hr ? i : i - hr) : (i >> 1);
      const bool first = neox ? i < hr : (i & 1) == 0;
      const int partner = neox ? (first ? i + hr : i - hr) : (first ? i + 1 : i - 1);
      const float a = __fmul_rn(x[i], cosr[j]);
      const float b = __fmul_rn(x[partner], sinr[j]);
      o = first ? __fsub_rn(a, b) : __fadd_rn(a, b);
    }
    out[i] = o;
  }
}

template <typename TQ, typename TC, int D>
__global__ void __launch_bounds__(kThreads) attn_decode_qkv_kernel(
    const TQ* __restrict__ qkv3, TC* __restrict__ kc, TC* __restrict__ vc,
    const int* __restrict__ pos_in, const float* __restrict__ cosb,
    const float* __restrict__ sinb, const float* __restrict__ qw, const float* __restrict__ kw,
    TQ* __restrict__ out, float* __restrict__ scores, int Hq, int Hkv, int S, int R,
    int neox, float scale, float softcap, int window, float eps) {
  __shared__ float raw[3][D];   // q, k, v as loaded (then normed)
  __shared__ float cur[3][D];   // roped and rounded to the cache dtype
  __shared__ float part[kThreads];  // P.V partial sums
  __shared__ float psh[kThreads];   // probabilities of the current tile
  __shared__ float red[kWarps];
  const int hqi = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int G = Hq / Hkv, h = hqi / G, HH = Hq + 2 * Hkv;
  const int pos = pos_in[b];
  const int pw = pos < S - 1 ? pos : S - 1;
  const TQ* row = qkv3 + (size_t)b * HH * D;
  const float* cosr = cosb + (size_t)b * (R / 2);
  const float* sinr = sinb + (size_t)b * (R / 2);

  for (int i = tid; i < D; i += kThreads) {
    raw[0][i] = to_f(row[(size_t)hqi * D + i]);
    raw[1][i] = to_f(row[(size_t)(Hq + h) * D + i]);
    raw[2][i] = to_f(row[(size_t)(Hq + Hkv + h) * D + i]);
  }
  __syncthreads();
  if (qw != nullptr) {  // per-head RMS before rope: (x * rsqrt(ms)) * w
    for (int which = 0; which < 2; ++which) {
      float s = 0.f;
      for (int i = tid; i < D; i += kThreads) s += raw[which][i] * raw[which][i];
      const float rs = rsqrtf(block_reduce<false>(s, red) / (float)D + eps);
      const float* w = which == 0 ? qw : kw;
      for (int i = tid; i < D; i += kThreads) raw[which][i] = raw[which][i] * rs * w[i];
      __syncthreads();
    }
  }
  rope_row(raw[0], cur[0], cosr, sinr, D, R, neox);
  rope_row(raw[1], cur[1], cosr, sinr, D, R, neox);
  for (int i = tid; i < D; i += kThreads) {
    cur[0][i] = to_f(from_f<TC>(cur[0][i]));
    cur[1][i] = to_f(from_f<TC>(cur[1][i]));
    cur[2][i] = to_f(from_f<TC>(raw[2][i]));
  }
  __syncthreads();

  const size_t head_off = ((size_t)b * Hkv + h) * S * D;
  TC* kh = kc + head_off;
  TC* vh = vc + head_off;
  if (hqi % G == 0) {  // one block of the group writes the new row
    for (int i = tid; i < D; i += kThreads) {
      kh[(size_t)pw * D + i] = from_f<TC>(cur[1][i]);
      vh[(size_t)pw * D + i] = from_f<TC>(cur[2][i]);
    }
  }

  const int hi = pos < S - 1 ? pos : S - 1;
  int lo = window > 0 ? pos - window + 1 : 0;
  lo = lo < 0 ? 0 : lo;
  float* srow = scores + ((size_t)b * Hq + hqi) * S;

  // sweep 1: scores and their max
  float mx = -INFINITY;
  for (int s = lo + tid; s <= hi; s += kThreads) {
    float acc = 0.f;
    if (s == pw) {
#pragma unroll
      for (int i = 0; i < D; ++i) acc += cur[0][i] * cur[1][i];
    } else {
      acc = dot_row<D>(cur[0], kh + (size_t)s * D);
    }
    acc *= scale;
    if (softcap > 0.f) acc = tanhf(acc / softcap) * softcap;
    srow[s] = acc;
    mx = fmaxf(mx, acc);
  }
  mx = block_reduce<true>(mx, red);

  // sweep 2: softmax denominator
  float l = 0.f;
  for (int s = lo + tid; s <= hi; s += kThreads) l += expf(srow[s] - mx);
  l = block_reduce<false>(l, red);

  // sweep 3: P.V, the probabilities rounded to the cache dtype
  constexpr int nparts = kThreads / D;
  const int dd = tid % D, pp = tid / D;
  float acc = 0.f;
  for (int t0 = lo; t0 <= hi; t0 += kThreads) {
    const int s = t0 + tid;
    psh[tid] = s <= hi ? to_f(from_f<TC>(expf(srow[s] - mx) / l)) : 0.f;
    __syncthreads();
    const int n = hi - t0 + 1 < kThreads ? hi - t0 + 1 : kThreads;
#pragma unroll 8
    for (int j = pp; j < n; j += nparts) {
      const int sj = t0 + j;
      const float vv = sj == pw ? cur[2][dd] : to_f(vh[(size_t)sj * D + dd]);
      acc += psh[j] * vv;
    }
    __syncthreads();
  }
  part[tid] = acc;
  __syncthreads();
  if (tid < D) {
    float o = 0.f;
#pragma unroll
    for (int p = 0; p < nparts; ++p) o += part[p * D + tid];
    out[((size_t)b * Hq + hqi) * D + tid] = from_f<TQ>(o);
  }
}

template <typename TQ, typename TC>
int launch(const void* qkv3, void* kc, void* vc, const int* pos, const float* cosb,
           const float* sinb, const float* qw, const float* kw, void* out, float* scores,
           int B, int Hq, int Hkv, int S, int D, int R, int neox, float scale, float softcap,
           int window, float eps, cudaStream_t stream) {
  const dim3 grid(Hq, B);
#define ZT_LAUNCH(DD)                                                                      \
  attn_decode_qkv_kernel<TQ, TC, DD><<<grid, kThreads, 0, stream>>>(                       \
      static_cast<const TQ*>(qkv3), static_cast<TC*>(kc), static_cast<TC*>(vc), pos, cosb, \
      sinb, qw, kw, static_cast<TQ*>(out), scores, Hq, Hkv, S, R, neox, scale, softcap,     \
      window, eps)
  if (D == 64) {
    ZT_LAUNCH(64);
  } else if (D == 128) {
    ZT_LAUNCH(128);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef ZT_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  qw/kw may be null (no q/k norm).
extern "C" int zt_attn_decode_qkv(const void* qkv3, int q_dtype, void* kc, void* vc,
                                  int c_dtype, const int* pos, const float* cosb,
                                  const float* sinb, const float* qw, const float* kw,
                                  void* out, float* scores, int B, int Hq, int Hkv, int S,
                                  int D, int R, int neox, float scale, float softcap,
                                  int window, float eps, void* stream) {
  if ((D != 64 && D != 128) || R > D || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ZT_ARGS qkv3, kc, vc, pos, cosb, sinb, qw, kw, out, scores, B, Hq, Hkv, S, D, R, neox, \
                scale, softcap, window, eps, s
  if (q_dtype == 0 && c_dtype == 0) return launch<float, float>(ZT_ARGS);
  if (q_dtype == 0 && c_dtype == 1) return launch<float, __nv_bfloat16>(ZT_ARGS);
  if (q_dtype == 1 && c_dtype == 0) return launch<__nv_bfloat16, float>(ZT_ARGS);
  if (q_dtype == 1 && c_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(ZT_ARGS);
#undef ZT_ARGS
  return (int)cudaErrorInvalidValue;
}
