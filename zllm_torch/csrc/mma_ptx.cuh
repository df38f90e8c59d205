// PTX wrappers shared by the tensor-core loops (gemm_slice.cuh for K3 and
// K5, attn_mma.cuh for K7 and K10, flash_attn.cu for K6,
// decode_cluster.cuh for K7, K8 and K9, attn_decode.cu for K2): warp-level
// mma.sync m16n8k16 (bf16 x bf16 or f16 x f16 -> f32, the same rate on an
// H100), ldmatrix (and transposed), cp.async 16-byte copies with their
// commit and wait, the round-to-nearest-even bf16 and f16 pair packing, and
// `Tc<T>`, the mma and packing of one operand type T for the loops that take
// either (bf16 caches, or the f16 caches of the f16 KV forms).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace zt {

// four 8x8 b16 matrices from shared memory; lane l gives the row address
// of matrix l/8
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem_row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// the same, transposed: lane l gives the row address of matrix l/8 of the
// stored (transposed) matrix
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem_row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

__device__ __forceinline__ void mma_f16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// round-to-nearest-even, subnormals kept (f16's 5-bit exponent: values
// under 2^-14 lose bits, under 2^-25 become 0, over 65504 become inf)
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// one tensor-core operand type: its mma.sync m16n8k16 with f32
// accumulators, its pair packing and unpacking
template <typename T> struct Tc;
template <> struct Tc<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
    mma_bf16(c, a, b);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) { return pack_bf16(lo, hi); }
  static __device__ __forceinline__ float2 unpack(uint32_t w) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  }
};
template <> struct Tc<__half> {
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
    mma_f16(c, a, b);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) { return pack_f16(lo, hi); }
  static __device__ __forceinline__ float2 unpack(uint32_t w) {
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  }
};

// 2^e as an f32, for -126 < e < 128
__device__ __forceinline__ float pow2(int e) { return __int_as_float((127 + e) << 23); }

// The power of two a row of f32 values takes before its split into f16
// tensor-core parts (the f16 forms of K6, K9 and K10, whose q is f32 or
// bf16 and whose K is f16): 2^e with the row's largest |x| times 2^e in
// [2^14, 2^15).  Then no part overflows f16 (65504), and every element
// within 2^28 of the row's largest is a normal f16 hi part, so three f16
// parts hold an f32 element to 2^-33 of itself and one part holds a bf16
// element exactly; smaller elements keep an absolute error under 2^-39 of
// the row's largest, far below the f32 rounding of the scores.  A power of
// two scales exactly, and is undone exactly on the f32 scores.  A zero or
// non-finite row takes e = 0, and e stays within [-125, 125].
__device__ __forceinline__ int f16_row_exp(float amax) {
  if (!(amax > 0.f) || !(amax < INFINITY)) return 0;
  int e;
  frexpf(amax, &e);  // amax = m 2^e, m in [0.5, 1)
  return min(max(15 - e, -125), 125);
}

}  // namespace zt
