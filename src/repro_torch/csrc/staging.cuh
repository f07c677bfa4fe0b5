// cp.async staging of tiles into shared memory, shared by the kernels that
// stream their operands through two stages (B6 gemm_tb.cu, B7
// gemm_grouped.cu).
#pragma once

#include "common.cuh"

#include <cstddef>

namespace repro {

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage the rows x cols block at src (row stride ld elements) into dst (row
// stride dst_ld), zero-filling rows >= rows_valid and columns >=
// cols_valid.  mode 2: 16-byte cp.async; 1: 4-byte cp.async; 0: plain loads
// and stores (an operand whose base, stride or tile width is not 4-byte
// aligned).  The wrapper picks the mode from the alignments.  kThreads is
// the CTA's thread count; every thread takes part.
template <int kThreads, typename T>
__device__ __forceinline__ void stage(T* dst, int dst_ld, const T* src,
                                      size_t ld, int rows, int cols,
                                      int rows_valid, int cols_valid,
                                      int mode) {
  if (mode == 0) {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i - (i / cols) * cols;
      dst[r * dst_ld + c] = (r < rows_valid && c < cols_valid)
                                ? src[r * ld + c]
                                : from_f32<T>(0.0f);
    }
    return;
  }
  const int e = (mode == 2 ? 16 : 4) / static_cast<int>(sizeof(T));
  const int units = (cols + e - 1) / e;
  for (int i = threadIdx.x; i < rows * units; i += kThreads) {
    const int r = i / units, c = (i - r * units) * e;
    const int valid = r < rows_valid ? min(e, max(0, cols_valid - c)) : 0;
    const T* s = valid ? src + r * ld + c : src;
    const int nbytes = valid * static_cast<int>(sizeof(T));
    if (mode == 2)
      cp_async16(dst + r * dst_ld + c, s, nbytes);
    else
      cp_async4(dst + r * dst_ld + c, s, nbytes);
  }
}

// Four consecutive staged values, widened to f32 (8- or 16-byte aligned).
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}

}  // namespace repro
