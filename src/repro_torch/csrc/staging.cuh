// cp.async staging of tiles into shared memory, shared by the kernels that
// stream their operands through a ring of stages (B1 gemm_aie.cu, B6
// gemm_tb.cu, B7 gemm_grouped.cu).
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

// A plain row-major shared-memory tile of ``ld`` elements a row.
struct RowMajor {
  int ld;
  __device__ __forceinline__ int at(int r, int c) const { return r * ld + c; }
};

// Stage the rows x cols block at src (row stride ld elements) into dst, at
// the element offsets layout.at(r, c) (RowMajor, or mma_chain.cuh's
// swizzled SmemTile), zero-filling rows >= rows_valid and columns >=
// cols_valid.  mode 2: 16-byte cp.async; 1: 4-byte cp.async; 0: plain
// loads and stores (an operand whose base, stride or tile width is not
// 4-byte aligned).  The wrapper picks the mode from the alignments.  A
// layout keeps each 16-byte unit of a row whole.  kThreads threads take
// part, tid = 0 .. kThreads - 1 being this one's index among them.
template <int kThreads, typename T, typename Layout>
__device__ __forceinline__ void stage_to(T* dst, const Layout& layout,
                                         const T* src, size_t ld, int rows,
                                         int cols, int rows_valid,
                                         int cols_valid, int mode, int tid) {
  if (mode == 0) {
    for (int i = tid; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i - (i / cols) * cols;
      dst[layout.at(r, c)] = (r < rows_valid && c < cols_valid)
                                 ? src[r * ld + c]
                                 : from_f32<T>(0.0f);
    }
    return;
  }
  const int e = (mode == 2 ? 16 : 4) / static_cast<int>(sizeof(T));
  const int units = (cols + e - 1) / e;
  for (int i = tid; i < rows * units; i += kThreads) {
    const int r = i / units, c = (i - r * units) * e;
    const int valid = r < rows_valid ? min(e, max(0, cols_valid - c)) : 0;
    const T* s = valid ? src + r * ld + c : src;
    const int nbytes = valid * static_cast<int>(sizeof(T));
    if (mode == 2)
      cp_async16(dst + layout.at(r, c), s, nbytes);
    else
      cp_async4(dst + layout.at(r, c), s, nbytes);
  }
}

// stage_to for the cp.async modes (1 and 2) without a division a copy:
// each thread keeps one column unit and walks the rows ``kThreads / units``
// apart.  Mode 0, or a row wider than kThreads units, goes to stage_to.
template <int kThreads, typename T, typename Layout>
__device__ __forceinline__ void stage_rows(T* dst, const Layout& layout,
                                           const T* src, size_t ld, int rows,
                                           int cols, int rows_valid,
                                           int cols_valid, int mode,
                                           int tid) {
  if (rows <= 0 || cols <= 0) return;
  const int e = (mode == 2 ? 16 : 4) / static_cast<int>(sizeof(T));
  const int units = (cols + e - 1) / e;
  if (mode == 0 || units > kThreads) {
    stage_to<kThreads>(dst, layout, src, ld, rows, cols, rows_valid,
                       cols_valid, mode, tid);
    return;
  }
  const int step = kThreads / units;  // rows staged at once
  const int r0 = tid / units;
  if (r0 >= step) return;
  const int c = (tid - r0 * units) * e;
  const int nbytes =
      min(e, max(0, cols_valid - c)) * static_cast<int>(sizeof(T));
  for (int r = r0; r < rows; r += step) {
    const int n = r < rows_valid ? nbytes : 0;
    const T* s = n ? src + r * ld + c : src;
    if (mode == 2)
      cp_async16(dst + layout.at(r, c), s, n);
    else
      cp_async4(dst + layout.at(r, c), s, n);
  }
}

// stage_rows' 16-byte mode with the block's width, kCols, known at compile
// time (kCols / (16 / sizeof(T)) <= kThreads): the row and unit of a thread
// come from shifts.
template <int kThreads, int kCols, typename T, typename Layout>
__device__ __forceinline__ void stage_rows16(T* dst, const Layout& layout,
                                             const T* src, size_t ld,
                                             int rows, int rows_valid,
                                             int cols_valid, int tid) {
  constexpr int e = 16 / static_cast<int>(sizeof(T)), units = kCols / e;
  static_assert(units >= 1 && units <= kThreads, "a row per step at least");
  constexpr int step = kThreads / units;
  const int r0 = tid / units;
  if (r0 >= step) return;
  const int c = (tid % units) * e;
  const int nbytes =
      min(e, max(0, cols_valid - c)) * static_cast<int>(sizeof(T));
  for (int r = r0; r < rows; r += step) {
    const int n = r < rows_valid ? nbytes : 0;
    cp_async16(dst + layout.at(r, c), n ? src + r * ld + c : src, n);
  }
}

// stage_to into a plain tile of dst_ld elements a row.
template <int kThreads, typename T>
__device__ __forceinline__ void stage(T* dst, int dst_ld, const T* src,
                                      size_t ld, int rows, int cols,
                                      int rows_valid, int cols_valid,
                                      int mode) {
  stage_to<kThreads>(dst, RowMajor{dst_ld}, src, ld, rows, cols, rows_valid,
                     cols_valid, mode, threadIdx.x);
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
