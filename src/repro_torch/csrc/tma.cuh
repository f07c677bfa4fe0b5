// The tensor memory accelerator (TMA) and the shared-memory mbarriers that
// report its copies, shared by the kernels whose rings it fills: B7
// (gemm_grouped.cu) and the warp-specialised bf16 body of B1 and B6
// (gemm_ws.cuh).  cuTensorMapEncodeTiled is found through the runtime's
// driver entry point, so nothing links to the driver library.
//
// The box layouts: a box of rows of 128, 64 or 32 bytes lands in the
// matching TMA swizzle, which places 16-byte chunk q of row r at chunk
// q ^ ((r >> s) & (w - 1)) for a row of w chunks (s = 0, 1, 2): exactly
// mma_chain.cuh's smem_tile(p, 8 w) of a 1024-byte-aligned base, so the
// ldmatrix chain and wgmma (wgmma.cuh) read the same stage.
#pragma once

#include <cuda.h>  // CUtensorMap (no link to the driver library)

#include <mutex>

#include "mma_chain.cuh"

namespace repro {

// Element (r, c) of a slab held as 64-column panels of kRows rows, each
// swizzled like smem_tile(p, 64): the layout the tensor memory accelerator
// writes with its 128-byte swizzle, for the cp.async path to match.
template <int kRows>
struct Panels {
  __device__ __forceinline__ int at(int r, int c) const {
    return (c >> 6) * (kRows * 64) + r * 64 +
           (((((c >> 3) & 7) ^ (r & 7)) << 3) | (c & 7));
  }
};

// mbarriers in shared memory: a barrier completes its phase when its
// arrivals (count, one by default, with the bytes they expect) and those
// bytes have landed.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One tensor-memory-accelerator copy of the box at coordinates (x, y[, z])
// of a tensor map into shared memory, reported to bar.  Elements outside
// the tensor land as zeros.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       int x, int y, int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z),
      "r"(smem_addr(bar))
      : "memory");
}

// cuTensorMapEncodeTiled, found through the runtime (no link to the driver
// library); null if the driver lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static bool looked = false;
  if (!looked) {
    looked = true;
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A tensor map of `rank` dims (innermost first, byte strides of the outer
// ones) over bf16 or (int8) bytes, read in boxes of 128-byte rows (64 bf16
// or 128 int8 elements) x box_rows (x 1) with the 128-byte swizzle; false
// if it cannot be made.
inline bool tensor_map(CUtensorMap* map, const void* base, bool bytes, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides,
                cuuint32_t box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t box[3] = {bytes ? 128u : 64u, box_rows, 1},
                   unit[3] = {1, 1, 1};
  return encode(map,
                bytes ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                rank,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The arrival of a thread's earlier cp.async copies on bar, without adding
// to its expected count (init the barrier with one arrival per thread).
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Orders this thread's generic-proxy accesses of shared memory before the
// async proxy's (TMA writes, wgmma reads) that follow.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The TMA swizzle of a box row of row_bytes (128, 64, 32; 16: none).
inline CUtensorMapSwizzle swizzle_of(int row_bytes) {
  return row_bytes >= 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
         : row_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                           : CU_TENSOR_MAP_SWIZZLE_NONE;
}

// A 2-d tensor map of rows x cols elements (row stride ld elements) of
// esize bytes (2: bf16, 4: f32), read in boxes of box_cols x box_rows with
// the swizzle of a box row's bytes (none for f32); elements outside the
// tensor land as zeros.  false if it cannot be made (the driver lacks the
// entry point, or base and row stride are not 16-byte multiples).
inline bool tensor_map_2d(CUtensorMap* map, const void* base, int esize,
                          size_t rows, size_t cols, size_t ld,
                          int box_cols, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0 ||
      (ld * esize) % 16 != 0)
    return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)},
                   unit[2] = {1, 1};
  return encode(map,
                esize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                esize == 4 ? CU_TENSOR_MAP_SWIZZLE_NONE
                           : swizzle_of(box_cols * esize),
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// tensor_map_2d through a small cache keyed by (base, shape, stride, box):
// the weights and the allocator's recycled activations come back with the
// same keys call after call, so most launches copy a finished map.
inline bool tensor_map_2d_cached(CUtensorMap* map, const void* base,
                                 int esize, size_t rows, size_t cols,
                                 size_t ld, int box_cols, int box_rows) {
  struct Key {
    const void* base;
    size_t rows, cols, ld;
    int esize, box_cols, box_rows;
    bool operator==(const Key& o) const {
      return base == o.base && rows == o.rows && cols == o.cols &&
             ld == o.ld && esize == o.esize && box_cols == o.box_cols &&
             box_rows == o.box_rows;
    }
  };
  struct Entry {
    Key key;
    CUtensorMap map;
    bool valid;
  };
  constexpr int kSlots = 256;
  static Entry cache[kSlots];
  static std::mutex mu;
  const Key key{base, rows, cols, ld, esize, box_cols, box_rows};
  size_t h = reinterpret_cast<uintptr_t>(base) >> 4;
  h ^= rows * 0x9E3779B97F4A7C15ull ^ cols * 0xC2B2AE3D27D4EB4Full ^
       (static_cast<size_t>(box_cols) << 20) ^ box_rows ^ ld << 7 ^ esize;
  Entry& e = cache[(h ^ (h >> 29)) % kSlots];
  std::lock_guard<std::mutex> lock(mu);
  if (e.valid && e.key == key) {
    *map = e.map;
    return true;
  }
  if (!tensor_map_2d(map, base, esize, rows, cols, ld, box_cols, box_rows))
    return false;
  e.key = key, e.map = *map, e.valid = true;
  return true;
}

}  // namespace repro
