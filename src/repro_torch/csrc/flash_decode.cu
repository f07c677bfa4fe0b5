// flash_decode — single-token attention over a dense KV cache, for Hopper.
//
// Replaces: repro/kernels/flash_decode.py flash_decode (pallas_call at :144,
// body _flash_decode_kernel at :37).  q (b, hq, d) one token per slot,
// caches (b, S, hkv, d), pos (b,) int32 per-slot positions; row i sees
// cache slots k_pos <= pos[i] (and k_pos > pos[i] - window when window > 0).
//
// What bounds it on an H100: the bytes of the cache rows each slot has
// written (pos + 1 keys and values per kv head), read once; the operations
// are 4 * group * d per key.  The kernel stops at pos[row] instead of
// streaming all S slots, so it moves what the data needs, not max_len.
//
// Design: one CTA per (kv head, batch row).  Its q rows are the `group` q
// heads that share the kv head (3 for smollm), with no padding to the TPU's
// 8 sublanes.  pos is read from device memory, so a decode step needs no
// host sync.  The kv-block accumulation order is the one written down in
// csrc/flash.cuh: 32-key blocks in ascending order from block
// floor(max(0, pos - window + 1) / 32) to block floor(min(pos, S - 1) / 32).
// flash_decode_paged.cu repeats it over a page pool and gives the same bits.
#include "flash.cuh"

namespace repro {
namespace {

template <typename T>
__global__ void __launch_bounds__(kFaThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos,
                    T* __restrict__ o, int S, int hq, int hkv, int d,
                    int window, float scale) {
  __shared__ FlashSmem sm;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int groups = hq / hkv;
  const size_t q_at = ((size_t)b * hq + (size_t)kvh * groups) * d;
  const size_t kv_row_stride = (size_t)hkv * d;
  const size_t kv_at = (size_t)b * S * hkv * d + (size_t)kvh * d;
  const int p = pos[b];

  flash_load_q(sm, q + q_at, d, groups, d, scale);
  FlashState st;
  flash_init(st);
  const int kv_end = min(S, p + 1);
  const int kv_begin = window > 0 ? max(0, p - window + 1) / kFaBkv * kFaBkv : 0;
  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kFaBkv)
    flash_block(sm, st, k + kv_at, v + kv_at, DenseRows{kv_row_stride}, kv0, S,
                d, groups, p, 0, true, window);
  flash_store(st, o + q_at, d, groups, d);
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const int* pos,
            void* o, int b, int S, int hq, int hkv, int d, int window,
            float scale, cudaStream_t stream) {
  dim3 grid(hkv, b);
  flash_decode_kernel<T><<<grid, kFaThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, static_cast<T*>(o), S, hq, hkv, d,
      window, scale);
}

}  // namespace
}  // namespace repro

// q (b, hq, d), caches (b, S, hkv, d) contiguous; pos (b,) int32 on the
// device.  Returns cudaGetLastError() after the launch.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* pos, void* o,
                                   int b, int S, int hq, int hkv, int d,
                                   int window, float scale, int dtype,
                                   void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  if (dtype == kBF16)
    launch<__nv_bfloat16>(q, k, v, p, o, b, S, hq, hkv, d, window, scale, s);
  else
    launch<float>(q, k, v, p, o, b, S, hq, hkv, d, window, scale, s);
  return static_cast<int>(cudaGetLastError());
}
