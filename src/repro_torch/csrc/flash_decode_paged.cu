// flash_decode_paged — single-token attention over a shared KV page pool,
// for Hopper.
//
// Replaces: repro/kernels/flash_decode.py flash_decode_paged (pallas_call at
// :275, body _flash_decode_paged_kernel at :156).  q (b, hq, d) one token per
// slot; k_pages / v_pages (n_pages, ps, hkv, d) one pool shared by every
// slot; table (b, max_pages) int32, row i's logical key kp lives in physical
// page table[i, kp / ps] at offset kp % ps; pos (b,) int32.  Row i sees keys
// kp <= pos[i] and kp < max_pages * ps (and kp > pos[i] - window when
// window > 0).  Page 0 is the serve loop's sink: rows of free or
// mid-prefill slots point every entry there.
//
// What bounds it on an H100: the same bytes as the dense kernel — the
// pos + 1 keys and values per kv head each slot has written, read once —
// plus the table entries those keys name.  Pages are not contiguous, so a
// 32-key block is gathered row by row; each key row (hkv * d elements) is
// still one contiguous stretch.
//
// Design: flash_decode.cu with one difference, where a key's row is found
// (PagedRows in flash.cuh: the first warp looks up the block's 32 row
// offsets once, so the staging loop stays B4's).  The Pallas kernel uses
// the page as its kv block, so it matches the dense kernel only when
// page_size equals the block.  Here the blocks stay the dense kernel's
// logical 32-key blocks, visited in the same ascending order from block
// floor(max(0, pos - window + 1) / 32) up to min(max_pages * ps, pos + 1),
// and each key is looked up by itself: a block may span several pages (the
// serve loop's 16-key pages, the tests' 8) or lie inside one (64).  So with
// max_pages * ps equal to the dense cache's length the result is the dense
// kernel's, bit for bit, for any page size and any table permutation.  One
// CTA per (kv head, slot); pos and the table are read from device memory,
// so a decode step needs no host sync.  Reads stop at max_pages * ps, so a
// masked row whose pos has run past its table stays in bounds.  A row that
// sees no key at all (only such a row, under a window) gets zeros, as the
// Pallas kernel and the dense kernel give; the plain version gives the mean
// of the values there, and the serve loop never reads that row.
#include "flash.cuh"

namespace repro {
namespace {

template <typename T>
__global__ void __launch_bounds__(kFaThreads)
flash_decode_paged_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ table,
                          const int* __restrict__ pos, T* __restrict__ o,
                          int ps, int max_pages, int hq, int hkv, int d,
                          int window, float scale) {
  __shared__ FlashSmem sm;
  __shared__ size_t row_at[kFaBkv];
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int groups = hq / hkv;
  const size_t q_at = ((size_t)b * hq + (size_t)kvh * groups) * d;
  const size_t row_stride = (size_t)hkv * d;
  const PagedRows rows{table + (size_t)b * max_pages, ps,
                       (size_t)ps * row_stride, row_stride, row_at};
  const size_t head_at = (size_t)kvh * d;
  const int kv_len = max_pages * ps;
  const int p = pos[b];

  flash_load_q(sm, q + q_at, d, groups, d, scale);
  FlashState st;
  flash_init(st);
  const int kv_end = min(kv_len, p + 1);
  const int kv_begin = window > 0 ? max(0, p - window + 1) / kFaBkv * kFaBkv : 0;
  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kFaBkv)
    flash_block(sm, st, k + head_at, v + head_at, rows, kv0, kv_len, d, groups,
                p, 0, true, window);
  flash_store(st, o + q_at, d, groups, d);
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const int* table,
            const int* pos, void* o, int b, int ps, int max_pages, int hq,
            int hkv, int d, int window, float scale, cudaStream_t stream) {
  dim3 grid(hkv, b);
  flash_decode_paged_kernel<T><<<grid, kFaThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), table, pos, static_cast<T*>(o), ps,
      max_pages, hq, hkv, d, window, scale);
}

}  // namespace
}  // namespace repro

// q (b, hq, d), pools (n_pages, ps, hkv, d), table (b, max_pages) int32,
// pos (b,) int32, all contiguous on the device; every table entry must be
// below n_pages.  Returns cudaGetLastError() after the launch.
extern "C" int flash_decode_paged_launch(const void* q, const void* k,
                                         const void* v, const void* table,
                                         const void* pos, void* o, int b,
                                         int ps, int max_pages, int hq,
                                         int hkv, int d, int window,
                                         float scale, int dtype,
                                         void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* p = static_cast<const int*>(pos);
  if (dtype == kBF16)
    launch<__nv_bfloat16>(q, k, v, t, p, o, b, ps, max_pages, hq, hkv, d,
                          window, scale, s);
  else
    launch<float>(q, k, v, t, p, o, b, ps, max_pages, hq, hkv, d, window,
                  scale, s);
  return static_cast<int>(cudaGetLastError());
}
