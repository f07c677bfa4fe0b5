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
// What bounds it on an H100: the same bytes as the dense kernel (the pos + 1
// keys and values per kv head each slot has written, read once) plus the
// table entries those keys name, and at serving lengths the latency of a
// launch and of one round of loads, now two dependent ones (the table, then
// the rows it names).  Pages are not contiguous, so a block is gathered row
// by row; each key row (hkv * d elements) is still one contiguous stretch.
//
// Design: flash_decode.cu with one difference, where a key's row is found.
// bf16 runs decode_split.cuh's split grid with PagedKeys: a warp looks its
// 64-key block's table entries up once (64 / ps of them, or one page when
// the page is larger), then issues one cp.async per key row and chunk.  The
// blocks, their order and the merge are the dense kernel's, counted from
// key 0 whatever the page size, so with the same pos every row equals the
// dense kernel's bit for bit for any page size, table permutation and pool
// length (beyond pos + 1).  f32 runs flash.cuh's fmaf step over the dense
// kernel's 32-key blocks, each key looked up by itself (PagedRows).  pos and
// the table are read on the device, so a decode step needs no host sync.
// Reads stop at max_pages * ps, so a masked row whose pos has run past its
// table stays in bounds.  A row that sees no key at all (only such a row,
// under a window) gets zeros, as the Pallas kernel and the dense kernel
// give; the plain version gives the mean of the values there, and the serve
// loop never reads that row.
#include "decode_split.cuh"
#include "flash.cuh"

namespace repro {
namespace {

template <int kDmax>
__global__ void __launch_bounds__(kFaThreads, 1)
flash_decode_paged_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const int* __restrict__ table,
                          const int* __restrict__ pos, float* __restrict__ o,
                          int ps, int max_pages, int hq, int hkv, int d,
                          int window, float scale) {
  FlashSmem<kDmax>& sm = flash_smem<kDmax>();
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
  FlashState<kDmax> st;
  flash_init(st);
  const int kv_end = min(kv_len, p + 1);
  const int kv_begin = window > 0 ? max(0, p - window + 1) / kFaBkv * kFaBkv : 0;
  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kFaBkv)
    flash_block(sm, st, k + head_at, v + head_at, rows, kv0, kv_len, d, groups,
                p, 0, true, window);
  flash_store(st, o + q_at, d, groups, d);
}

template <int kDmax>
int launch_f32(const float* q, const float* k, const float* v,
               const int* table, const int* pos, float* o, int b, int ps,
               int max_pages, int hq, int hkv, int d, int window, float scale,
               cudaStream_t s) {
  auto kernel = flash_decode_paged_kernel<kDmax>;
  const size_t smem = flash_smem_optin<kDmax>(kernel);
  kernel<<<dim3(hkv, b), kFaThreads, smem, s>>>(
      q, k, v, table, pos, o, ps, max_pages, hq, hkv, d, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// q (b, hq, d), pools (n_pages, ps, hkv, d), table (b, max_pages) int32,
// pos (b,) int32, all contiguous on the device; every table entry must be
// below n_pages.  bf16: part_acc / part_ml are the split grid's scratch
// (kernels/flash_attention.py decode_grid at length max_pages * ps) and
// modes the staging copy modes of k and v; f32 ignores all three.  Returns
// cudaGetLastError() after the launches.
extern "C" int flash_decode_paged_launch(const void* q, const void* k,
                                         const void* v, const void* table,
                                         const void* pos, void* o,
                                         void* part_acc, void* part_ml,
                                         int b, int ps, int max_pages, int hq,
                                         int hkv, int d, int window,
                                         float scale, int dtype, int modes,
                                         void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* p = static_cast<const int*>(pos);
  if (dtype == kBF16) {
    SplitArgs a{};
    a.hq = hq, a.hkv = hkv, a.d = d, a.group = hq / hkv;
    a.length = max_pages * ps, a.window = window;
    a.mode_k = modes & 3, a.mode_v = (modes >> 2) & 3;
    const size_t row_stride = static_cast<size_t>(hkv) * d;
    const PagedKeys keys{t, ps, max_pages,
                         static_cast<size_t>(ps) * row_stride, row_stride};
    return launch_split<1>(q, k, v, p, o, part_acc, part_ml, b, a, keys, scale,
                        1, s);
  }
  if (d < 1 || d > kFaDmax || hq / hkv > kFaRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  if (d <= 128)
    return launch_f32<128>(qf, kf, vf, t, p, of, b, ps, max_pages, hq, hkv, d,
                           window, scale, s);
  return launch_f32<256>(qf, kf, vf, t, p, of, b, ps, max_pages, hq, hkv, d,
                         window, scale, s);
}
