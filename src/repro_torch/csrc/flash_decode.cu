// flash_decode — single-token attention over a dense KV cache, for Hopper.
//
// Replaces: repro/kernels/flash_decode.py flash_decode (pallas_call at :144,
// body _flash_decode_kernel at :37).  q (b, hq, d) one token per slot,
// caches (b, S, hkv, d), pos (b,) int32 per-slot positions; row i sees
// cache slots k_pos <= pos[i] (and k_pos > pos[i] - window when window > 0).
//
// What bounds it on an H100: the cache bytes of the pos + 1 keys each slot
// has written (K and V, hkv * d elements a key), read once, and at serving
// lengths the latency of a launch and of one round of loads: a smollm-360m
// or qwen3-moe step's 1,526 keys over 8 slots are 2-3 MB, under a
// microsecond at 3.35 TB/s.  pos is read on the device, so a decode step
// needs no host sync and replays from a CUDA graph.
//
// Design, bf16 (decode_split.cuh): the keys split across CTAs on a grid of
// 64-key blocks fixed from key 0, each block's partial computed by one warp
// on the tensor cores (B3's block step), the partials merged in ascending
// block order by a second kernel.  A slot of 364 keys thus waits for 6
// warps that run side by side instead of 12 blocks one after another, and
// its rows' bits do not depend on the batch, the cache length beyond pos + 1
// or the grid: a CTA takes 1, 2 or 4 consecutive blocks, a warp each,
// chosen at launch (``bkv`` = 64, 128 or 256 keys a CTA), with the same
// bits.  flash_decode_paged.cu runs the same body over a page pool
// and gives the same bits.
//
// f32 (the smoke models, the f32 edge cases): one CTA per (kv head, slot)
// walks csrc/flash.cuh's fmaf block step over 32-key blocks in ascending
// order from block floor(max(0, pos - window + 1) / 32) to block
// floor(min(pos, S - 1) / 32); flash_decode_paged.cu repeats it too.
#include "decode_split.cuh"
#include "flash.cuh"

namespace repro {
namespace {

template <int kDmax>
__global__ void __launch_bounds__(kFaThreads, 1)
flash_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ pos,
                    float* __restrict__ o, int S, int hq, int hkv, int d,
                    int window, float scale) {
  FlashSmem<kDmax>& sm = flash_smem<kDmax>();
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int groups = hq / hkv;
  const size_t q_at = ((size_t)b * hq + (size_t)kvh * groups) * d;
  const size_t kv_row_stride = (size_t)hkv * d;
  const size_t kv_at = (size_t)b * S * hkv * d + (size_t)kvh * d;
  const int p = pos[b];

  flash_load_q(sm, q + q_at, d, groups, d, scale);
  FlashState<kDmax> st;
  flash_init(st);
  const int kv_end = min(S, p + 1);
  const int kv_begin = window > 0 ? max(0, p - window + 1) / kFaBkv * kFaBkv : 0;
  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kFaBkv)
    flash_block(sm, st, k + kv_at, v + kv_at, DenseRows{kv_row_stride}, kv0, S,
                d, groups, p, 0, true, window);
  flash_store(st, o + q_at, d, groups, d);
}

template <int kDmax>
int launch_f32(const float* q, const float* k, const float* v, const int* pos,
               float* o, int b, int S, int hq, int hkv, int d, int window,
               float scale, cudaStream_t s) {
  auto kernel = flash_decode_kernel<kDmax>;
  const size_t smem = flash_smem_optin<kDmax>(kernel);
  kernel<<<dim3(hkv, b), kFaThreads, smem, s>>>(q, k, v, pos, o, S, hq, hkv,
                                                d, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// q (b, hq, d), caches (b, S, hkv, d) contiguous; pos (b,) int32 on the
// device.  bf16: part_acc / part_ml are the split grid's scratch (sizes in
// kernels/flash_attention.py decode_grid), modes the staging copy modes of
// k and v (2 bits each) and per_cta the 64-key splits a CTA (1, 2 or 4; 1
// or 2 at head_dim > 128); f32 ignores all four.  Returns
// cudaGetLastError() after the launches.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* pos, void* o,
                                   void* part_acc, void* part_ml, int b,
                                   int S, int hq, int hkv, int d, int window,
                                   float scale, int dtype, int modes,
                                   int per_cta, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  if (dtype == kBF16) {
    SplitArgs a{};
    a.hq = hq, a.hkv = hkv, a.d = d, a.group = hq / hkv;
    a.length = S, a.window = window;
    a.mode_k = modes & 3, a.mode_v = (modes >> 2) & 3;
    const DenseKeys keys{S, static_cast<size_t>(hkv) * d};
    return launch_split<4>(q, k, v, p, o, part_acc, part_ml, b, a, keys, scale,
                        per_cta, s);
  }
  if (d < 1 || d > kFaDmax || hq / hkv > kFaRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  if (d <= 128)
    return launch_f32<128>(qf, kf, vf, p, of, b, S, hq, hkv, d, window, scale,
                           s);
  return launch_f32<256>(qf, kf, vf, p, of, b, S, hq, hkv, d, window, scale,
                         s);
}
