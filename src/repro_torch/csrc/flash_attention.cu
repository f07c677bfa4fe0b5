// flash_attention — forward online-softmax attention (prefill), for Hopper.
//
// Replaces: repro/kernels/flash_attention.py flash_attention (pallas_call at
// :125, body _flash_kernel at :29).  q (b, sq, hq, d), k/v (b, skv, hkv, d),
// out (b, sq, hq, d) in q's dtype; GQA maps kv head = q head // group by
// index (no repeated kv), masks causal / window / kv padding with
// q_offset = skv - sq by default, NEG_INF = -1e30, p re-zeroed after the
// exp, output acc / (l > 0 ? l : 1).
//
// What bounds it on an H100: at serving prompt lengths (tens to hundreds of
// tokens, head_dim 64) the operations are few and the q/k/v/o bytes are
// small; a 16-row CTA re-reads its kv head's keys from L2 for every q block,
// so the kernel is bound by on-chip traffic and launch latency rather than
// by device memory.  The design keeps the whole softmax on chip: no score
// matrix is written, each kv block is staged once per CTA in shared memory.
//
// Design: one CTA per (16 query rows, q head, batch row); it walks the kv
// blocks of 32 keys in ascending order (csrc/flash.cuh has the block step
// and its accumulation order) and stops at the last block its causal rows
// can see, starting at the first its window can see.  head_dim is a runtime
// value up to 128 (smollm 64, its smoke config 20, h2o-danube 120); lanes
// past head_dim are masked, not padded in memory.  Every prefill, short
// prompts included, runs here.
#include "flash.cuh"

namespace repro {
namespace {

template <typename T>
__global__ void __launch_bounds__(kFaThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int sq,
                       int skv, int hq, int hkv, int d, int causal,
                       int window, int q_offset, float scale) {
  __shared__ FlashSmem sm;
  const int q0 = blockIdx.x * kFaRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int n_rows = min(kFaRows, sq - q0);
  const size_t q_row_stride = (size_t)hq * d;
  const size_t q_at = ((size_t)b * sq + q0) * hq * d + (size_t)h * d;
  const size_t kv_row_stride = (size_t)hkv * d;
  const size_t kv_at = (size_t)b * skv * hkv * d + (size_t)kvh * d;

  flash_load_q(sm, q + q_at, q_row_stride, n_rows, d, scale);
  FlashState st;
  flash_init(st);
  const int qpos_first = q_offset + q0;
  const int qpos_last = qpos_first + n_rows - 1;
  const int kv_end = causal ? min(skv, qpos_last + 1) : skv;
  const int kv_begin =
      window > 0 ? max(0, qpos_first - window + 1) / kFaBkv * kFaBkv : 0;
  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kFaBkv)
    flash_block(sm, st, k + kv_at, v + kv_at, DenseRows{kv_row_stride}, kv0,
                skv, d, n_rows, qpos_first, 1, causal != 0, window);
  flash_store(st, o + q_at, q_row_stride, n_rows, d);
}

template <typename T>
void launch(const void* q, const void* k, const void* v, void* o, int b,
            int sq, int skv, int hq, int hkv, int d, int causal, int window,
            int q_offset, float scale, cudaStream_t stream) {
  dim3 grid(cdiv(sq, kFaRows), hq, b);
  flash_attention_kernel<T><<<grid, kFaThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, hq, hkv, d,
      causal, window, q_offset, scale);
}

}  // namespace
}  // namespace repro

// All operands contiguous in the (b, s, h, d) layout.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int sq,
                                      int skv, int hq, int hkv, int d,
                                      int causal, int window, int q_offset,
                                      float scale, int dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    launch<__nv_bfloat16>(q, k, v, o, b, sq, skv, hq, hkv, d, causal, window,
                          q_offset, scale, s);
  else
    launch<float>(q, k, v, o, b, sq, skv, hq, hkv, d, causal, window,
                  q_offset, scale, s);
  return static_cast<int>(cudaGetLastError());
}
