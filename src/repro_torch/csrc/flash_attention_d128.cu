// B3's bf16 body at head 128 (d 65-128): every compiled CTA shape, in a
// file of its own so that it compiles beside the others.
#include "flash_attention_mma.cuh"

namespace repro {

int launch_bf16_d128(const void* q, const void* k, const void* v, void* o,
                     const FaArgs& p, int rows, int stage, cudaStream_t s) {
  return launch_bf16_kd<128>(q, k, v, o, p, rows, stage, s);
}

}  // namespace repro
