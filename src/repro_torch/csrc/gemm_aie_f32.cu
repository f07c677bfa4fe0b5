// Kernel B1's f32 body on an f32 B (gemm_f32.cuh), compiled in its own
// translation unit so the build runs it beside gemm_aie.cu's.
#include "gemm_f32.cuh"

namespace repro {
namespace f32 {

template int launch_aie<float>(int, const AieOperands&, const AieArgs&,
                               cudaStream_t);

}  // namespace f32
}  // namespace repro
