// Kernel B6's f32 bodies on an int8 B (W8A16 on f32 activations),
// compiled in their own translation unit so the build runs them beside
// gemm_tb.cu's.
#include "gemm_tb.cuh"

namespace repro {
namespace tb {

template int launch_f32<int8_t, false>(const TbOperands&, const TbArgs&, size_t,
                                       cudaStream_t);
template int launch_f32<int8_t, true>(const TbOperands&, const TbArgs&, size_t,
                                      cudaStream_t);

}  // namespace tb
}  // namespace repro
