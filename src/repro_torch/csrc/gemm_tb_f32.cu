// Kernel B6's f32 bodies on an f32 B, compiled in their own translation
// unit so the build runs them beside gemm_tb.cu's.
#include "gemm_tb.cuh"

namespace repro {
namespace tb {

template int launch_f32<float, false>(const TbOperands&, const TbArgs&, size_t,
                                      cudaStream_t);
template int launch_f32<float, true>(const TbOperands&, const TbArgs&, size_t,
                                     cudaStream_t);

}  // namespace tb
}  // namespace repro
