// Kernel B6's W8A16 bodies (bf16 A, int8 B widened to bf16), compiled in
// their own translation unit so the build runs them beside gemm_tb.cu's.
#include "gemm_tb.cuh"

namespace repro {
namespace tb {

template int launch_tc<false, kVW8A16>(const TbOperands&, const TbArgs&, size_t,
                                       cudaStream_t);
template int launch_tc<true, kVW8A16>(const TbOperands&, const TbArgs&, size_t,
                                      cudaStream_t);

}  // namespace tb
}  // namespace repro
