// Kernel B6's W8A8 bodies (int8 A and B into int32), compiled in
// their own translation unit so the build runs them beside gemm_tb.cu's.
#include "gemm_tb.cuh"

namespace repro {
namespace tb {

template int launch_tc<false, kVW8A8>(const TbOperands&, const TbArgs&, size_t,
                                      cudaStream_t);
template int launch_tc<true, kVW8A8>(const TbOperands&, const TbArgs&, size_t,
                                     cudaStream_t);

}  // namespace tb
}  // namespace repro
