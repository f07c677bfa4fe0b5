// B6's bf16 body (gemm_ws.cuh) at the shapes with two consumer warpgroups
// (up to 128 rows), in its own translation unit so that it compiles in
// parallel with the others.
#include "gemm_tb.cuh"

namespace repro {
namespace tb {

REPRO_TB_WS_DEFINE(Ws2x64)
REPRO_TB_WS_DEFINE(Ws2x128)
REPRO_TB_WS_DEFINE(Ws2x256)

}  // namespace tb
}  // namespace repro
