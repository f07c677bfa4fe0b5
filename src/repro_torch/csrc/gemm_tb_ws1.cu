// B6's bf16 body (gemm_ws.cuh) at the shapes with one consumer warpgroup
// (up to 64 rows), in its own translation unit so that it compiles in
// parallel with the others.
#include "gemm_tb.cuh"

namespace repro {
namespace tb {

REPRO_TB_WS_DEFINE(Ws1x64)
REPRO_TB_WS_DEFINE(Ws1x128)
REPRO_TB_WS_DEFINE(Ws1x256)

}  // namespace tb
}  // namespace repro
