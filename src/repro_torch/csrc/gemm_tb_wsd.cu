// B6's bf16 body (gemm_ws.cuh) at the mma.sync shapes (up to 16 rows), in
// its own translation unit so that it compiles in parallel with the
// others.
#include "gemm_tb.cuh"

namespace repro {
namespace tb {

REPRO_TB_WS_DEFINE(WsM8)
REPRO_TB_WS_DEFINE(WsM16)
REPRO_TB_WS_DEFINE(WsM32)
REPRO_TB_WS_DEFINE(WsM64)
REPRO_TB_WS_DEFINE(WsM128)
REPRO_TB_WS_DEFINE(WsM256)

}  // namespace tb
}  // namespace repro
