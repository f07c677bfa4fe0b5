// Kernel B1's bf16 body: gemm_ws.cuh's warp-specialised kernel at B1's CTA
// shapes, in its own translation unit so that it compiles in parallel with
// gemm_aie.cu's int8 and f32 bodies.
#include "gemm_ws.cuh"

namespace repro {
namespace {

// One tile of C a CTA at shape S with `stages` ring stages.
template <typename S>
int launch_shape(const ws::Operands& o, ws::Args p, int stages,
                 cudaStream_t s) {
  p.bm = S::kRows, p.bn = S::kN, p.stages = stages, p.bk = 0;
  return ws::launch<S, false, true>(o, p, s);
}

}  // namespace

// The CTA shapes, by the index kernels/gemm_aie.py BF16_TILES gives them
// (its (bm, bk, bn) must match; bk is the stage depth): with few rows 1 the
// swapped wgmma form, 16 rows x 64 columns, 8 stages (80 KB), and 6 .. 9
// the mma.sync form, 16 rows x 8, 16, 32 or 64 columns (1, 2, 4 or 8
// consumer warps), 16 stages (48 .. 160 KB: 16 .. 128 KB of B in flight);
// with more rows 2 64 x 64 and 3 64 x 128 (one consumer warpgroup), 6 and
// 4 stages (96 KB); 4 128 x 128 and 5 128 x 256 (two), 6 and 4 stages
// (192 KB).  p carries the problem, the epilogue and the copy modes.
int gemm_aie_ws_launch(int config, const ws::Operands& o, const ws::Args& p,
                       cudaStream_t s) {
  switch (config) {
    case 1:
      return launch_shape<ws::Shape<1, 64, 16>>(o, p, 8, s);
    case 2:
      return launch_shape<ws::Shape<1, 64, 0>>(o, p, 6, s);
    case 3:
      return launch_shape<ws::Shape<1, 128, 0>>(o, p, 4, s);
    case 4:
      return launch_shape<ws::Shape<2, 128, 0>>(o, p, 6, s);
    case 5:
      return launch_shape<ws::Shape<2, 256, 0>>(o, p, 4, s);
    case 6:
      return launch_shape<ws::Shape<1, 8, 0, true>>(o, p, 16, s);
    case 7:
      return launch_shape<ws::Shape<1, 16, 0, true>>(o, p, 16, s);
    case 8:
      return launch_shape<ws::Shape<1, 32, 0, true>>(o, p, 16, s);
    case 9:
      return launch_shape<ws::Shape<1, 64, 0, true>>(o, p, 16, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace repro
