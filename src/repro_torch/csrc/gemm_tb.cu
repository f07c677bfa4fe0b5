// gemm_tb — the A-stationary GEMM (kernel B6): its C entry points and the
// dispatch of an operand pair to a body (gemm_tb.cuh, which says what each
// body computes and what bounds it).
#include "gemm_tb.cuh"

namespace repro {
namespace tb {

// Dynamic shared memory of one CTA of a non-bf16 body: the f32 body's
// panel and ring (f32::tb_smem), or the int8 bodies' whole layout (scale,
// bias and residual stages included, also for B6a, which leaves them
// unused).
size_t smem_of(int variant, int bm, int bk, int bn, int res_dtype,
               bool has_scale, bool has_bias, bool has_res) {
  if (variant == kVF32 || variant == kVF32W8) return f32::tb_smem(bm, bk);
  return tb_layout(bm, bk, bn, variant, res_dtype == kBF16 ? 2 : 4,
                   has_scale, has_bias, has_res)
      .total;
}

// Checks the tile against the kernel's limits, sizes the plan's layout and
// picks the body's instantiation: bf16 x bf16 the warp-specialised body at
// the shape the tile maps to (launch_ws); for the int8 tensor-core bodies
// the fragments a warp owns, for f32 the chains a thread keeps.
template <bool kFinal>
int launch(int variant, const TbOperands& o, const TbArgs& p, bool has_scale,
           bool has_bias, bool has_res, cudaStream_t stream) {
  if (variant == kVBf16) return launch_ws<kFinal>(o, p, stream);
  if (p.bn < 1 || p.bn > kThreads || p.bm < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_of(variant, p.bm, p.bk, p.bn, p.res_dtype,
                              has_scale, has_bias, has_res);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case kVW8A16:
      return launch_tc<kFinal, kVW8A16>(o, p, smem, stream);
    case kVW8A8:
      return launch_tc<kFinal, kVW8A8>(o, p, smem, stream);
    case kVF32:
      return launch_f32<float, kFinal>(o, p, smem, stream);
    case kVF32W8:
      return launch_f32<int8_t, kFinal>(o, p, smem, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The variant of an (A, B) type pair, or -1.
int variant_of(int a_dtype, int b_dtype) {
  if (a_dtype == kBF16) return b_dtype == kBF16 ? kVBf16
                               : b_dtype == kI8 ? kVW8A16 : -1;
  if (a_dtype == kI8) return b_dtype == kI8 ? kVW8A8 : -1;
  if (a_dtype == kF32) return b_dtype == kF32 ? kVF32
                              : b_dtype == kI8 ? kVF32W8 : -1;
  return -1;
}

TbArgs make_args(int m, int n, int k, int k0, int kc, int bm, int bk, int bn,
                 int tiles_per_cta, int act, int out_dtype, int res_dtype,
                 int modes) {
  TbArgs p;
  p.M = m, p.N = n, p.K = k, p.k0 = k0, p.kc = kc, p.bm = bm, p.bk = bk;
  p.bn = bn, p.tiles_per_cta = tiles_per_cta, p.act = act;
  p.out_dtype = out_dtype, p.res_dtype = res_dtype, p.modes = modes;
  return p;
}

}  // namespace tb
}  // namespace repro

// Bytes of shared memory one CTA takes for a tile: the dynamic array (and,
// for the bf16 body, its barriers' 1 KiB); -1 for an operand pair no body
// takes.
extern "C" int gemm_tb_smem_bytes(int bm, int bk, int bn, int a_dtype,
                                  int b_dtype, int res_dtype, int has_scale,
                                  int has_bias, int has_res) {
  using namespace repro;
  using namespace repro::tb;
  const int v = variant_of(a_dtype, b_dtype);
  if (v < 0) return -1;
  if (v == kVBf16) return static_cast<int>(ws_smem(bm, bk, bn)) +
                          ws::kStaticSmem;
  return static_cast<int>(smem_of(v, bm, bk, bn, res_dtype, has_scale != 0,
                                  has_bias != 0, has_res != 0));
}

// B6a: one k-chunk [k0, k0 + kc) accumulated into the (m,n) partial c_acc
// (f32, or int32 when A is int8); c_in is the partial of the earlier chunks
// (null on the first; it may be c_acc itself).  A (m,k), B (k,n) row-major
// and contiguous.  The layout flags describe the plan's B6b, whose whole
// layout every chunk sizes.  Returns cudaGetLastError() after the launch.
extern "C" int gemm_tb_accumulate_launch(const void* a, const void* b,
                                         const void* c_in, void* c_acc, int m,
                                         int n, int k, int k0, int kc, int bm,
                                         int bk, int bn, int tiles_per_cta,
                                         int a_dtype, int b_dtype,
                                         int res_dtype, int has_scale,
                                         int has_bias, int has_res, int modes,
                                         void* stream) {
  using namespace repro;
  using namespace repro::tb;
  const TbArgs p = make_args(m, n, k, k0, kc, bm, bk, bn, tiles_per_cta,
                             kNone, kF32, res_dtype, modes);
  const TbOperands o{a, b, c_in, c_acc, nullptr, nullptr, nullptr, nullptr,
                     nullptr};
  return launch<false>(variant_of(a_dtype, b_dtype), o, p, has_scale != 0,
                       has_bias != 0, has_res != 0,
                       static_cast<cudaStream_t>(stream));
}

// B6b: the last k-chunk [k0, k0 + kc) on top of the partial c_in (null when
// it is the only chunk), then b_scale (n,) f32 or null -> bias (n,) f32 or
// null -> activation -> residual (m,n) or null, written to c (m,n) at
// out_dtype (int8: quantized by the device scalar out_scale; int32: the bare
// sums of an int8 A, nothing fused).
extern "C" int gemm_tb_final_launch(const void* a, const void* b,
                                    const void* c_in, void* c,
                                    const void* bias, const void* b_scale,
                                    const void* res, const void* out_scale,
                                    int m, int n, int k, int k0, int kc,
                                    int bm, int bk, int bn, int tiles_per_cta,
                                    int a_dtype, int b_dtype, int out_dtype,
                                    int res_dtype, int act, int modes,
                                    void* stream) {
  using namespace repro;
  using namespace repro::tb;
  const TbArgs p = make_args(m, n, k, k0, kc, bm, bk, bn, tiles_per_cta, act,
                             out_dtype, res_dtype, modes);
  const TbOperands o{a,
                     b,
                     c_in,
                     nullptr,
                     c,
                     static_cast<const float*>(bias),
                     static_cast<const float*>(b_scale),
                     res,
                     static_cast<const float*>(out_scale)};
  return launch<true>(variant_of(a_dtype, b_dtype), o, p, b_scale != nullptr,
                      bias != nullptr, res != nullptr,
                      static_cast<cudaStream_t>(stream));
}
