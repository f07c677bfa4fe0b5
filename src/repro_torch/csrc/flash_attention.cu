// flash_attention — forward online-softmax attention (prefill), for Hopper.
//
// Replaces: repro/kernels/flash_attention.py flash_attention (pallas_call at
// :125, body _flash_kernel at :29).  q (b, sq, hq, d), k/v (b, skv, hkv, d),
// out (b, sq, hq, d) in q's dtype: softmax(scale q k^T + mask) v with the
// softmax in f32; GQA maps kv head = q head // group by index (no repeated
// kv), masks causal / window / kv padding by absolute positions with
// q_offset = skv - sq by default, NEG_INF = -1e30, p re-zeroed after the
// exp, output acc / (l > 0 ? l : 1).
//
// What bounds it on an H100: a causal prefill reads q, k, v and writes o
// once (a smollm-360m 300-token prompt: 4 x 300 x 15 or 5 heads x 64 x 2 B,
// about 1.2 MB, 0.36 us at 3.35 TB/s) and does 4 d flops a visible (q, key)
// pair a head (0.35 GFLOP, 0.35 us at 989 TFLOP/s bf16).  Both are far
// below a launch: what the kernel pays is the latency of its key-block
// loop and the work of staging, so the design cuts both.
//
// bf16 body (flash_attention_mma_kernel):
//   * Both products run on the tensor cores, mma.sync m16n8k16 with f32
//     accumulate.  A warp owns 16 rows and keeps their q as A fragments in
//     registers for the whole loop; K blocks are read by ldmatrix from a
//     swizzled [key][d] tile (mma_chain.cuh's SmemTile), which is already
//     the .col B layout of S = Q K^T.  O += P V is the same instruction
//     with V read by ldmatrix.trans.  P is rounded to bf16 straight from
//     S's f32 accumulator registers (the C layout of two m16n8 fragments is
//     the A layout of one k16 step): no score or P tile reaches shared
//     memory.
//   * The scale (d^-0.5, with log2 e folded in for exp2) multiplies the f32
//     scores, never a bf16 q: d^-0.5 is no power of two at d = 120 or 128.
//   * The online softmax stays in registers: a row's max and sum take two
//     __shfl_xor steps over the quad of lanes that hold it, in one order;
//     l sums the bf16-rounded p that P V multiplies.
//   * K and V blocks of kBkv = 64 keys are staged as bf16 by cp.async
//     (staging.cuh) into a two-stage ring, so stage i + 1 lands while stage
//     i computes; a stage copies one block or two (64 or 128 keys, chosen
//     at launch).  Shared memory: 2 stages x (K + V) x 64 keys x kD x 2 B =
//     512 kD bytes, 64 KB at d = 128 (of 227 KB; set through
//     cudaFuncSetAttribute), 32 KB at d = 64, 128 KB (+ the q tile) at 256;
//     twice that with 128-key stages, which kD = 256 therefore does not take.
//   * A CTA's rows are (q position, q head) pairs of one kv head's GQA
//     group, flattened position-major, so each staged block serves every q
//     head of the group (3 in smollm-360m, 16 in qwen3-moe): the old body
//     staged it once per q head.  A CTA holds 16, 32, 64 or 128 rows, a
//     warp of 16 each, chosen at launch (kernels/flash_attention.py
//     cta_shape gives its grid; kD = 256 takes 16, 32 or 64), and the grid
//     runs the causally heaviest q tiles first.  The default is 64 rows:
//     measured on an H100 (PERF.md §6), it beat 16 and 32 at smollm-360m's
//     prompt and chunk lengths even where it leaves most SMs idle, since
//     fewer warps a CTA stage each block more slowly; 128 rows hold 248
//     registers a thread at d = 128, so one 256-thread CTA fills an SM's
//     register file.  The planner's measured search (tune/autotune.py
//     attn_lookup_or_search) picks among the compiled shapes per shape.
//   * head_dim is padded in shared memory to kD = 32, 64, 128 or 256 with
//     zeros (QK^T's k-dim reads zeros up to the 16-grid; P V's columns past d
//     are not stored).  Rows that are not whole 16-byte chunks (d = 20:
//     40-byte rows) stage by 4-byte cp.async or plain loads, zero-filling the
//     tail.
//   * At kD = 256 (recurrentgemma-9b's local layers) a warp's 16 q
//     fragments (64 registers) and a 128-register O accumulator beside the
//     S tile pass 255 a thread.  So two warps share 16 rows, each computing
//     their S and P in full (the same bits) and keeping O's columns of one
//     half, 128 wide: two warps a 16-row group.  q is staged once into a
//     swizzled [rows][256] tile after the ring (16 KB at the default 32
//     rows; 144 KB a CTA in all) and each k16 step's fragment is read by
//     ldmatrix (mma_chain.cuh mma_qkt_smem): the same products in the
//     same order.
//
// Invariance (chunked == unchunked == solo prefill, bit for bit): a row's
// bits depend only on its absolute position, the keys and the fixed key
// grid.  Key blocks start at multiples of kBkv from key 0 (a window's start
// rounds down onto it) and are visited in ascending order; nothing splits
// the keys across warps or CTAs.  A block wholly masked for a row leaves its
// m, l and acc bit for bit unchanged (p = 0, alpha = 1), so rows that their
// q tile makes visit extra causal blocks, and warps that skip blocks masked
// for all their rows, get the same bits.  mma.sync keeps rows independent
// and the quad shuffles reduce within a row, so the CTA's row count, the
// keys a stage copies, the tile a row falls in and how many q heads share
// the CTA change nothing (every launch-time shape gives the same bits);
// the softmax arithmetic is written with explicit roundings (__fmul_rn,
// __fadd_rn) so that no instantiation contracts it differently.
//
// f32 body (flash_attention_kernel, flash.cuh's block step): one CTA per
// (16 query rows, q head, batch row), 32-key blocks, fmaf chains; it serves
// the f32 smoke model's card == CPU gate and the f32 edge cases.  Every
// prefill, short prompts included, runs here.
#include "flash.cuh"
#include "flash_attention_mma.cuh"

namespace repro {
namespace {

// ---------------------------------------------------------------------------
// The f32 body
// ---------------------------------------------------------------------------

template <int kDmax>
__global__ void __launch_bounds__(kFaThreads, 1)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int sq, int skv, int hq, int hkv, int d, int causal,
                       int window, int q_offset, float scale) {
  FlashSmem<kDmax>& sm = flash_smem<kDmax>();
  const int q0 = blockIdx.x * kFaRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int n_rows = min(kFaRows, sq - q0);
  const size_t q_row_stride = (size_t)hq * d;
  const size_t q_at = ((size_t)b * sq + q0) * hq * d + (size_t)h * d;
  const size_t kv_row_stride = (size_t)hkv * d;
  const size_t kv_at = (size_t)b * skv * hkv * d + (size_t)kvh * d;

  flash_load_q(sm, q + q_at, q_row_stride, n_rows, d, scale);
  FlashState<kDmax> st;
  flash_init(st);
  const int qpos_first = q_offset + q0;
  const int qpos_last = qpos_first + n_rows - 1;
  const int kv_end = causal ? min(skv, qpos_last + 1) : skv;
  const int kv_begin =
      window > 0 ? max(0, qpos_first - window + 1) / kFaBkv * kFaBkv : 0;
  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kFaBkv)
    flash_block(sm, st, k + kv_at, v + kv_at, DenseRows{kv_row_stride}, kv0,
                skv, d, n_rows, qpos_first, 1, causal != 0, window);
  flash_store(st, o + q_at, q_row_stride, n_rows, d);
}

template <int kDmax>
int launch_f32(const float* q, const float* k, const float* v, float* o,
               int b, int sq, int skv, int hq, int hkv, int d, int causal,
               int window, int q_offset, float scale, cudaStream_t s) {
  auto kernel = flash_attention_kernel<kDmax>;
  const size_t smem = flash_smem_optin<kDmax>(kernel);
  dim3 grid(cdiv(sq, kFaRows), hq, b);
  kernel<<<grid, kFaThreads, smem, s>>>(q, k, v, o, sq, skv, hq, hkv, d,
                                        causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* q, const void* k, const void* v, void* o,
                const FaArgs& p, int rows, int stage, cudaStream_t s) {
  if (p.d < 1 || p.d > kFaDmax) return static_cast<int>(cudaErrorInvalidValue);
  if (p.d <= 32) return launch_bf16_kd<32>(q, k, v, o, p, rows, stage, s);
  if (p.d <= 64) return launch_bf16_kd<64>(q, k, v, o, p, rows, stage, s);
  if (p.d <= 128) return launch_bf16_d128(q, k, v, o, p, rows, stage, s);
  return launch_bf16_d256(q, k, v, o, p, rows, stage, s);
}

}  // namespace
}  // namespace repro

// All operands contiguous in the (b, s, h, d) layout.  bf16 runs the
// tensor-core body at ``rows`` a CTA and ``stage`` keys a stage (a shape
// flash_attention_mma.cuh compiles, else cudaErrorInvalidValue) with the
// staging copy modes ``modes`` (2 bits each: k, then v); f32 the fmaf body,
// which ignores all three.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int sq,
                                      int skv, int hq, int hkv, int d,
                                      int causal, int window, int q_offset,
                                      float scale, int dtype, int modes,
                                      int rows, int stage, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    FaArgs p;
    p.batch = b, p.sq = sq, p.skv = skv, p.hq = hq, p.hkv = hkv, p.d = d;
    p.group = hq / hkv, p.causal = causal, p.window = window;
    p.q_offset = q_offset;
    p.rows = sq * p.group;
    p.mode_k = modes & 3, p.mode_v = (modes >> 2) & 3;
    p.scale_log2 = scale * kLog2e;
    return launch_bf16(q, k, v, o, p, rows, stage, s);
  }
  if (d < 1 || d > kFaDmax) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  if (d <= 128)
    return launch_f32<128>(qf, kf, vf, of, b, sq, skv, hq, hkv, d, causal,
                           window, q_offset, scale, s);
  return launch_f32<256>(qf, kf, vf, of, b, sq, skv, hq, hkv, d, causal,
                         window, q_offset, scale, s);
}
