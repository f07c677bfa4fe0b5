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
//     (staging.cuh) into a two-stage ring, so block j + 1 lands while block
//     j computes.  Shared memory: 2 stages x (K + V) x 64 keys x kD x 2 B =
//     512 kD bytes, 64 KB at d = 128 (of 227 KB; set through
//     cudaFuncSetAttribute), 32 KB at d = 64, 128 KB (+ the q tile) at 256.
//   * A CTA's rows are (q position, q head) pairs of one kv head's GQA
//     group, flattened position-major, so each staged block serves every q
//     head of the group (3 in smollm-360m, 16 in qwen3-moe): the old body
//     staged it once per q head.  A CTA holds 64 rows, four warps of 16
//     (kernels/flash_attention.py cta_shape gives its grid), and the grid
//     runs the causally heaviest q tiles first.  Measured on an H100
//     (PERF.md §6), 64 rows beat 16 and 32 at every served prompt and
//     chunk length even where they leave most SMs idle: fewer warps a CTA
//     stage each block more slowly.  128 rows were slower too: at d = 128
//     a thread holds 248 registers, so one 256-thread CTA fills an SM's
//     register file.
//   * head_dim is padded in shared memory to kD = 32, 64, 128 or 256 with
//     zeros (QK^T's k-dim reads zeros up to the 16-grid; P V's columns past d
//     are not stored).  Rows that are not whole 16-byte chunks (d = 20:
//     40-byte rows) stage by 4-byte cp.async or plain loads, zero-filling the
//     tail.
//   * At kD = 256 (recurrentgemma-9b's local layers) a warp's 16 q
//     fragments (64 registers) and a 128-register O accumulator beside the
//     S tile pass 255 a thread.  So two warps share 16 rows, each computing
//     their S and P in full (the same bits) and keeping O's columns of one
//     half, 128 wide: a CTA holds 32 rows.  q is staged once into a swizzled
//     [32 rows][256] tile after the ring (16 KB; 144 KB a CTA in all) and
//     each k16 step's fragment is read by ldmatrix (mma_chain.cuh
//     mma_qkt_smem): the same products in the same order.
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
// tile a row falls in and how many q heads share the CTA change nothing;
// the softmax arithmetic is written with explicit roundings (__fmul_rn,
// __fadd_rn) so that no instantiation contracts it differently.
//
// f32 body (flash_attention_kernel, flash.cuh's block step): one CTA per
// (16 query rows, q head, batch row), 32-key blocks, fmaf chains; it serves
// the f32 smoke model's card == CPU gate and the f32 edge cases.  Every
// prefill, short prompts included, runs here.
#include "flash.cuh"
#include "mma_chain.cuh"
#include "staging.cuh"

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

// ---------------------------------------------------------------------------
// The tensor-core body (bf16)
// ---------------------------------------------------------------------------

constexpr int kBkv = 64;     // keys a block: the fixed key grid
constexpr int kWarps = 4;    // a warp holds 16 rows of the CTA's 64
constexpr int kRows = 16 * kWarps, kThreads = 32 * kWarps;

// The kD = 256 body's split: two warps a 16-row group, one O half each.
template <int kD>
constexpr bool kSplitCols = kD > 128;
// Rows a CTA holds, and the output columns one warp keeps.
template <int kD>
constexpr int kRowsOf = kSplitCols<kD> ? kRows / 2 : kRows;
template <int kD>
constexpr int kColsOf = kSplitCols<kD> ? kD / 2 : kD;

struct FaArgs {
  int batch, sq, skv, hq, hkv, d, group, causal, window, q_offset;
  int rows;            // sq * group: rows of one (batch row, kv head)
  int mode_k, mode_v;  // staging.cuh copy modes of k and v
  float scale_log2;    // softmax scale * log2 e
};

// kRowsOf<kD> rows, head_dim padded to kD.
template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, FaArgs p) {
  constexpr int kQK = kD / 16;   // k16 steps of S = Q K^T
  constexpr int kSF = kBkv / 8;  // n8 score fragments a block
  constexpr int kPV = kBkv / 16; // k16 steps of O += P V
  constexpr bool kQSmem = kSplitCols<kD>;  // q from shared memory a step
  constexpr int kR = kRowsOf<kD>;          // rows a CTA holds
  constexpr int kOF = kColsOf<kD> / 8;     // the warp's n8 output fragments
  constexpr int kTile = kBkv * kD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);

  // the CTA's work: q tiles in descending order (causally heaviest first),
  // then kv head, then batch row
  const int tiles = (p.rows + kR - 1) / kR;
  const int per_tile = p.hkv * p.batch;
  const int tile = tiles - 1 - static_cast<int>(blockIdx.x) / per_tile;
  const int rest = static_cast<int>(blockIdx.x) % per_tile;
  const int kvh = rest % p.hkv, bi = rest / p.hkv;
  const int f0 = tile * kR;  // first flat row: position f / group,
                             // q head kvh * group + f % group
  const int f_last = min(f0 + kR, p.rows) - 1;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // the warp's 16-row group and its first output column
  const int wrow = kQSmem ? warp >> 1 : warp;
  const int col0 = kQSmem ? (warp & 1) * kColsOf<kD> : 0;

  // this thread's two rows (g and g + 8 of its warp's 16)
  int qpos[2];
  bool row_ok[2];
  const __nv_bfloat16* qrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = f0 + 16 * wrow + g + 8 * h;
    row_ok[h] = f < p.rows;
    const int fc = row_ok[h] ? f : 0;
    const int pos = fc / p.group;
    const int head = kvh * p.group + (fc - pos * p.group);
    qpos[h] = p.q_offset + pos;
    qrow[h] = q + ((static_cast<size_t>(bi) * p.sq + pos) * p.hq + head) *
                      p.d;
  }
  // q as A fragments, zero past d and past the rows; at kD = 256 as a
  // shared tile of the CTA's rows instead (visible after the loop's first
  // __syncthreads, before any product)
  uint32_t qa[kQSmem ? 1 : kQK][4];
  const SmemTile qt = smem_tile(ring + 4 * kTile, kD);
  if constexpr (kQSmem) {
    for (int i = tid; i < kR * (kD / 8); i += kThreads) {
      const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
      const int f = f0 + r;
      const int pos = f / p.group;
      const __nv_bfloat16* row =
          q + ((static_cast<size_t>(bi) * p.sq + pos) * p.hq + kvh * p.group +
               (f - pos * p.group)) * p.d;
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c0 = c + 2 * e;
        const uint32_t lo = f < p.rows && c0 < p.d
                                ? __bfloat16_as_ushort(row[c0]) : 0u;
        const uint32_t hi = f < p.rows && c0 + 1 < p.d
                                ? __bfloat16_as_ushort(row[c0 + 1]) : 0u;
        w[e] = lo | hi << 16;
      }
      *reinterpret_cast<uint4*>(qt.p + qt.at(r, c)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
#pragma unroll
    for (int s = 0; s < kQK; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = r & 1, c = 16 * s + 2 * t + 8 * (r >> 1);
        const __nv_bfloat16* row = qrow[h];
        const uint32_t lo = row_ok[h] && c < p.d
                                ? __bfloat16_as_ushort(row[c]) : 0u;
        const uint32_t hi = row_ok[h] && c + 1 < p.d
                                ? __bfloat16_as_ushort(row[c + 1]) : 0u;
        qa[s][r] = lo | hi << 16;
      }
  }

  // the keys the CTA's rows can see, on the fixed grid
  const int qpos_lo = p.q_offset + f0 / p.group;
  const int qpos_hi = p.q_offset + f_last / p.group;
  const int kv_end = p.causal ? min(p.skv, qpos_hi + 1) : p.skv;
  const int kv_begin =
      p.window > 0 ? max(0, qpos_lo - p.window + 1) / kBkv * kBkv : 0;
  const int blocks = kv_end > kv_begin ? (kv_end - kv_begin + kBkv - 1) / kBkv
                                       : 0;
  // the warp's own rows, for skipping blocks masked for all of them
  const int wf0 = f0 + 16 * wrow;
  const bool warp_live = wf0 < p.rows;
  const int wq_lo = p.q_offset + min(wf0, p.rows - 1) / p.group;
  const int wq_hi = p.q_offset + min(wf0 + 15, p.rows - 1) / p.group;

  const size_t kv_ld = static_cast<size_t>(p.hkv) * p.d;
  const size_t kv_at =
      static_cast<size_t>(bi) * p.skv * kv_ld + static_cast<size_t>(kvh) * p.d;
  auto k_tile = [&](int s) { return smem_tile(ring + 2 * s * kTile, kD); };
  auto v_tile = [&](int s) {
    return smem_tile(ring + (2 * s + 1) * kTile, kD);
  };
  auto stage_block = [&](int j) {
    const int kv0 = kv_begin + j * kBkv, s = j & 1;
    const int valid = min(kBkv, p.skv - kv0);
    const size_t at = kv_at + static_cast<size_t>(kv0) * kv_ld;
    const SmemTile kt = k_tile(s), vt = v_tile(s);
    if (p.mode_k == 2)
      stage_rows16<kThreads, kD>(kt.p, kt, k + at, kv_ld, kBkv, valid, p.d,
                                 tid);
    else
      stage_rows<kThreads>(kt.p, kt, k + at, kv_ld, kBkv, kD, valid, p.d,
                           p.mode_k, tid);
    if (p.mode_v == 2)
      stage_rows16<kThreads, kD>(vt.p, vt, v + at, kv_ld, kBkv, valid, p.d,
                                 tid);
    else
      stage_rows<kThreads>(vt.p, vt, v + at, kv_ld, kBkv, kD, valid, p.d,
                           p.mode_v, tid);
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[kOF][4];
#pragma unroll
  for (int j = 0; j < kOF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  if (blocks > 0) stage_block(0);
  cp_async_commit();
  for (int j = 0; j < blocks; ++j) {
    if (j + 1 < blocks) stage_block(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // block j landed in every thread's view
    const int kv0 = kv_begin + j * kBkv;
    const bool skip =
        !warp_live || (p.causal && kv0 > wq_hi) ||
        (p.window > 0 && kv0 + kBkv - 1 <= wq_lo - p.window);
    if (!skip) {
      const SmemTile kt = k_tile(j & 1), vt = v_tile(j & 1);
      // S = Q K^T
      float sc[kSF][4];
#pragma unroll
      for (int jj = 0; jj < kSF; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[jj][e] = 0.0f;
      if constexpr (kQSmem)
        mma_qkt_smem<kD>(sc, qt, 16 * wrow, kt);
      else
        mma_qkt<kD>(sc, qa, kt);
      // scale and mask in f32; the row max over the quad
      uint32_t live = 0;  // bit 4 jj + e: (row, key) visible
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int jj = 0; jj < kSF; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = kv0 + 8 * jj + 2 * t + (e & 1);
          const int qp = qpos[e >> 1];
          const bool ok = kp < p.skv && (!p.causal || kp <= qp) &&
                          (p.window <= 0 || kp > qp - p.window);
          sc[jj][e] = ok ? __fmul_rn(sc[jj][e], p.scale_log2) : kNegInf;
          live |= static_cast<uint32_t>(ok) << (4 * jj + e);
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[jj][e]);
        }
      float alpha[2], ps[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = m_new == m[h] ? 1.0f : exp2f(__fsub_rn(m[h], m_new));
        m[h] = m_new;
      }
      // p = exp2(s - m), re-zeroed where masked, rounded to bf16 as the A
      // fragments of P V; l sums the rounded values
      uint32_t pa[kPV][4];
#pragma unroll
      for (int jj = 0; jj < kSF; ++jj) {
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = (live >> (4 * jj + e)) & 1u
                              ? exp2f(__fsub_rn(sc[jj][e], m[e >> 1]))
                              : 0.0f;
          pv[e] = __bfloat162float(__float2bfloat16(x));
          ps[e >> 1] = __fadd_rn(ps[e >> 1], pv[e]);
        }
        pa[jj >> 1][2 * (jj & 1)] = pack_bf16(pv[0], pv[1]);
        pa[jj >> 1][2 * (jj & 1) + 1] = pack_bf16(pv[2], pv[3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ps[h] = __fadd_rn(ps[h], __shfl_xor_sync(0xffffffffu, ps[h], 1));
        ps[h] = __fadd_rn(ps[h], __shfl_xor_sync(0xffffffffu, ps[h], 2));
        l[h] = __fadd_rn(__fmul_rn(alpha[h], l[h]), ps[h]);
      }
#pragma unroll
      for (int jo = 0; jo < kOF; ++jo)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[jo][e] = __fmul_rn(acc[jo][e], alpha[e >> 1]);
      // O += P V, over the warp's columns
      mma_pv<kD>(acc, pa, vt, col0 / 8);
    }
    __syncthreads();  // every warp is done with block j's stage
  }

  if (!warp_live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
    const float denom = l[h] > 0.0f ? l[h] : 1.0f;
    __nv_bfloat16* orow = o + (qrow[h] - q);
#pragma unroll
    for (int jo = 0; jo < kOF; ++jo)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = col0 + 8 * jo + 2 * t + e;
        if (c < p.d) orow[c] = __float2bfloat16(acc[jo][2 * h + e] / denom);
      }
  }
}

template <int kD>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               const FaArgs& p, cudaStream_t stream) {
  auto kernel = flash_attention_mma_kernel<kD>;
  // the ring (2 stages of K and V), and at kD = 256 the q tile
  constexpr size_t kSmem = (2 * 2 * static_cast<size_t>(kBkv) +
                            (kSplitCols<kD> ? kRowsOf<kD> : 0)) * kD *
                           sizeof(__nv_bfloat16);
  static bool configured = false;  // one attribute call per shape
  if (!configured) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kSmem));
    configured = true;
  }
  const int tiles = cdiv(p.rows, kRowsOf<kD>);
  kernel<<<tiles * p.hkv * p.batch, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      p);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* q, const void* k, const void* v, void* o,
                const FaArgs& p, cudaStream_t s) {
  if (p.d < 1 || p.d > kFaDmax) return static_cast<int>(cudaErrorInvalidValue);
  if (p.d <= 32) return launch_mma<32>(q, k, v, o, p, s);
  if (p.d <= 64) return launch_mma<64>(q, k, v, o, p, s);
  if (p.d <= 128) return launch_mma<128>(q, k, v, o, p, s);
  return launch_mma<256>(q, k, v, o, p, s);
}

}  // namespace
}  // namespace repro

// All operands contiguous in the (b, s, h, d) layout.  bf16 runs the
// tensor-core body with the staging copy modes ``modes`` (2 bits each: k,
// then v); f32 the fmaf body, which ignores them.  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int sq,
                                      int skv, int hq, int hkv, int d,
                                      int causal, int window, int q_offset,
                                      float scale, int dtype, int modes,
                                      void* stream) {
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
    return launch_bf16(q, k, v, o, p, s);
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
