// gemm_aie — output-stationary GEMM with the fused epilogue, for Hopper.
//
// Replaces: repro/kernels/gemm_aie.py gemm_aie (pallas_call at :143, body
// _gemm_aie_kernel at :38).  Computes C[m,n] = epilogue(sum_k A[m,k] B[k,n])
// with bias (1,n) -> silu/gelu(tanh)/relu -> residual (m,n), all in f32 on
// the register flush; C is f32 or bf16.
//
// What bounds it on an H100: on the serving path the rows are few (m = 1..8
// decode slots, a few hundred prompt tokens in prefill) and B is a weight
// matrix read once, so the kernel is bound by the bytes of B (3.35 TB/s);
// only large-m prefill GEMMs reach the operations side (989 TFLOP/s bf16).
//
// Design (bf16 operands): gemm_ws.cuh's warp-specialised body, shared with
// B6.  One CTA owns one BM x BN tile of C and walks all of k, so nothing is
// carried between blocks (the TPU grid's sequential k axis becomes this
// loop).  A producer warp keeps a ring of 64-deep TMA stages (A's slab and
// B's 64-column panels, 128-byte swizzled) full, and one or two consumer
// warpgroups run wgmma m64nNk16 on the stages that have landed.  The wrapper
// (kernels/gemm_aie.py cta_tile) picks the CTA shape by m and n: with few
// rows (m <= 16) the swapped form, 64 columns of B on wgmma's 64-row side
// and the 16 rows on its N side, so the weight-streaming CTAs each keep
// 64 KB of B in flight; with more rows the largest of 128 x 256, 128 x 128
// and 64 x 128 that still gives every SM a CTA, else 64 x 64.  Ragged edges
// (m, n, k) land as zeros from TMA and are not stored, so no caller pads.
// The launch is a programmatic dependent, so the CTAs' set-up overlaps the
// kernel before it.
//
// f32 operands run the CUDA-core body of gemm_f32.cuh (shared with B6):
// one fmaf chain over k = 0..K-1 an element, each thread a block of rows x
// columns of chains, at a CTA shape the wrapper picks by m and n
// (kernels/gemm_aie.py F32_TILES), operands through a cp.async ring.
//
// The int8 paths (repro/kernels/gemm_aie.py:60-62, :72, :111 and the
// out-quant of epilogue.py:126-128) keep the sm_80 body below
// (gemm_aie_mma_kernel: cp.async stages filled by every thread, the
// mma.sync m16n8k16 chain of mma_chain.cuh) at its own CTA shapes
// (kernels/gemm_aie.py INT8_TILES); that chain gives the bits of the bf16
// body's wgmma chain (gemm_ws.cuh), so W8A16 still equals it:
//   W8A16: a bf16 A against an int8 B (a quantized weight).  B is staged at
//     one byte an element, the halving of the weight bytes that bound the
//     decode GEMMs; once a slab lands, every thread widens it to bf16 into
//     one swizzled tile (mma_chain.cuh widen_int8), and the bf16 chain runs
//     on it unchanged: a row equals this kernel's bf16 body on
//     q.to(bfloat16), and the (1, n) b_scale multiplies the f32 accumulator
//     once on the flush, before the epilogue.  The f32 body takes an int8 B
//     too, widened as it is read.
//   W8A8: int8 A (staged in the bytes of a swizzled tile) and B (transposed
//     k-major once a slab lands, transpose_int8) on mma.sync m16n8k32 s8
//     with int32 accumulators, both read by ldmatrix (mma_slab_s8); exact
//     for any k served here (k 127^2 < 2^31 up to k ~ 133,000).  The flush
//     converts to f32 and multiplies by b_scale, or stores the bare int32
//     sums when nothing is fused.
//   out-quant: after the epilogue an int8 C takes x / out_scale, rounded
//     half to even and clipped to +-127 (common.cuh quantize_out).
//
// Order invariance: every C element is one chain over k in a fixed order
// (the k16 tensor-core chain for bf16, whose bits wgmma and mma.sync give
// alike, the fmaf chain for f32), whatever m is, whichever CTA shape runs
// it and wherever the row sits in the tile.  A row's result is therefore
// the same bits at batch 1
// and inside a continuous batch, which is what keeps continuous-batched
// greedy decoding identical to solo greedy decoding; and B6 (gemm_tb.cu)
// runs the same chains, so it equals this kernel bit for bit.
#include <type_traits>

#include "gemm_f32.cuh"
#include "gemm_ws.cuh"
#include "mma_chain.cuh"
#include "staging.cuh"

namespace repro {
namespace {

struct Operands {
  const void *a, *b;
  void* c;
  const void *bias, *scale, *res, *out_scale;
};

// ---------------------------------------------------------------------------
// The tensor-core body (bf16 operands)
// ---------------------------------------------------------------------------

struct AieArgs {
  int M, N, K, act;
  int out_dtype, res_dtype;  // C's and the residual's type (DType)
  int mode_a, mode_b;        // staging.cuh copy modes of A and B
};

// The operand variants of the int8 tensor-core body: W8A16 (bf16 A, int8 B
// widened to bf16 once a slab lands) and W8A8 (int8 A and B, int32
// accumulators, mma_chain.cuh mma_slab_s8).  bf16 x bf16 runs gemm_ws.cuh.
enum Variant : int { kVW8A16 = 1, kVW8A8 = 2 };

// A CTA shape of the int8 body: kWM x kWN warps, each owning kFM x kFN
// m16n8 fragments, so a BM x BN tile of C; BK-deep slabs through kStages
// stages.  With kCopyWarps > 0 that many more warps do all the staging, so
// the MMA warps of a narrow tile never stall on issuing copies; with 0
// every warp stages.  A stage holds the A slab, then the int8 B slab.
template <int kWM, int kWN, int kFM, int kFN, int kBK_, int kStages_,
          int kCopyWarps_ = 0>
struct MmaShape {
  static constexpr int kMmaWarps = kWM * kWN, kCopyWarps = kCopyWarps_;
  static constexpr int kThreads = 32 * (kMmaWarps + kCopyWarps);
  static constexpr int kCopyThreads = kCopyWarps ? 32 * kCopyWarps : kThreads;
  static constexpr int kBM = 16 * kFM * kWM, kBN = 8 * kFN * kWN;
  static constexpr int kBK = kBK_, kStages = kStages_;
  static constexpr int kWarpM = kWM, kWarpN = kWN, kFragM = kFM, kFragN = kFN;
  template <int kV>
  __host__ __device__ static constexpr int a_bytes() {
    return kBM * kBK * (kV == kVW8A8 ? 1 : 2);
  }
  template <int kV>
  __host__ __device__ static constexpr int stage_bytes() {
    return a_bytes<kV>() + kBK * kBN;  // B at one byte an element
  }
  // the ring, then (int8 B) the slab the MMA warps read: widened to bf16
  // (W8A16) or k-major (W8A8)
  template <int kV>
  __host__ __device__ static constexpr int conv_bytes() {
    return kBK * kBN * (kV == kVW8A16 ? 2 : 1);
  }
  template <int kV>
  __host__ __device__ static constexpr size_t smem() {
    return static_cast<size_t>(kStages) * stage_bytes<kV>() +
           conv_bytes<kV>();
  }
};

// One BM x BK slab of A and one BK x BN slab of B into a stage, zero-filled
// past K, M and N, by the S::kCopyThreads threads (tid: this one's index
// among them).  With m <= 8 rows a 16-row A slab stages only its first 8
// rows (a_rows).  A bf16 A lands in mma_chain.cuh's swizzled tile, an
// int8 A in the bytes of one (Swz8, which ldmatrix reads), an int8 B
// row-major (Rows8) at one byte an element, for the conversion pass.
template <typename S, int kV>
__device__ __forceinline__ void aie_load(unsigned char* stage, const void* A,
                                         const void* B, const AieArgs& p,
                                         int row0, int col0, int rows_valid,
                                         int cols_valid, int a_rows, int k0,
                                         int tid) {
  constexpr int kT = S::kCopyThreads;
  const int depth = min(S::kBK, p.K - k0);
  const size_t a_at = static_cast<size_t>(row0) * p.K + k0;
  const size_t b_at = static_cast<size_t>(k0) * p.N + col0;
  if constexpr (kV == kVW8A8) {
    const int8_t* a = static_cast<const int8_t*>(A) + a_at;
    int8_t* at = reinterpret_cast<int8_t*>(stage);
    const Swz8 al{smem_tile(reinterpret_cast<__nv_bfloat16*>(stage),
                            S::kBK / 2)};
    if (p.mode_a == 2)
      stage_rows16<kT, S::kBK>(at, al, a, p.K, a_rows, rows_valid, depth,
                               tid);
    else
      stage_rows<kT>(at, al, a, p.K, a_rows, S::kBK, rows_valid, depth,
                     p.mode_a, tid);
  } else {
    const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(A) + a_at;
    const SmemTile at =
        smem_tile(reinterpret_cast<__nv_bfloat16*>(stage), S::kBK);
    if (p.mode_a == 2)
      stage_rows16<kT, S::kBK>(at.p, at, a, p.K, a_rows, rows_valid, depth,
                               tid);
    else
      stage_rows<kT>(at.p, at, a, p.K, a_rows, S::kBK, rows_valid, depth,
                     p.mode_a, tid);
  }
  // the wrapper picks mode 2 only when a row of the tile is 16-byte units
  stage_rows<kT>(reinterpret_cast<int8_t*>(stage + S::template a_bytes<kV>()),
                 Rows8{S::kBN}, static_cast<const int8_t*>(B) + b_at, p.N,
                 S::kBK, S::kBN, depth, cols_valid, p.mode_b, tid);
}

template <typename S, int kV>
__global__ void __launch_bounds__(S::kThreads)
gemm_aie_mma_kernel(const void* __restrict__ A, const void* __restrict__ B,
                    void* C, const float* __restrict__ bias,
                    const float* __restrict__ scale, const void* res,
                    const float* __restrict__ out_scale, AieArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStage = S::template stage_bytes<kV>();
  constexpr int kABytes = S::template a_bytes<kV>();
  const int row0 = blockIdx.y * S::kBM, col0 = blockIdx.x * S::kBN;
  const int rows_valid = min(S::kBM, p.M - row0);
  const int cols_valid = min(S::kBN, p.N - col0);
  const int warp = threadIdx.x >> 5;
  const bool mma_warp = warp < S::kMmaWarps;
  // the threads that stage: every thread, or the copy warps after the MMA
  // warps
  const int tid = threadIdx.x - (S::kCopyWarps ? 32 * S::kMmaWarps : 0);
  const bool copier = tid >= 0;
  const int wr = (warp / S::kWarpN) * 16 * S::kFragM;  // warp's rows
  const int wc = (warp % S::kWarpN) * 8 * S::kFragN;   // warp's columns
  // one 16-row fragment (the few-row shapes): at m <= 8 only 8 rows of A
  // are staged, and the fragment's other 8 read as zero
  constexpr bool kEdge = S::kBM == 16;
  const int a_rows = kEdge && rows_valid <= 8 ? 8 : S::kBM;
  // stage s: the BM x BK slab of A, then the BK x BN slab of B
  auto a_tile = [&](int s) {
    return smem_tile(reinterpret_cast<__nv_bfloat16*>(smem + s * kStage),
                     S::kBK);
  };
  auto bytes = [&](int s, int off) {
    return reinterpret_cast<const int8_t*>(smem + s * kStage + off);
  };
  // the converted B slab (int8 B): bf16 (W8A16) or k-major int8 (W8A8)
  unsigned char* conv = smem + S::kStages * kStage;
  const SmemTile bw = smem_tile(reinterpret_cast<__nv_bfloat16*>(conv),
                                kV == kVW8A8 ? S::kBK / 2 : S::kBN);
  const int slabs = (p.K + S::kBK - 1) / S::kBK;
  auto load = [&](int slab) {
    aie_load<S, kV>(smem + (slab % S::kStages) * kStage, A, B, p, row0, col0,
                    rows_valid, cols_valid, a_rows, slab * S::kBK, tid);
  };

  using Acc = std::conditional_t<kV == kVW8A8, int, float>;
  Acc acc[S::kFragM][S::kFragN][4];
#pragma unroll
  for (int i = 0; i < S::kFragM; ++i)
#pragma unroll
    for (int j = 0; j < S::kFragN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // The ring: with copy warps, slab 0 goes first and the MMA warps start on
  // it while the copy warps fill the other stages; without, kStages - 1
  // slabs are in flight before the first products.  Either way slab
  // i + kStages - 1 is issued in iteration i, into the stage that slab
  // i - 1 left, after the barrier that says every warp is done with it.
  constexpr int kAhead = S::kCopyWarps ? 1 : S::kStages - 1;
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (copier && s < slabs) load(s);
    cp_async_commit();
  }
  for (int i = 0; i < slabs; ++i) {
    if (S::kCopyWarps && i == 0)
      cp_async_wait<0>();
    else
      cp_async_wait<S::kStages - 2>();
    __syncthreads();  // slab i landed; every warp is done with slab i - 1
    if (S::kCopyWarps && i == 0) {
      for (int s = 1; s < S::kStages; ++s) {
        if (copier && s < slabs) load(s);
        cp_async_commit();
      }
    } else {
      const int next = i + S::kStages - 1;
      if (copier && next < slabs) load(next);
      cp_async_commit();
    }
    const int s = i % S::kStages;
    // an int8 B slab, once landed, converted by every thread (the MMA warps
    // of slab i - 1 are past the barrier above, so the buffer is free)
    if constexpr (kV == kVW8A16) {
      widen_int8<S::kThreads>(bytes(s, kABytes), Rows8{S::kBN}, bw.p,
                              Tile16{bw}, S::kBK, S::kBN, threadIdx.x);
      __syncthreads();
    } else if constexpr (kV == kVW8A8) {
      transpose_int8<S::kThreads>(bytes(s, kABytes), Rows8{S::kBN},
                                  reinterpret_cast<int8_t*>(conv), Swz8{bw},
                                  S::kBK, S::kBK, S::kBN, threadIdx.x);
      __syncthreads();
    }
    if (!mma_warp) continue;
    // the slab is zero-filled past K, so its last step runs whole
    const int depth = min(S::kBK, p.K - i * S::kBK);
    if constexpr (kV == kVW8A8) {
      mma_slab_s8<S::kFragM, S::kFragN, kEdge>(
          acc,
          smem_tile(reinterpret_cast<__nv_bfloat16*>(smem + s * kStage),
                    S::kBK / 2),
          wr, a_rows - wr, 0, bw, wc, (depth + 31) & ~31);
    } else {
      mma_slab<S::kFragM, S::kFragN, kEdge>(
          acc, a_tile(s), wr, a_rows - wr, bw, wc, S::kBN - wc,
          depth == S::kBK ? S::kBK : (depth + 15) & ~15);
    }
  }

  if (!mma_warp) return;
#pragma unroll
  for (int i = 0; i < S::kFragM; ++i)
#pragma unroll
    for (int j = 0; j < S::kFragN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wr + frag_row(i, e), c = wc + frag_col(j, e);
        if (r >= rows_valid || c >= cols_valid) continue;
        const size_t at = static_cast<size_t>(row0 + r) * p.N + col0 + c;
        if constexpr (kV == kVW8A8) {
          if (p.out_dtype == kI32) {  // the bare int32 sums
            static_cast<int*>(C)[at] = acc[i][j][e];
            continue;
          }
        }
        float rv = 0.0f;
        if (res != nullptr)
          rv = p.res_dtype == kBF16
                   ? to_f32(static_cast<const __nv_bfloat16*>(res)[at])
                   : static_cast<const float*>(res)[at];
        float x = static_cast<float>(acc[i][j][e]);
        x = dequant(x, scale, col0 + c);
        x = epilogue(x, bias != nullptr,
                     bias != nullptr ? bias[col0 + c] : 0.0f, p.act,
                     res != nullptr, rv);
        store_out(C, at, x, p.out_dtype, out_scale);
      }
}

template <typename S, int kV>
int launch_mma(const Operands& o, const AieArgs& p, cudaStream_t stream) {
  auto kernel = gemm_aie_mma_kernel<S, kV>;
  constexpr size_t kSmem = S::template smem<kV>();
  static bool configured = false;  // one attribute call per shape
  if (!configured) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kSmem));
    configured = true;
  }
  dim3 grid(cdiv(p.N, S::kBN), cdiv(p.M, S::kBM));
  kernel<<<grid, S::kThreads, kSmem, stream>>>(
      o.a, o.b, o.c, static_cast<const float*>(o.bias),
      static_cast<const float*>(o.scale), o.res,
      static_cast<const float*>(o.out_scale), p);
  return static_cast<int>(cudaGetLastError());
}

// The CTA shapes of the int8 bodies, by the index kernels/gemm_aie.py
// INT8_TILES gives them (its (bm, bk, bn) must match): with m <= 16 one
// 16-row fragment and 1, 4 or 8 MMA warps of one 8-column fragment each;
// the two narrow shapes beside 4 copy warps and 8 stages (so 16 KB or more
// of B is in flight and the MMA warps start on the first slab), the widest
// (many CTAs) staging itself through 4; with more rows 64 x 64 (4 warps of
// 2 x 4 fragments that stage too), 4 stages.  Slabs are 256 deep (128 for
// 64 x 64), so a stage holds as many bytes of int8 B as the bf16 shapes
// held, and the conversion pass runs half as often a k.
template <int kV>
int launch_tc(int config, const Operands& o, const AieArgs& p,
              cudaStream_t s) {
  switch (config) {
    case 1:
      return launch_mma<MmaShape<1, 1, 1, 1, 256, 8, 4>, kV>(o, p, s);
    case 2:
      return launch_mma<MmaShape<1, 4, 1, 1, 256, 8, 4>, kV>(o, p, s);
    case 3:
      return launch_mma<MmaShape<1, 8, 1, 1, 256, 4>, kV>(o, p, s);
    case 4:
      return launch_mma<MmaShape<2, 2, 2, 4, 128, 4>, kV>(o, p, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}


}  // namespace
}  // namespace repro

// A (m,k), B (k,n), C (m,n) row-major and contiguous; bias (n,) f32 or
// null; b_scale (n,) f32 or null (an int8 B's per-column dequant scale,
// applied before the epilogue); residual (m,n) or null; out_scale a
// device f32 scalar or null (int8 C: the flush's output quantization).
// Operand types: bf16 x bf16 runs the warp-specialised body at CTA shape
// ``config`` (1..9, gemm_aie_ws.cu), bf16 x int8 (W8A16) and int8 x int8
// (W8A8) the int8 bodies (1..4, see launch_tc), f32 x f32 and f32 x int8
// the fmaf body (1..10, gemm_f32.cuh launch_aie), each with the staging
// copy modes ``modes`` (2 bits each: A, then B; 2 lets bf16 x bf16 take
// tensor maps).  C is f32, bf16, int8 (with out_scale) or, for W8A8 with
// nothing fused, the int32 sums.
// Returns cudaGetLastError() after the launch.
extern "C" int gemm_aie_launch(const void* a, const void* b, void* c,
                               const void* bias, const void* b_scale,
                               const void* res, const void* out_scale, int m,
                               int n, int k, int a_dtype, int b_dtype,
                               int out_dtype, int res_dtype, int act,
                               int config, int modes, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Operands o{a, b, c, bias, b_scale, res, out_scale};
  if (a_dtype == kF32) {
    const f32::AieOperands fo{static_cast<const float*>(a), b, c,
                              static_cast<const float*>(bias),
                              static_cast<const float*>(b_scale), res,
                              static_cast<const float*>(out_scale)};
    const f32::AieArgs fp{m, n, k, act, out_dtype, res_dtype, modes & 3,
                          (modes >> 2) & 3};
    return b_dtype == kI8 ? f32::launch_aie<int8_t>(config, fo, fp, s)
                          : f32::launch_aie<float>(config, fo, fp, s);
  }
  AieArgs p;
  p.M = m, p.N = n, p.K = k, p.act = act;
  p.out_dtype = out_dtype, p.res_dtype = res_dtype;
  p.mode_a = modes & 3, p.mode_b = (modes >> 2) & 3;
  if (a_dtype == kI8) return launch_tc<kVW8A8>(config, o, p, s);
  if (b_dtype == kI8) return launch_tc<kVW8A16>(config, o, p, s);
  ws::Args w{};
  w.M = m, w.N = n, w.K = k, w.k0 = 0, w.kc = k, w.tiles_per_cta = 1;
  w.act = act, w.out_dtype = out_dtype, w.res_dtype = res_dtype;
  w.mode_a = p.mode_a, w.mode_b = p.mode_b;
  return gemm_aie_ws_launch(
      config,
      ws::Operands{static_cast<const __nv_bfloat16*>(a),
                   static_cast<const __nv_bfloat16*>(b), nullptr, c,
                   static_cast<const float*>(bias), res,
                   static_cast<const float*>(out_scale)},
      w, s);
}
