// gemm_tb — the A-stationary GEMM with the fused epilogue on its last
// k-chunk (kernel B6), for Hopper: its bodies (the entry points are in
// gemm_tb.cu).
//
// Replaces: repro/kernels/gemm_tb.py gemm_tb, both Pallas sites:
//   B6a  _tb_call        (pallas_call at :96, body _gemm_tb_kernel at :52):
//        one k-chunk, C_acc += A[:, chunk] B[chunk, :], C read-modify-
//        written in place;
//   B6b  _tb_call_final  (pallas_call at :139, body _gemm_tb_final_kernel
//        at :65): the last chunk, then bias (1,n) -> silu/gelu(tanh)/relu
//        -> residual (m,n) in f32, C written once at the out dtype.
// The host (kernels/gemm_tb.py) chunks K, as the JAX package does; the first
// chunk starts from zeros in registers, so C_acc needs no memset.
//
// What bounds it on an H100: the bytes of B, re-read once per m-block, and
// the f32 partial C, read and written once per chunk; at decode the
// operations stay far below the card's rate, at a 300-row prefill they
// reach the tensor cores' side.
//
// Design: the TPU grid (m, n) ran n sequentially past one resident A block.
// Here a CTA owns a (bm x kc) panel of A, loaded once into shared memory,
// and sweeps a contiguous range of n tiles; each m-block's sweep is split
// over several CTAs, each with its own copy of the panel, so the grid fills
// the card even at m = 8.  Its chunks launch as programmatic dependents: a
// chunk's CTAs load the panel and their first B tile while the chunk before
// runs, and wait for that chunk only before its partial.
//   bf16 operands: gemm_ws.cuh's warp-specialised body (shared with B1),
//   its panel, B slabs and f32 partial brought in by TMA, the products on
//   wgmma, at the CTA shape ws_rows below maps the plan's tile to; its
//   dynamic shared memory ws_smem, exactly what core/memory_model.py bills
//   a bf16 'tb' tile on HOPPER_H100 (with the barriers' 1 KiB).
//   int8 B (gemm_tb_mma_kernel): per n tile the CTA streams one (kc x bn)
//   tile of B and the (bm x bn) partial (plus the scale, bias and residual
//   tiles on the last chunk) through two cp.async stages, so the next
//   tile's loads are in flight during this tile's products; its dynamic
//   shared memory is tb_layout below, sized from the plan's (bm, bk, bn),
//   again what core/memory_model.py bills.  The int8 tensor-core body
//   splits the C tile into cdiv(bm, 16) x cdiv(bn, 8) m16n8 fragments;
//   each of the 8 warps owns kFN (1, 2 or 4) neighbouring fragments of one
//   16-row block and walks the whole chunk for them, reading the resident
//   panel and the streamed B stage (both XOR-swizzled, mma_chain.cuh
//   SmemTile) through ldmatrix, its accumulators starting from the staged
//   partial.
//   f32 A (gemm_tb_f32_kernel): gemm_f32.cuh's chain, shared with B1, each
//   of 256 threads a block of rows x columns of chains; the panel resident,
//   B's rows streamed through a ring of stages across the whole sweep, the
//   partial read into the chains at a tile's start and the epilogue's
//   operands on the flush, so shared memory holds A and B only
//   (f32::tb_smem).
// Ragged edges (m, n and the last chunk of k) are zero-filled or skipped,
// so no caller pads.
//
// The int8 paths (repro/kernels/gemm_tb.py:59, :77, :124-134, :232): the int8
// B tile is staged at one byte an element.  W8A16 widens it in registers as
// ldmatrix reads it (mma_chain.cuh mma_slab_b8: the bf16 chain on the
// widened values, chunk boundaries on the 16-grid); W8A8 transposes it
// k-major, kSub k-rows at a time, for the m16n8k32 s8 chain on the int8
// panel, with an int32 partial between chunks, as the JAX package has.
// b_scale and the int8 out-quant apply on the last chunk (B6b), the scale
// staged beside the bias.
//
// Order invariance: every C element is one chain over k = 0..K-1 (B1's:
// the k16 tensor-core chain for bf16, whose bits wgmma and mma.sync give
// alike, the fmaf chain for f32): chunk 0 starts
// from 0, each later chunk continues from the stored f32 partial (the store
// and load are exact, and the host puts bf16 chunk boundaries on the
// 16-grid), and the flush is the one kernel B1 runs (common.cuh epilogue).
// gemm_tb therefore equals gemm_aie bit for bit at any tile, chunk count
// and n split, and the planner may switch dataflow with the batch size
// without changing a token.
#pragma once

#include <type_traits>

#include "gemm_f32.cuh"
#include "gemm_ws.cuh"
#include "mma_chain.cuh"
#include "staging.cuh"

namespace repro {
namespace tb {

constexpr int kThreads = 256;     // core/hardware.py B6_THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFrags = 4;      // core/hardware.py B6_MAX_FRAGS_PER_WARP
constexpr int kMaxChains = 16;    // core/hardware.py B6_F32_MAX_CHAINS
constexpr int kMaxSmem = 232448;  // 227 KiB: one CTA's limit on sm_90

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// The operand variants: the tensor-core bodies (bf16 x bf16, gemm_ws.cuh;
// W8A16: bf16 A with an int8 B widened to bf16; W8A8: int8 A and B into
// int32) and the fmaf body (f32 x f32, f32 x int8; gemm_f32.cuh).
enum Variant : int { kVBf16 = 0, kVW8A16 = 1, kVW8A8 = 2, kVF32 = 3,
                     kVF32W8 = 4 };

__host__ __device__ constexpr int a_size(int v) {  // (the int8 variants)
  return v == kVW8A8 ? 1 : 2;
}

// The W8A8 body transposes its int8 B tile kSub k-rows at a time into the
// k-major sub-slab its chain reads (W8A16 widens B in registers).
constexpr int kSub = 128;

__host__ __device__ constexpr int conv_size(int v) {
  return v == kVW8A8 ? 1 : 0;
}

// Byte offsets of the shared-memory regions of one CTA of the int8 bodies:
// the resident A panel, two int8 B stages,
// the converted int8 sub-slab, two partial-C stages (f32, or int32 when A
// is int8), two b_scale stages (an int8 B's dequant scale), two bias and
// two residual stages (the last three only when the plan has them).
struct TbLayout {
  size_t a, b, conv, c, scale, bias, res, total;
};

__host__ __device__ inline TbLayout tb_layout(int bm, int bk, int bn,
                                              int variant, int res_size,
                                              bool has_scale, bool has_bias,
                                              bool has_res) {
  TbLayout L;
  L.a = 0;
  L.b = align16(static_cast<size_t>(bm) * bk * a_size(variant));
  L.conv = L.b + align16(2 * static_cast<size_t>(bk) * bn);
  L.c = L.conv +
        align16(static_cast<size_t>(kSub) * bn * conv_size(variant));
  L.scale = L.c + align16(2 * static_cast<size_t>(bm) * bn * 4);
  L.bias =
      L.scale + (has_scale ? align16(2 * static_cast<size_t>(bn) * 4) : 0);
  L.res = L.bias + (has_bias ? align16(2 * static_cast<size_t>(bn) * 4) : 0);
  L.total =
      L.res + (has_res ? align16(2 * static_cast<size_t>(bm) * bn * res_size)
                       : 0);
  return L;
}


struct TbArgs {
  int M, N, K;
  int k0, kc;          // this chunk: columns [k0, k0 + kc) of A
  int bm, bk, bn;      // the plan's tile (bk: the panel's row stride)
  int tiles_per_cta;   // n tiles one CTA sweeps
  int act;
  int out_dtype, res_dtype;  // B6b's C and residual types (DType)
  int modes;           // 2 bits an operand: A, B, C, bias, residual, scale
};

// The operands of one launch: A, B, the partial of the earlier chunks (cin,
// null on the first; it may alias cacc), the partial this chunk writes
// (cacc, B6a) or C (B6b), and B6b's epilogue operands.
struct TbOperands {
  const void *a, *b;
  const void* cin;
  void *cacc, *c;
  const float *bias, *scale;
  const void* res;
  const float* out_scale;
};

// The tensor-core bodies, for an int8 B (bf16 x bf16 runs gemm_ws.cuh).
// The tile's cdiv(bm, 16) x cdiv(bn, 8) fragments go to the warps kFN at a
// time along a 16-row block: warp w owns block w / G, fragments (w % G) kFN
// .. +kFN of it (G = cdiv(cdiv(bn, 8), kFN)); the host picks the least kFN
// that needs at most 8 warps (W8A16: an even kFN).  kV: W8A16 runs
// mma_slab_b8, mma_slab's chain on the B tile widened in registers; W8A8
// mma_slab_s8 on the int8 panel and the B tile transposed kSub rows at a
// time, the partial between chunks int32 (exact, so the chunking changes
// no value).
template <int kFN, bool kFinal, int kV>
__global__ void __launch_bounds__(kThreads)
gemm_tb_mma_kernel(TbOperands o, TbArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int res_size = p.res_dtype == kBF16 ? 2 : 4;
  const TbLayout L = tb_layout(p.bm, p.bk, p.bn, kV, res_size,
                               o.scale != nullptr, o.bias != nullptr,
                               o.res != nullptr);
  unsigned char* Bs = smem + L.b;
  float* Cs = reinterpret_cast<float*>(smem + L.c);
  float* Scale_s = reinterpret_cast<float*>(smem + L.scale);
  float* Bias_s = reinterpret_cast<float*>(smem + L.bias);
  unsigned char* Rs = smem + L.res;
  // the A panel: bf16 (p.bk columns), or int8 in the bytes of a b16 tile
  // of p.bk / 2 columns (W8A8, p.bk a multiple of 32), both swizzled
  const SmemTile Ap = smem_tile(reinterpret_cast<__nv_bfloat16*>(smem + L.a),
                                kV == kVW8A8 ? p.bk / 2 : p.bk);
  int8_t* Ap8 = reinterpret_cast<int8_t*>(smem + L.a);
  // W8A8's transposed sub-slab: bn rows of kSub int8
  const SmemTile cw =
      smem_tile(reinterpret_cast<__nv_bfloat16*>(smem + L.conv), kSub / 2);
  using Acc = std::conditional_t<kV == kVW8A8, int, float>;
  const Acc* Cin = static_cast<const Acc*>(o.cin);
  Acc* Cacc = static_cast<Acc*>(o.cacc);
  const Acc* Cst = reinterpret_cast<const Acc*>(Cs);

  const int bm = p.bm, bn = p.bn, kc = p.kc;
  const int n_tiles = (p.N + bn - 1) / bn;
  const int t_begin = blockIdx.x * p.tiles_per_cta;
  const int t_end = min(n_tiles, t_begin + p.tiles_per_cta);
  if (t_begin >= t_end) return;  // the whole CTA
  const int row0 = blockIdx.y * bm;
  const int rows_valid = min(bm, p.M - row0);
  const int mode_a = p.modes & 3, mode_b = (p.modes >> 2) & 3,
            mode_c = (p.modes >> 4) & 3, mode_bias = (p.modes >> 6) & 3,
            mode_r = (p.modes >> 8) & 3, mode_s = (p.modes >> 10) & 3;
  const size_t tile_b = static_cast<size_t>(p.bk) * bn;  // int8 B
  const size_t tile_c = static_cast<size_t>(bm) * bn;
  auto b_bytes = [&](int s) {
    return reinterpret_cast<int8_t*>(Bs + s * tile_b);
  };
  // W8A16: the int8 B tile in the bytes of a b16 tile of bn / 2 columns
  // (bn a multiple of 16), which ldmatrix reads as mma_slab_b8 widens it;
  // its rows and the panel's columns zero-filled to the 16-grid
  auto b8_tile = [&](int s) {
    return smem_tile(reinterpret_cast<__nv_bfloat16*>(Bs + s * tile_b),
                     bn / 2);
  };
  const int kc16 = (kc + 15) & ~15;

  const int groups = ((bn + 7) / 8 + kFN - 1) / kFN;  // fragment runs a block
  const int warp = threadIdx.x >> 5;
  const bool active = warp < ((bm + 15) / 16) * groups;
  const int wr = (warp / groups) * 16;   // the warp's first row
  const int wc = (warp % groups) * 8 * kFN;  // and first column
  // a C element's column in the warp's fragments (mma_slab_b8 holds the
  // even and the odd columns of a 16-column group in two fragments)
  auto col_of = [&](int j, int e) {
    return wc + (kV == kVW8A16 ? b8_col(j, e) : frag_col(j, e));
  };

  // a tile's B, then (issue_rest) its partial C, scale, bias and residual
  // tiles
  auto issue_b = [&](int t, int s) {
    const size_t at = static_cast<size_t>(p.k0) * p.N + t * bn;
    const int cols_valid = min(bn, p.N - t * bn);
    if constexpr (kV == kVW8A16) {
      stage_rows<kThreads>(b_bytes(s), Swz8{b8_tile(s)},
                           static_cast<const int8_t*>(o.b) + at, p.N, kc16,
                           bn, kc, cols_valid, mode_b, threadIdx.x);
    } else {
      stage_rows<kThreads>(b_bytes(s), Rows8{bn},
                           static_cast<const int8_t*>(o.b) + at, p.N, kc, bn,
                           kc, cols_valid, mode_b, threadIdx.x);
    }
  };
  auto issue_rest = [&](int t, int s) {
    const int col0 = t * bn;
    const int cols_valid = min(bn, p.N - col0);
    const RowMajor plain{bn};
    if (Cin != nullptr)
      stage_rows<kThreads>(reinterpret_cast<Acc*>(Cs) + s * tile_c, plain,
                           Cin + static_cast<size_t>(row0) * p.N + col0, p.N,
                           bm, bn, rows_valid, cols_valid, mode_c,
                           threadIdx.x);
    if (kFinal && o.scale != nullptr)
      stage_rows<kThreads>(Scale_s + s * bn, plain, o.scale + col0, 0, 1, bn,
                           1, cols_valid, mode_s, threadIdx.x);
    if (kFinal && o.bias != nullptr)
      stage_rows<kThreads>(Bias_s + s * bn, plain, o.bias + col0, 0, 1, bn, 1,
                           cols_valid, mode_bias, threadIdx.x);
    if (kFinal && o.res != nullptr) {
      const size_t at = static_cast<size_t>(row0) * p.N + col0;
      if (res_size == 2)
        stage_rows<kThreads>(
            reinterpret_cast<__nv_bfloat16*>(Rs) + s * tile_c, plain,
            static_cast<const __nv_bfloat16*>(o.res) + at, p.N, bm, bn,
            rows_valid, cols_valid, mode_r, threadIdx.x);
      else
        stage_rows<kThreads>(reinterpret_cast<float*>(Rs) + s * tile_c,
                             plain, static_cast<const float*>(o.res) + at,
                             p.N, bm, bn, rows_valid, cols_valid, mode_r,
                             threadIdx.x);
    }
  };

  // Chunks launch as programmatic dependents (launch_mma): the first chunk
  // waits for the kernels before it and then lets the next chunk start, so
  // a later chunk's CTAs stage the panel and their first B tile, inputs of
  // this call, while the chunk before it still runs, and wait only before
  // the partial it wrote.
  if (Cin == nullptr) grid_dependency_wait();
  grid_launch_dependents();
  // The A panel, resident for the whole sweep, rides in the first group.
  const size_t a_at = static_cast<size_t>(row0) * p.K + p.k0;
  if constexpr (kV == kVW8A8)  // zero-filled to the 32-grid of the k-steps
    stage_rows<kThreads>(Ap8, Swz8{Ap}, static_cast<const int8_t*>(o.a) + a_at,
                         p.K, bm, (kc + 31) & ~31, rows_valid, kc, mode_a,
                         threadIdx.x);
  else  // (W8A16: zero-filled to the 16-grid of the k-steps)
    stage_rows<kThreads>(Ap.p, Ap, static_cast<const __nv_bfloat16*>(o.a) + a_at,
                         p.K, bm, kV == kVW8A16 ? kc16 : kc, rows_valid, kc,
                         mode_a, threadIdx.x);
  issue_b(t_begin, 0);
  if (Cin != nullptr) grid_dependency_wait();
  issue_rest(t_begin, 0);
  cp_async_commit();
  for (int t = t_begin, s = 0; t < t_end; ++t, s ^= 1) {
    if (t + 1 < t_end) {
      issue_b(t + 1, s ^ 1);
      issue_rest(t + 1, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    Acc acc[1][kFN][4];
    if (active) {
#pragma unroll
      for (int j = 0; j < kFN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wr + frag_row(0, e), c = col_of(j, e);
          acc[0][j][e] = (Cin != nullptr && r < bm && c < bn)
                             ? Cst[s * tile_c + r * bn + c]
                             : Acc(0);
        }
    }
    if constexpr (kV == kVW8A16) {
      if (active)
        mma_slab_b8<1, kFN, true>(acc, Ap, wr, bm - wr, b8_tile(s), wc,
                                  kc16);
    } else {
      // W8A8: the int8 B tile, kSub k-rows at a time, transposed k-major by
      // every thread, then the s8 chain over them (exact int32 sums)
      for (int kk0 = 0; kk0 < kc; kk0 += kSub) {
        const int len = min(kSub, kc - kk0);
        transpose_int8<kThreads>(b_bytes(s) + static_cast<size_t>(kk0) * bn,
                                 Rows8{bn}, reinterpret_cast<int8_t*>(cw.p),
                                 Swz8{cw}, (len + 31) & ~31, len, bn,
                                 threadIdx.x);
        __syncthreads();
        if (active)
          mma_slab_s8<1, kFN, true>(acc, Ap, wr, bm - wr, kk0, cw, wc,
                                    (len + 31) & ~31);
        __syncthreads();  // the sub-slab is rewritten next
      }
    }
    if (active) {
#pragma unroll
      for (int j = 0; j < kFN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wr + frag_row(0, e), c = col_of(j, e);
          const int col = t * bn + c;
          if (r >= rows_valid || c >= bn || col >= p.N) continue;
          const size_t at = static_cast<size_t>(row0 + r) * p.N + col;
          if (kFinal) {
            if constexpr (kV == kVW8A8) {
              if (p.out_dtype == kI32) {  // the bare int32 sums
                static_cast<int*>(o.c)[at] = acc[0][j][e];
                continue;
              }
            }
            float rv = 0.0f;
            if (o.res != nullptr) {
              const size_t ri = s * tile_c + r * bn + c;
              rv = res_size == 2
                       ? to_f32(reinterpret_cast<__nv_bfloat16*>(Rs)[ri])
                       : reinterpret_cast<float*>(Rs)[ri];
            }
            float x = static_cast<float>(acc[0][j][e]);
            x = dequant(x, o.scale != nullptr ? Scale_s + s * bn : nullptr, c);
            x = epilogue(x, o.bias != nullptr,
                         o.bias != nullptr ? Bias_s[s * bn + c] : 0.0f, p.act,
                         o.res != nullptr, rv);
            store_out(o.c, at, x, p.out_dtype, o.out_scale);
          } else {
            Cacc[at] = acc[0][j][e];
          }
        }
    }
    __syncthreads();  // stage s is refilled by the next iteration's issue
  }
}

template <int kFN, bool kFinal, int kV>
int launch_mma(const TbOperands& o, const TbArgs& p, size_t smem,
               cudaStream_t stream) {
  auto kernel = gemm_tb_mma_kernel<kFN, kFinal, kV>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxSmem);
    configured = true;
  }
  const int n_tiles = (p.N + p.bn - 1) / p.bn;
  dim3 grid((n_tiles + p.tiles_per_cta - 1) / p.tiles_per_cta,
            (p.M + p.bm - 1) / p.bm);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, o, p));
}

// The f32 body: gemm_f32.cuh's chain at the plan's tile.  Each of the 256
// threads keeps kR x kC chains, kC = min(4, bm bn / 256) (launch_f32):
// thread (ty, tx) of bn / kC column threads holds rows ty + (256 / (bn /
// kC)) i and columns tx kC + j.  The CTA's (bm x kc) panel of A stays
// resident, held as panels of f32::tb_panel_cols columns (zero past kc on
// the 32-grid of the k steps), and the B tiles of its n sweep stream
// through a ring of f32::kTbStages stages of f32::kTbStageBytes, slab
// after slab across tiles.  Where A and B are f32 with whole 16-byte rows
// the host hands tensor maps and thread 0 issues the panel's boxes and
// each stage's box onto mbarriers (the host keeps interior chunk
// boundaries on the 32-grid, so a box's columns past kc are never
// multiplied); else every thread copies by cp.async.  A tile's chains
// start from the partial of the earlier chunks (o.cin, null on the first;
// it may alias o.cacc: a thread reads its elements at the tile's start
// and writes them at its end) and leave as the partial (kFinal false,
// B6a) or, kFinal, through the flush with b_scale, bias and residual read
// from device memory (B6b).  Chunks launch as programmatic dependents: a
// chunk stages its panel and first slabs, inputs of this call, while the
// chunk before it runs, and waits for it only before the partial.  TB is
// B's type: f32, or int8 widened as it is read.
template <int kR, int kC, bool kFinal, typename TB>
__global__ void __launch_bounds__(kThreads)
gemm_tb_f32_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, TbOperands o,
                   TbArgs p, int tma) {
  // (a tensor copy lands on a 128-byte-aligned address)
  extern __shared__ __align__(128) unsigned char smem[];
  const float* __restrict__ A = static_cast<const float*>(o.a);
  const TB* __restrict__ B = static_cast<const TB*>(o.b);
  const float* Cin = static_cast<const float*>(o.cin);
  float* Cacc = static_cast<float*>(o.cacc);
  const int bm = p.bm, bn = p.bn, kc = p.kc;
  const int pw = f32::tb_panel_cols(p.bk);       // a panel's columns
  constexpr int kG = f32::kGroup<kR, kC>;        // a chain_steps group
  const int kcg = (kc + f32::kGrid - 1) & ~(f32::kGrid - 1);
  float* As = reinterpret_cast<float*>(smem);
  TB* Bs = reinterpret_cast<TB*>(smem + f32::tb_panel_bytes(bm, p.bk));
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + f32::tb_smem(bm, p.bk) - (f32::kTbStages + 1) * 8);
  uint64_t* panel_bar = bars + f32::kTbStages;
  // B's rows a stage (a power of two, a multiple of kG, that divides a
  // whole panel), and the slabs of one tile
  const int ks = f32::tb_stage_rows(bn, sizeof(TB));
  const int slabs = (kc + ks - 1) / ks;
  const int n_tiles = (p.N + bn - 1) / bn;
  const int t_begin = blockIdx.x * p.tiles_per_cta;
  const int t_end = min(n_tiles, t_begin + p.tiles_per_cta);
  if (t_begin >= t_end) return;  // the whole CTA
  const int row0 = blockIdx.y * bm;
  const int rows_valid = min(bm, p.M - row0);
  const int tx_n = bn / kC, ty_n = kThreads / tx_n;
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
  const int mode_a = p.modes & 3, mode_b = (p.modes >> 2) & 3;
  const int total = (t_end - t_begin) * slabs;
  // slab g of the sweep: tile t_begin + g / slabs, its rows s ks .. of B
  auto issue = [&](int g) {
    const int t = t_begin + g / slabs, s = g % slabs;
    const int col0 = t * bn, stage = g % f32::kTbStages;
    TB* dst = Bs + static_cast<size_t>(stage) * ks * bn;
    if (tma) {
      mbar_expect(bars + stage, ks * bn * static_cast<int>(sizeof(TB)));
      tma_2d(dst, &map_b, col0, p.k0 + s * ks, bars + stage);
      return;
    }
    stage_rows<kThreads>(
        dst, RowMajor{bn}, B + static_cast<size_t>(p.k0 + s * ks) * p.N + col0,
        p.N, ks, bn, min(ks, kc - s * ks), min(bn, p.N - col0), mode_b,
        threadIdx.x);
  };

  if (tma && threadIdx.x == 0) {
    for (int s = 0; s <= f32::kTbStages; ++s) mbar_init(bars + s);
    fence_barrier_init();
  }
  __syncthreads();
  if (Cin == nullptr) grid_dependency_wait();
  grid_launch_dependents();
  // The panel rides in the first group (its own barrier), then kTbStages
  // - 1 slabs; slab g + kTbStages - 1 is issued in iteration g into the
  // stage slab g - 1 left, after the barrier that says every warp's reads
  // of it are done (bar.sync completes them); the issuing thread's
  // fence.proxy.async then orders the box after them.
  const int panels = (kcg + pw - 1) / pw;
  if (tma) {
    if (threadIdx.x == 0) {
      mbar_expect(panel_bar, panels * bm * pw * 4);
      for (int j = 0; j < panels; ++j)
        tma_2d(As + static_cast<size_t>(j) * bm * pw, &map_a,
               p.k0 + j * pw, row0, panel_bar);
      for (int g = 0; g < f32::kTbStages - 1 && g < total; ++g) issue(g);
    }
  } else {
    for (int j = 0; j < panels; ++j)
      stage_rows<kThreads>(As + static_cast<size_t>(j) * bm * pw,
                           RowMajor{pw},
                           A + static_cast<size_t>(row0) * p.K + p.k0 + j * pw,
                           p.K, bm, min(pw, kcg - j * pw), rows_valid,
                           kc - j * pw, mode_a, threadIdx.x);
    for (int g = 0; g < f32::kTbStages - 1; ++g) {
      if (g < total) issue(g);
      cp_async_commit();
    }
  }
  if (Cin != nullptr) grid_dependency_wait();  // the partial it wrote
  if (tma) mbar_wait(panel_bar, 0);
  const bool live = ty < rows_valid;  // rows past M chain nothing
  float acc[kR][kC];
  for (int g = 0; g < total; ++g) {
    const int t = t_begin + g / slabs, s = g % slabs;
    if (s == 0) {  // from zeros, or from the stored partial
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          const int r = ty + ty_n * i, col = t * bn + tx * kC + j;
          acc[i][j] = Cin != nullptr && r < rows_valid && col < p.N
                          ? Cin[static_cast<size_t>(row0 + r) * p.N + col]
                          : 0.0f;
        }
    }
    if (tma)
      mbar_wait(bars + g % f32::kTbStages, (g / f32::kTbStages) & 1);
    else
      cp_async_wait<f32::kTbStages - 2>();
    __syncthreads();
    if (g + f32::kTbStages - 1 < total && (!tma || threadIdx.x == 0)) {
      if (tma) fence_proxy_async();
      issue(g + f32::kTbStages - 1);
    }
    if (!tma) cp_async_commit();
    if (live) {
      const int k = s * ks;  // within one panel: ks divides pw or pw >= kc
      f32::chain_steps<kR, kC>(
          acc, As + static_cast<size_t>(k / pw) * bm * pw + ty * pw + k % pw,
          ty_n * pw,
          Bs + static_cast<size_t>(g % f32::kTbStages) * ks * bn + tx * kC,
          bn, (min(ks, kc - k) + kG - 1) & ~(kG - 1));
    }
    if (!live || s + 1 < slabs) continue;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = ty + ty_n * i;
      if (r >= rows_valid) continue;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int col = t * bn + tx * kC + j;
        if (col >= p.N) continue;
        const size_t at = static_cast<size_t>(row0 + r) * p.N + col;
        if (kFinal)
          store_out(o.c, at,
                    f32::flush(acc[i][j], o.scale, o.bias, o.res,
                               p.res_dtype, p.act, col, at),
                    p.out_dtype, o.out_scale);
        else
          Cacc[at] = acc[i][j];
      }
    }
  }
}

template <int kR, int kC, bool kFinal, typename TB>
int launch_f32_shape(const TbOperands& o, const TbArgs& p, size_t smem,
                     cudaStream_t stream) {
  auto kernel = gemm_tb_f32_kernel<kR, kC, kFinal, TB>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxSmem);
    configured = true;
  }
  // tensor maps where A and B are f32 with whole 16-byte rows (copy mode
  // 2): A in boxes of a panel's columns x bm rows, B in a stage's rows
  const int ks = f32::tb_stage_rows(p.bn, sizeof(TB));
  CUtensorMap ma{}, mb{};
  const int tma =
      sizeof(TB) == 4 && (p.modes & 3) == 2 && ((p.modes >> 2) & 3) == 2 &&
      tensor_map_2d_cached(&ma, o.a, 4, p.M, p.K, p.K,
                           f32::tb_panel_cols(p.bk), p.bm) &&
      tensor_map_2d_cached(&mb, o.b, 4, p.K, p.N, p.N, p.bn, ks);
  const int n_tiles = (p.N + p.bn - 1) / p.bn;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_tiles + p.tiles_per_cta - 1) / p.tiles_per_cta,
                     (p.M + p.bm - 1) / p.bm);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, ma, mb, o, p, tma));
}

__host__ __device__ constexpr bool pow2(int x) {
  return x > 0 && (x & (x - 1)) == 0;
}

// The f32 body's rule (core/hardware.py HopperChip._launchable_f32): bm
// and bn powers of two, 8 <= bm <= 128, 32 <= bn <= 256, 1 to kMaxChains
// chains a thread, min(4, chains) of them columns.
template <typename TB, bool kFinal>
int launch_f32(const TbOperands& o, const TbArgs& p, size_t smem,
               cudaStream_t stream) {
  const int chains = p.bm * p.bn / kThreads;
  if (!pow2(p.bm) || !pow2(p.bn) || p.bm < 8 || p.bm > 128 || p.bn < 32 ||
      p.bn > 256 || chains < 1 || chains > kMaxChains)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cols = chains < 4 ? chains : 4;
  switch (chains / cols * 10 + cols) {
    case 11:
      return launch_f32_shape<1, 1, kFinal, TB>(o, p, smem, stream);
    case 12:
      return launch_f32_shape<1, 2, kFinal, TB>(o, p, smem, stream);
    case 14:
      return launch_f32_shape<1, 4, kFinal, TB>(o, p, smem, stream);
    case 24:
      return launch_f32_shape<2, 4, kFinal, TB>(o, p, smem, stream);
    default:
      return launch_f32_shape<4, 4, kFinal, TB>(o, p, smem, stream);
  }
}

template <bool kFinal, int kV>
int launch_tc(const TbOperands& o, const TbArgs& p, size_t smem,
              cudaStream_t stream) {
  const int blocks = (p.bm + 15) / 16, frags = (p.bn + 7) / 8;
  if constexpr (kV != kVW8A16) {  // (W8A16 takes fragments in pairs)
    if (blocks * frags <= kWarps)
      return launch_mma<1, kFinal, kV>(o, p, smem, stream);
  }
  if (blocks * ((frags + 1) / 2) <= kWarps)
    return launch_mma<2, kFinal, kV>(o, p, smem, stream);
  if (blocks * ((frags + kMaxFrags - 1) / kMaxFrags) <= kWarps)
    return launch_mma<kMaxFrags, kFinal, kV>(o, p, smem, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 body: gemm_ws.cuh's, at the shape a plan tile maps to.  A tile
// of at most 16 rows runs the mma.sync form (16 rows, bn rounded up to a
// power of two from 8 to 256); any other runs one consumer warpgroup on
// wgmma for up to 64 rows, two for up to 128, at N = 64, 128 or 256 (the
// least that covers bn).  The columns past bn are loaded, multiplied and
// not stored.  ws_stages stages of B.
__host__ __device__ inline int ws_rows(int bm) {
  return bm <= 16 ? 16 : bm <= 64 ? 64 : 128;
}
__host__ __device__ inline int ws_cols(int bm, int bn) {
  int cols = bm <= 16 ? 8 : 64;
  while (cols < bn) cols *= 2;
  return cols;
}
__host__ __device__ inline int ws_stages(int bm, int bn) {
  if (bm > 16) return ws::kTbStages;
  const int stages = ws::kTbRingBytes / (ws::kBK * ws_cols(bm, bn) * 2);
  return stages < ws::kTbStages  ? ws::kTbStages
         : stages > ws::kMaxStages ? ws::kMaxStages
                                   : stages;
}
__host__ __device__ inline size_t ws_smem(int bm, int bk, int bn) {
  const int rows = ws_rows(bm);
  const size_t stage = static_cast<size_t>(ws::kBK) * ws_cols(bm, bn) * 2;
  return static_cast<size_t>((bk + ws::kBK - 1) / ws::kBK) * rows * 128 +
         ws_stages(bm, bn) * stage + static_cast<size_t>(rows) * bn * 4;
}

template <typename S, bool kFinal>
int launch_ws_shape(const TbOperands& o, const TbArgs& t,
                    cudaStream_t stream) {
  ws::Args p{};
  p.M = t.M, p.N = t.N, p.K = t.K, p.k0 = t.k0, p.kc = t.kc, p.bk = t.bk;
  p.bm = t.bm, p.bn = t.bn, p.tiles_per_cta = t.tiles_per_cta;
  p.stages = ws_stages(t.bm, t.bn);
  p.act = t.act, p.out_dtype = t.out_dtype, p.res_dtype = t.res_dtype;
  p.mode_a = t.modes & 3, p.mode_b = (t.modes >> 2) & 3;
  p.mode_c = (t.modes >> 4) & 3;
  const ws::Operands w{static_cast<const __nv_bfloat16*>(o.a),
                       static_cast<const __nv_bfloat16*>(o.b),
                       static_cast<const float*>(o.cin),
                       kFinal ? o.c : o.cacc,
                       o.bias,
                       o.res,
                       o.out_scale};
  return ws::launch<S, true, kFinal>(w, p, stream);
}

// The shapes (one consumer warpgroup, two, and the mma.sync form), compiled
// in three translation units that build in parallel: gemm_tb_ws1.cu,
// gemm_tb_ws2.cu and gemm_tb_wsd.cu.
using Ws1x64 = ws::Shape<1, 64, 0>;
using Ws1x128 = ws::Shape<1, 128, 0>;
using Ws1x256 = ws::Shape<1, 256, 0>;
using Ws2x64 = ws::Shape<2, 64, 0>;
using Ws2x128 = ws::Shape<2, 128, 0>;
using Ws2x256 = ws::Shape<2, 256, 0>;
using WsM8 = ws::Shape<1, 8, 0, true>;
using WsM16 = ws::Shape<1, 16, 0, true>;
using WsM32 = ws::Shape<1, 32, 0, true>;
using WsM64 = ws::Shape<1, 64, 0, true>;
using WsM128 = ws::Shape<1, 128, 0, true>;
using WsM256 = ws::Shape<1, 256, 0, true>;
#define REPRO_TB_WS_EXTERN(S)                                             \
  extern template int launch_ws_shape<S, false>(const TbOperands&,       \
                                                const TbArgs&,           \
                                                cudaStream_t);           \
  extern template int launch_ws_shape<S, true>(const TbOperands&,        \
                                               const TbArgs&, cudaStream_t);
REPRO_TB_WS_EXTERN(Ws1x64)
REPRO_TB_WS_EXTERN(Ws1x128)
REPRO_TB_WS_EXTERN(Ws1x256)
REPRO_TB_WS_EXTERN(Ws2x64)
REPRO_TB_WS_EXTERN(Ws2x128)
REPRO_TB_WS_EXTERN(Ws2x256)
REPRO_TB_WS_EXTERN(WsM8)
REPRO_TB_WS_EXTERN(WsM16)
REPRO_TB_WS_EXTERN(WsM32)
REPRO_TB_WS_EXTERN(WsM64)
REPRO_TB_WS_EXTERN(WsM128)
REPRO_TB_WS_EXTERN(WsM256)
#undef REPRO_TB_WS_EXTERN
#define REPRO_TB_WS_DEFINE(S)                                             \
  template int launch_ws_shape<S, false>(const TbOperands&, const TbArgs&, \
                                         cudaStream_t);                  \
  template int launch_ws_shape<S, true>(const TbOperands&, const TbArgs&,  \
                                        cudaStream_t);

template <bool kFinal>
int launch_ws(const TbOperands& o, const TbArgs& p, cudaStream_t s) {
  if (p.bm < 1 || p.bm > 128 || p.bn < 1 || p.bn > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (ws_rows(p.bm) * 1000 + ws_cols(p.bm, p.bn)) {
    case 16008:
      return launch_ws_shape<WsM8, kFinal>(o, p, s);
    case 16016:
      return launch_ws_shape<WsM16, kFinal>(o, p, s);
    case 16032:
      return launch_ws_shape<WsM32, kFinal>(o, p, s);
    case 16064:
      return launch_ws_shape<WsM64, kFinal>(o, p, s);
    case 16128:
      return launch_ws_shape<WsM128, kFinal>(o, p, s);
    case 16256:
      return launch_ws_shape<WsM256, kFinal>(o, p, s);
    case 64064:
      return launch_ws_shape<Ws1x64, kFinal>(o, p, s);
    case 64128:
      return launch_ws_shape<Ws1x128, kFinal>(o, p, s);
    case 64256:
      return launch_ws_shape<Ws1x256, kFinal>(o, p, s);
    case 128064:
      return launch_ws_shape<Ws2x64, kFinal>(o, p, s);
    case 128128:
      return launch_ws_shape<Ws2x128, kFinal>(o, p, s);
    default:
      return launch_ws_shape<Ws2x256, kFinal>(o, p, s);
  }
}

// The int8 and f32 bodies are compiled in their own translation units
// (gemm_tb_w8a16.cu, gemm_tb_w8a8.cu, gemm_tb_f32.cu, gemm_tb_f32w8.cu),
// in parallel with gemm_tb.cu.
extern template int launch_tc<false, kVW8A16>(const TbOperands&,
                                              const TbArgs&, size_t,
                                              cudaStream_t);
extern template int launch_tc<true, kVW8A16>(const TbOperands&,
                                             const TbArgs&, size_t,
                                             cudaStream_t);
extern template int launch_tc<false, kVW8A8>(const TbOperands&,
                                             const TbArgs&, size_t,
                                             cudaStream_t);
extern template int launch_tc<true, kVW8A8>(const TbOperands&, const TbArgs&,
                                            size_t, cudaStream_t);
extern template int launch_f32<float, false>(const TbOperands&,
                                             const TbArgs&, size_t,
                                             cudaStream_t);
extern template int launch_f32<float, true>(const TbOperands&,
                                            const TbArgs&, size_t,
                                            cudaStream_t);
extern template int launch_f32<int8_t, false>(const TbOperands&,
                                              const TbArgs&, size_t,
                                              cudaStream_t);
extern template int launch_f32<int8_t, true>(const TbOperands&,
                                             const TbArgs&, size_t,
                                             cudaStream_t);

}  // namespace tb
}  // namespace repro
