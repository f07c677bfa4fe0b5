// The f32 bodies of kernels B1 (gemm_aie) and B6 (gemm_tb) for Hopper: one
// fmaf chain a C element, on the CUDA cores.  This header holds the chain
// both run and B1's kernel; B6's A-stationary kernel is in gemm_tb.cuh.
//
// Replaces: the f32 operand path of repro/kernels/gemm_aie.py gemm_aie
// (pallas_call at :143, body _gemm_aie_kernel at :38) and of
// repro/kernels/gemm_tb.py gemm_tb (pallas_call at :96 and :139, bodies
// _gemm_tb_kernel :52 and _gemm_tb_final_kernel :65): C = epilogue(A B)
// with an f32 A and an f32 or int8 B (W8A16 on f32 activations: B widened
// exactly as it is read), the b_scale, bias, activation, residual and
// out-quant on the flush (common.cuh epilogue, store_out).  The served
// callers are the MoE routers (models/moe.py, f32 out) and the f32 models.
//
// The order: every C element is one chain acc_{k+1} = fmaf(A[r,k], B[k,c],
// acc_k) over k ascending, from 0 (B1, B6's first chunk) or from B6's
// stored f32 partial; no split of k, no tree, no tensor cores (TF32 keeps
// 10 bits of the mantissa).  B7's f32 body (gemm_grouped.cu) runs the same
// chain, so its rows, B6's and B1's agree bit for bit, and a row's bits
// depend neither on m nor on the CTA shape (continuous == solo greedy for
// the MoE models).  Slabs are zero-filled past K to the 4-grid of the k
// steps: fmaf(0, 0, acc) is acc, so the padding keeps the chain's bits.
//
// What bounds it on an H100: at decode the chain itself, k dependent fmaf
// at their latency (tools/hopper_probe.cu probe 6), far above the bytes of
// B; with many rows the f32 pipe (67 TFLOP/s).  The design:
//   * a thread keeps kR rows x kC columns of chains, reads four k steps of
//     each of its rows of A as one 16-byte vector and its kC columns of B
//     a k step as one vector: a k step costs kR kC fmaf and kR / 4 + 1
//     shared reads, so at decode a thread's one chain leaves issue slots
//     to spare, and at many rows (8 x 4) fmaf outnumber reads ten to one;
//   * B1's grid spreads B at decode: up to 64 rows a CTA is two warps of
//     8 rows x 8 columns, one chain a thread, so a 128-column router weight
//     streams through 16 SMs in boxes of 32-byte rows; with more rows, four
//     warps of 8 to 64 x 64 (kernels/gemm_aie.py F32_TILES, _f32_config);
//   * the chain reads its k steps in groups (32 steps for one chain down to
//     4 for eight or more), the next group while the fmaf of this one run;
//     the compiler still places many reads a few instructions before their
//     fmaf, so on the card one chain steps at 7.3 cycles, not the fmaf's
//     4.06 (probe 6), and that, not the bytes, bounds the decode shapes;
//   * operands arrive in rings of stages: one thread issues tensor-memory-
//     accelerator boxes onto an mbarrier a stage where A and B are f32
//     with rows of whole 16-byte units (probe 6: about 300 cycles a box up
//     to 16 KiB, so slabs are deep), else every thread copies by cp.async
//     (16 bytes, 4, or plain loads); B1 streams A's and B's slabs, B6 keeps
//     its A panel and streams B.
#pragma once

#include "staging.cuh"
#include "tma.cuh"

namespace repro {
namespace f32 {

// kC consecutive values of a B row at p, widened to f32 (an int8 B exactly).
template <int kC>
__device__ __forceinline__ void load_cols(const float* p, float* v) {
  if constexpr (kC == 1) {
    v[0] = p[0];
  } else if constexpr (kC == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  } else {
    static_assert(kC == 4, "1, 2 or 4 columns a thread");
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
}
template <int kC>
__device__ __forceinline__ void load_cols(const int8_t* p, float* v) {
  if constexpr (kC == 1) {
    v[0] = static_cast<float>(p[0]);
  } else if constexpr (kC == 2) {
    const char2 x = *reinterpret_cast<const char2*>(p);
    v[0] = static_cast<float>(x.x), v[1] = static_cast<float>(x.y);
  } else {
    static_assert(kC == 4, "1, 2 or 4 columns a thread");
    const char4 x = *reinterpret_cast<const char4*>(p);
    v[0] = static_cast<float>(x.x), v[1] = static_cast<float>(x.y);
    v[2] = static_cast<float>(x.z), v[3] = static_cast<float>(x.w);
  }
}

// k steps a group of chain_steps: 32 where a thread keeps one chain, 16
// for two, 8 for four, 4 beyond (the registers of two groups in flight
// stay under ~130).  The compiler issues a group's shared-memory reads a
// few instructions ahead of their fmaf, so a read's latency is paid once
// a group: a long group makes it small beside the chain's k x 4 cycles
// (probe 6: one chain read 8 k steps a group at 8.7 cycles a step).
// Depths and zero fills are on the 32-grid.
template <int kR, int kC>
constexpr int kGroup = kR * kC == 1 ? 32 : kR * kC == 2 ? 16
                                         : kR * kC == 4 ? 8 : 4;
constexpr int kGrid = 32;

// A group of kG k steps: the thread's rows of A (16-byte reads) and kG rows
// of its columns of B.
template <int kG, int kR, int kC, typename TB>
__device__ __forceinline__ void load_group(float (&av)[kR][kG],
                                           float (&bv)[kG][kC],
                                           const float* a, int a_step,
                                           const TB* b, int ldb) {
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int g = 0; g < kG; g += 4) load4(a + i * a_step + g, &av[i][g]);
#pragma unroll
  for (int q = 0; q < kG; ++q) load_cols<kC>(b + q * ldb, bv[q]);
}

// One thread's chains over ``depth`` k steps (a multiple of 8), in order:
// acc[i][j] = fmaf(A_i[kk], B[kk][j], acc[i][j]) for kk = 0 .. depth - 1.
// a: the thread's first row of A at the first step, its row i at a + i *
// a_step (16-byte aligned); b: B's row of the first step at the thread's
// first column, the row of step kk at b + kk * ldb.  The next group is
// read, unconditionally (the last group reads itself again), before this
// one's fmaf, so the reads' latency hides behind the chain.
template <int kR, int kC, typename TB>
__device__ __forceinline__ void chain_steps(float (&acc)[kR][kC],
                                            const float* a, int a_step,
                                            const TB* b, int ldb,
                                            int depth) {
  constexpr int kG = kGroup<kR, kC>;
  float av[kR][kG], bv[kG][kC];
  load_group<kG>(av, bv, a, a_step, b, ldb);
#pragma unroll 2
  for (int kk = 0; kk < depth; kk += kG) {
    const int next = kk + kG < depth ? kk + kG : kk;
    float an[kR][kG], bn[kG][kC];
    load_group<kG>(an, bn, a + next, a_step, b + next * ldb, ldb);
#pragma unroll
    for (int q = 0; q < kG; ++q)
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j)
          acc[i][j] = fmaf(av[i][q], bv[q][j], acc[i][j]);
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int q = 0; q < kG; ++q) av[i][q] = an[i][q];
#pragma unroll
    for (int q = 0; q < kG; ++q)
#pragma unroll
      for (int j = 0; j < kC; ++j) bv[q][j] = bn[q][j];
  }
}

// The flushed value of one chain: b_scale, bias, activation, residual (f32
// or bf16, res_dtype) read from device memory at C's element ``at``.
__device__ __forceinline__ float flush(float acc, const float* scale,
                                       const float* bias, const void* res,
                                       int res_dtype, int act, int col,
                                       size_t at) {
  float rv = 0.0f;
  if (res != nullptr)
    rv = res_dtype == kBF16
             ? to_f32(static_cast<const __nv_bfloat16*>(res)[at])
             : static_cast<const float*>(res)[at];
  return epilogue(dequant(acc, scale, col), bias != nullptr,
                  bias != nullptr ? bias[col] : 0.0f, act, res != nullptr,
                  rv);
}

// ---------------------------------------------------------------------------
// B1's output-stationary f32 kernel
// ---------------------------------------------------------------------------

// A CTA shape of B1's f32 kernel (kernels/gemm_aie.py F32_TILES,
// F32_CHAINS and F32_STAGES, by config): a kBM x kBN tile of C; kTY x kTX
// threads, thread (ty, tx) keeping rows ty + kTY i (i < kR) and columns
// tx kC + j (j < kC); a ring of kStages kKS-deep stages, each A's kBM x
// kKS slab and B's kKS x kBN slab at B's width, then one mbarrier a stage.
// A slab is deep (256 steps at decode, 64 beyond): a tensor-memory-
// accelerator box costs about 300 cycles whatever its size up to 16 KiB
// (probe 6), so two boxes a slab stay under its products, and kStages - 1
// slabs in flight cover a device-memory round trip.
template <int kBM_, int kBN_, int kR_, int kC_, int kKS_, int kStages_>
struct AieShape {
  static constexpr int kBM = kBM_, kBN = kBN_, kR = kR_, kC = kC_;
  static constexpr int kKS = kKS_, kStages = kStages_;
  static constexpr int kTY = kBM / kR, kTX = kBN / kC;
  static constexpr int kThreads = kTX * kTY;
  static constexpr int kLda = kKS;
  static constexpr int kABytes = kBM * kLda * 4;
  static_assert(kThreads % 32 == 0 && kKS % kGrid == 0,
                "whole warps, slabs on the 32-grid");
  template <typename TB>
  __host__ __device__ static constexpr int b_bytes() {
    return (kKS * kBN * static_cast<int>(sizeof(TB)) + 15) & ~15;
  }
  template <typename TB>
  __host__ __device__ static constexpr int stage_bytes() {
    return kABytes + b_bytes<TB>();
  }
  template <typename TB>
  __host__ __device__ static constexpr int smem() {
    return kStages * (stage_bytes<TB>() + 8);  // stages, then mbarriers
  }
};

struct AieArgs {
  int M, N, K, act;
  int out_dtype, res_dtype;  // C's and the residual's type (DType)
  int mode_a, mode_b;        // staging.cuh copy modes of A and B
  int tma;                   // 1: the stages are filled by tensor maps
};

struct AieOperands {
  const float* a;
  const void* b;
  void* c;
  const float *bias, *scale;
  const void* res;
  const float* out_scale;
};

template <typename S, typename TB>
__global__ void __launch_bounds__(S::kThreads)
gemm_aie_f32_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const float* __restrict__ A, const TB* __restrict__ B,
                    void* __restrict__ C, const float* __restrict__ bias,
                    const float* __restrict__ scale, const void* res,
                    const float* __restrict__ out_scale, AieArgs p) {
  // (a tensor copy lands on a 128-byte-aligned address)
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kStage = S::template stage_bytes<TB>();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kStages * kStage);
  const int tid = threadIdx.x;
  const int tx = tid % S::kTX, ty = tid / S::kTX;
  const int row0 = blockIdx.y * S::kBM, col0 = blockIdx.x * S::kBN;
  const int rows_valid = min(S::kBM, p.M - row0);
  const int cols_valid = min(S::kBN, p.N - col0);
  const int slabs = (p.K + S::kKS - 1) / S::kKS;
  // slab i: A's kBM x kKS slab and B's kKS x kBN slab into stage i % S,
  // zero past K, M and N: two boxes issued by thread 0, or every thread's
  // cp.async copies
  auto load = [&](int slab) {
    unsigned char* st = smem + (slab % S::kStages) * kStage;
    const int k0 = slab * S::kKS;
    if (p.tma) {
      uint64_t* bar = full + slab % S::kStages;
      mbar_expect(bar, kStage);
      tma_2d(st, &map_a, k0, row0, bar);
      tma_2d(st + S::kABytes, &map_b, col0, k0, bar);
      return;
    }
    const int depth = min(S::kKS, p.K - k0);
    stage_rows<S::kThreads>(reinterpret_cast<float*>(st), RowMajor{S::kLda},
                            A + static_cast<size_t>(row0) * p.K + k0, p.K,
                            S::kBM, S::kKS, rows_valid, depth, p.mode_a, tid);
    stage_rows<S::kThreads>(reinterpret_cast<TB*>(st + S::kABytes),
                            RowMajor{S::kBN},
                            B + static_cast<size_t>(k0) * p.N + col0, p.N,
                            S::kKS, S::kBN, depth, cols_valid, p.mode_b, tid);
  };
  float acc[S::kR][S::kC];
#pragma unroll
  for (int i = 0; i < S::kR; ++i)
#pragma unroll
    for (int j = 0; j < S::kC; ++j) acc[i][j] = 0.0f;

  if (p.tma && tid == 0) {
    for (int s = 0; s < S::kStages; ++s) mbar_init(full + s);
    fence_barrier_init();
  }
  __syncthreads();
  // The ring: kStages - 1 slabs in flight before the first products;
  // slab i + kStages - 1 is issued in iteration i, into the stage slab
  // i - 1 left, after the barrier that says every warp's reads of it are
  // done (bar.sync completes them); the issuing thread's fence.proxy.async
  // then orders the box after them.
  for (int s = 0; s < S::kStages - 1; ++s) {
    if (s < slabs && (!p.tma || tid == 0)) load(s);
    if (!p.tma) cp_async_commit();
  }
  const bool live = ty < rows_valid;  // rows past M chain nothing
  for (int i = 0; i < slabs; ++i) {
    if (p.tma)
      mbar_wait(full + i % S::kStages, (i / S::kStages) & 1);
    else
      cp_async_wait<S::kStages - 2>();
    __syncthreads();
    if (i + S::kStages - 1 < slabs && (!p.tma || tid == 0)) {
      if (p.tma) fence_proxy_async();
      load(i + S::kStages - 1);
    }
    if (!p.tma) cp_async_commit();
    if (live) {
      const unsigned char* st = smem + (i % S::kStages) * kStage;
      const int depth =
          (min(S::kKS, p.K - i * S::kKS) + kGrid - 1) & ~(kGrid - 1);
      chain_steps<S::kR, S::kC>(
          acc, reinterpret_cast<const float*>(st) + ty * S::kLda,
          S::kTY * S::kLda,
          reinterpret_cast<const TB*>(st + S::kABytes) + tx * S::kC, S::kBN,
          depth);
    }
  }

  if (!live) return;
#pragma unroll
  for (int i = 0; i < S::kR; ++i) {
    const int r = ty + S::kTY * i;
    if (r >= rows_valid) continue;
#pragma unroll
    for (int j = 0; j < S::kC; ++j) {
      const int col = col0 + tx * S::kC + j;
      if (col >= p.N) continue;
      const size_t at = static_cast<size_t>(row0 + r) * p.N + col;
      store_out(C, at,
                flush(acc[i][j], scale, bias, res, p.res_dtype, p.act, col,
                      at),
                p.out_dtype, out_scale);
    }
  }
}

template <typename S, typename TB>
int launch_aie_shape(const AieOperands& o, AieArgs p, cudaStream_t stream) {
  auto kernel = gemm_aie_f32_kernel<S, TB>;
  constexpr int kSmem = S::template smem<TB>();
  static bool configured = false;  // one attribute call per shape
  if (!configured) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmem);
    configured = true;
  }
  // tensor maps where A and B are f32 with whole 16-byte rows (copy mode
  // 2)
  CUtensorMap ma{}, mb{};
  p.tma = sizeof(TB) == 4 && p.mode_a == 2 && p.mode_b == 2 &&
          tensor_map_2d_cached(&ma, o.a, 4, p.M, p.K, p.K, S::kLda, S::kBM) &&
          tensor_map_2d_cached(&mb, o.b, 4, p.K, p.N, p.N, S::kBN, S::kKS);
  dim3 grid(cdiv(p.N, S::kBN), cdiv(p.M, S::kBM));
  kernel<<<grid, S::kThreads, kSmem, stream>>>(
      ma, mb, o.a, static_cast<const TB*>(o.b), o.c, o.bias, o.scale, o.res,
      o.out_scale, p);
  return static_cast<int>(cudaGetLastError());
}

// B1's f32 shapes by the config index kernels/gemm_aie.py F32_TILES gives
// them ((bm, bk, bn) there is (kBM, kKS, kBN) here, F32_CHAINS (kR, kC)):
// two warps of 4 rows x 8 columns for few rows (1: an 8-lane phase of a
// warp reads one row of A, so 1 KiB rows take no bank conflict), four warps
// of 2 x 16 for more (2 .. 5); 6 stages, fewer where a stage is large.
template <typename TB>
int launch_aie(int config, const AieOperands& o, const AieArgs& p,
               cudaStream_t s) {
  switch (config) {
    case 1:
      return launch_aie_shape<AieShape<8, 8, 1, 1, 256, 6>, TB>(o, p, s);
    case 2:
      return launch_aie_shape<AieShape<8, 64, 1, 4, 64, 6>, TB>(o, p, s);
    case 3:
      return launch_aie_shape<AieShape<16, 64, 2, 4, 64, 4>, TB>(o, p, s);
    case 4:
      return launch_aie_shape<AieShape<32, 64, 4, 4, 64, 4>, TB>(o, p, s);
    case 5:
      return launch_aie_shape<AieShape<64, 64, 8, 4, 64, 3>, TB>(o, p, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Compiled in gemm_aie_f32.cu (f32 B) and gemm_aie_f32w8.cu (int8 B), in
// parallel with gemm_aie.cu.
extern template int launch_aie<float>(int, const AieOperands&,
                                      const AieArgs&, cudaStream_t);
extern template int launch_aie<int8_t>(int, const AieOperands&,
                                       const AieArgs&, cudaStream_t);

// ---------------------------------------------------------------------------
// B6's shared memory (its kernel: gemm_tb.cuh gemm_tb_f32_kernel)
// ---------------------------------------------------------------------------

// B6's ring: kTbStages stages of kTbStageBytes of B's rows each
// (core/hardware.py B6_F32_STAGES, B6_F32_STAGE_BYTES): 96 KiB in all, one
// box a stage (128 rows of a 32-column tile).
constexpr int kTbStages = 6;
constexpr int kTbStageBytes = 16384;
// The widest panel box: B6's resident A panel is held as panels of this
// many columns (a tensor map's box is at most 256 elements a side).
constexpr int kTbPanelCols = 256;

// B's rows a stage for a bn-column tile of b-byte elements: a stage's bytes,
// at most a panel's columns (a slab never straddles two panels).
__host__ __device__ inline int tb_stage_rows(int bn, int b) {
  const int rows = kTbStageBytes / (bn * b);
  return rows < kTbPanelCols ? rows : kTbPanelCols;
}

// The columns of one panel of a chunk kc deep: the chunk on the 32-grid,
// at most kTbPanelCols.
__host__ __device__ inline int tb_panel_cols(int bk) {
  const int cols = (bk + kGrid - 1) & ~(kGrid - 1);
  return cols < kTbPanelCols ? cols : kTbPanelCols;
}

// The resident A panel: bm rows of each of cdiv(bk, panel) panels.
__host__ __device__ inline size_t tb_panel_bytes(int bm, int bk) {
  const int pw = tb_panel_cols(bk);
  return static_cast<size_t>(bm) * pw * ((bk + pw - 1) / pw) * 4;
}

// One CTA's dynamic shared memory: the panel, the ring and the mbarriers
// (one a stage, one for the panel): what core/memory_model.py bills an f32
// 'tb' tile on HOPPER_H100.
__host__ __device__ inline size_t tb_smem(int bm, int bk) {
  return tb_panel_bytes(bm, bk) +
         static_cast<size_t>(kTbStages) * kTbStageBytes +
         (kTbStages + 1) * 8;
}

}  // namespace f32
}  // namespace repro
