// gemm_tb — the A-stationary GEMM with the fused epilogue on its last
// k-chunk (kernel B6), for Hopper.
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
// Here a CTA owns a (bm x kc) panel of A, staged once into shared memory,
// and sweeps a contiguous range of n tiles; each m-block's sweep is split
// over several CTAs, each with its own copy of the panel, so the grid fills
// the card even at m = 8.  Per n tile the CTA streams one (kc x bn) tile of
// B and the (bm x bn) f32 partial (plus the bias and residual tiles on the
// last chunk) through two cp.async stages, so the next tile's loads are in
// flight during this tile's products.  The dynamic shared memory is
// tb_layout below, sized from the plan's (bm, bk, bn): exactly what
// core/memory_model.py bills a 'tb' tile on HOPPER_H100.
//   bf16 operands (gemm_tb_mma_kernel): the products are mma_chain.cuh's
//   tensor-core chain.  The C tile is cdiv(bm, 16) x cdiv(bn, 8) m16n8
//   fragments; each of the 8 warps owns kFN (1, 2 or 4) neighbouring
//   fragments of one 16-row block and walks the whole chunk for them,
//   reading the resident panel and the streamed B stage (both XOR-swizzled,
//   mma_chain.cuh SmemTile) through ldmatrix.  Its accumulators start from
//   the staged f32 partial, so the partial is the first MMA's C operand.
//   Its chunks launch as programmatic dependents (launch_mma): a chunk's
//   CTAs stage the panel and their first B tile while the chunk before
//   runs, and wait for that chunk only before its partial.
//   f32 operands (gemm_tb_kernel): the CUDA-core body, a thread owning one
//   C column and up to 16 rows, one fmaf chain over the chunk.
// Ragged edges (m, n and the last chunk of k) are zero-filled or skipped,
// so no caller pads.
//
// Order invariance: every C element is one chain over k = 0..K-1 (B1's:
// the tensor-core chain for bf16, the fmaf chain for f32): chunk 0 starts
// from 0, each later chunk continues from the stored f32 partial (the store
// and load are exact, and the host puts bf16 chunk boundaries on the
// 16-grid), and the flush is the one kernel B1 runs (common.cuh epilogue).
// gemm_tb therefore equals gemm_aie bit for bit at any tile, chunk count
// and n split, and the planner may switch dataflow with the batch size
// without changing a token.
#include "mma_chain.cuh"
#include "staging.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;     // core/hardware.py B6_THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;      // core/hardware.py B6_MAX_ROWS_PER_THREAD
constexpr int kMaxFrags = 4;      // core/hardware.py B6_MAX_FRAGS_PER_WARP
constexpr int kMaxSmem = 232448;  // 227 KiB: one CTA's limit on sm_90

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Byte offsets of the shared-memory regions of one CTA: the resident A
// panel, two B stages, two f32 partial-C stages, two bias and two residual
// stages (the last two only when the plan's epilogue has them).
struct TbLayout {
  size_t a, b, c, bias, res, total;
};

__host__ __device__ inline TbLayout tb_layout(int bm, int bk, int bn,
                                              int in_size, int res_size,
                                              bool has_bias, bool has_res) {
  TbLayout L;
  L.a = 0;
  L.b = align16(static_cast<size_t>(bm) * bk * in_size);
  L.c = L.b + align16(2 * static_cast<size_t>(bk) * bn * in_size);
  L.bias = L.c + align16(2 * static_cast<size_t>(bm) * bn * 4);
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
  int out_dtype, res_dtype;  // B6b's C and residual types (kF32 / kBF16)
  int modes;           // 2 bits an operand: A, B, C, bias, residual
};

// The f32 body.  kFinal false: B6a, writes the f32 partial to Cacc.
// kFinal true: B6b, applies the epilogue and writes C at the out dtype
// (p.out_dtype; the residual's p.res_dtype).  Cin is the partial of the earlier chunks (null
// on the first chunk); Cin and Cacc may alias: a CTA reads each partial
// tile before it writes that tile, and no two CTAs share a tile.  kRows is
// the most C rows a thread owns (cdiv(bm, 256 / bn) rounded up to a power
// of two), so the row loops below unroll to exactly the rows in use.
template <typename TIn, int kRows, bool kFinal>
__global__ void __launch_bounds__(kThreads)
gemm_tb_kernel(const TIn* __restrict__ A, const TIn* __restrict__ B,
               const float* Cin, float* Cacc, void* C,
               const float* __restrict__ bias, const void* res, TbArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int res_size = p.res_dtype == kBF16 ? 2 : 4;
  const TbLayout L = tb_layout(p.bm, p.bk, p.bn, sizeof(TIn), res_size,
                               bias != nullptr, res != nullptr);
  TIn* As = reinterpret_cast<TIn*>(smem + L.a);
  TIn* Bs = reinterpret_cast<TIn*>(smem + L.b);
  float* Cs = reinterpret_cast<float*>(smem + L.c);
  float* Bias_s = reinterpret_cast<float*>(smem + L.bias);
  unsigned char* Rs = smem + L.res;

  const int bm = p.bm, bn = p.bn, kc = p.kc;
  const int n_tiles = (p.N + bn - 1) / bn;
  const int t_begin = blockIdx.x * p.tiles_per_cta;
  const int t_end = min(n_tiles, t_begin + p.tiles_per_cta);
  if (t_begin >= t_end) return;  // the whole CTA
  const int row0 = blockIdx.y * bm;
  const int rows_valid = min(bm, p.M - row0);
  const int groups = kThreads / bn;  // row groups of bn threads
  const int tx = threadIdx.x % bn, ty = threadIdx.x / bn;
  // rows r = ty, ty + groups, ... < bm of this thread (0 for idle threads)
  const int my_rows = ty < groups ? max(0, (bm - ty + groups - 1) / groups)
                                  : 0;
  const int mode_a = p.modes & 3, mode_b = (p.modes >> 2) & 3,
            mode_c = (p.modes >> 4) & 3, mode_bias = (p.modes >> 6) & 3,
            mode_r = (p.modes >> 8) & 3;
  const size_t tile_b = static_cast<size_t>(p.bk) * bn;
  const size_t tile_c = static_cast<size_t>(bm) * bn;

  auto issue = [&](int t, int s) {
    const int col0 = t * bn;
    const int cols_valid = min(bn, p.N - col0);
    stage<kThreads>(Bs + s * tile_b, bn,
                    B + static_cast<size_t>(p.k0) * p.N + col0, p.N, kc, bn,
                    kc, cols_valid, mode_b);
    if (Cin != nullptr)
      stage<kThreads>(Cs + s * tile_c, bn,
                      Cin + static_cast<size_t>(row0) * p.N + col0, p.N, bm,
                      bn, rows_valid, cols_valid, mode_c);
    if (kFinal && bias != nullptr)
      stage<kThreads>(Bias_s + s * bn, bn, bias + col0, 0, 1, bn, 1,
                      cols_valid, mode_bias);
    if (kFinal && res != nullptr) {
      const size_t at = static_cast<size_t>(row0) * p.N + col0;
      if (res_size == 2)
        stage<kThreads>(reinterpret_cast<__nv_bfloat16*>(Rs) + s * tile_c,
                        bn, static_cast<const __nv_bfloat16*>(res) + at, p.N,
                        bm, bn, rows_valid, cols_valid, mode_r);
      else
        stage<kThreads>(reinterpret_cast<float*>(Rs) + s * tile_c, bn,
                        static_cast<const float*>(res) + at, p.N, bm, bn,
                        rows_valid, cols_valid, mode_r);
    }
  };

  // The A panel, resident for the whole sweep, rides in the first group.
  stage<kThreads>(As, p.bk, A + static_cast<size_t>(row0) * p.K + p.k0, p.K,
                  bm, kc, rows_valid, kc, mode_a);
  issue(t_begin, 0);
  cp_async_commit();
  const bool vec_a = (p.bk & 3) == 0;  // panel rows 8/16-byte aligned
  for (int t = t_begin, s = 0; t < t_end; ++t, s ^= 1) {
    if (t + 1 < t_end) {
      issue(t + 1, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (my_rows > 0) {
      const TIn* Bt = Bs + s * tile_b;
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        acc[i] = (i < my_rows && Cin != nullptr)
                     ? Cs[s * tile_c + (ty + groups * i) * bn + tx]
                     : 0.0f;
      int kk = 0;
      if (vec_a) {
        for (; kk + 4 <= kc; kk += 4) {
          const float b0 = to_f32(Bt[(kk + 0) * bn + tx]);
          const float b1 = to_f32(Bt[(kk + 1) * bn + tx]);
          const float b2 = to_f32(Bt[(kk + 2) * bn + tx]);
          const float b3 = to_f32(Bt[(kk + 3) * bn + tx]);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            if (i < my_rows) {
              float a[4];
              load4(As + (ty + groups * i) * p.bk + kk, a);
              acc[i] = fmaf(a[0], b0, acc[i]);
              acc[i] = fmaf(a[1], b1, acc[i]);
              acc[i] = fmaf(a[2], b2, acc[i]);
              acc[i] = fmaf(a[3], b3, acc[i]);
            }
          }
        }
      }
      for (; kk < kc; ++kk) {
        const float b = to_f32(Bt[kk * bn + tx]);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          if (i < my_rows)
            acc[i] = fmaf(to_f32(As[(ty + groups * i) * p.bk + kk]), b,
                          acc[i]);
      }
      const int col = t * bn + tx;
      if (col < p.N) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int r = ty + groups * i;
          if (i >= my_rows || r >= rows_valid) continue;
          const size_t at = static_cast<size_t>(row0 + r) * p.N + col;
          if (kFinal) {
            float rv = 0.0f;
            if (res != nullptr) {
              const size_t ri = s * tile_c + r * bn + tx;
              rv = res_size == 2
                       ? to_f32(reinterpret_cast<__nv_bfloat16*>(Rs)[ri])
                       : reinterpret_cast<float*>(Rs)[ri];
            }
            const float x = epilogue(
                acc[i], bias != nullptr,
                bias != nullptr ? Bias_s[s * bn + tx] : 0.0f, p.act,
                res != nullptr, rv);
            if (p.out_dtype == kBF16)
              static_cast<__nv_bfloat16*>(C)[at] = from_f32<__nv_bfloat16>(x);
            else
              static_cast<float*>(C)[at] = x;
          } else {
            Cacc[at] = acc[i];
          }
        }
      }
    }
    __syncthreads();  // stage s is refilled by the next iteration's issue
  }
}

// The bf16 body: as gemm_tb_kernel, with the products on the tensor cores.
// The tile's cdiv(bm, 16) x cdiv(bn, 8) fragments go to the warps kFN at a
// time along a 16-row block: warp w owns block w / G, fragments
// (w % G) kFN .. +kFN of it (G = cdiv(cdiv(bn, 8), kFN)); the host picks the
// least kFN that needs at most 8 warps.
template <int kFN, bool kFinal>
__global__ void __launch_bounds__(kThreads)
gemm_tb_mma_kernel(const __nv_bfloat16* __restrict__ A,
                   const __nv_bfloat16* __restrict__ B, const float* Cin,
                   float* Cacc, void* C, const float* __restrict__ bias,
                   const void* res, TbArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int res_size = p.res_dtype == kBF16 ? 2 : 4;
  const TbLayout L = tb_layout(p.bm, p.bk, p.bn, 2, res_size,
                               bias != nullptr, res != nullptr);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + L.b);
  float* Cs = reinterpret_cast<float*>(smem + L.c);
  float* Bias_s = reinterpret_cast<float*>(smem + L.bias);
  unsigned char* Rs = smem + L.res;
  const SmemTile Ap =
      smem_tile(reinterpret_cast<__nv_bfloat16*>(smem + L.a), p.bk);

  const int bm = p.bm, bn = p.bn, kc = p.kc;
  const int n_tiles = (p.N + bn - 1) / bn;
  const int t_begin = blockIdx.x * p.tiles_per_cta;
  const int t_end = min(n_tiles, t_begin + p.tiles_per_cta);
  if (t_begin >= t_end) return;  // the whole CTA
  const int row0 = blockIdx.y * bm;
  const int rows_valid = min(bm, p.M - row0);
  const int mode_a = p.modes & 3, mode_b = (p.modes >> 2) & 3,
            mode_c = (p.modes >> 4) & 3, mode_bias = (p.modes >> 6) & 3,
            mode_r = (p.modes >> 8) & 3;
  const size_t tile_b = static_cast<size_t>(p.bk) * bn;
  const size_t tile_c = static_cast<size_t>(bm) * bn;
  auto b_tile = [&](int s) { return smem_tile(Bs + s * tile_b, bn); };

  const int groups = ((bn + 7) / 8 + kFN - 1) / kFN;  // fragment runs a block
  const int warp = threadIdx.x >> 5;
  const bool active = warp < ((bm + 15) / 16) * groups;
  const int wr = (warp / groups) * 16;   // the warp's first row
  const int wc = (warp % groups) * 8 * kFN;  // and first column

  // a tile's B, then (issue_rest) its partial C, bias and residual tiles
  auto issue_b = [&](int t, int s) {
    const SmemTile bt = b_tile(s);
    stage_rows<kThreads>(bt.p, bt, B + static_cast<size_t>(p.k0) * p.N + t * bn,
                         p.N, kc, bn, kc, min(bn, p.N - t * bn), mode_b,
                         threadIdx.x);
  };
  auto issue_rest = [&](int t, int s) {
    const int col0 = t * bn;
    const int cols_valid = min(bn, p.N - col0);
    const RowMajor plain{bn};
    if (Cin != nullptr)
      stage_rows<kThreads>(Cs + s * tile_c, plain,
                           Cin + static_cast<size_t>(row0) * p.N + col0, p.N,
                           bm, bn, rows_valid, cols_valid, mode_c,
                           threadIdx.x);
    if (kFinal && bias != nullptr)
      stage_rows<kThreads>(Bias_s + s * bn, plain, bias + col0, 0, 1, bn, 1,
                           cols_valid, mode_bias, threadIdx.x);
    if (kFinal && res != nullptr) {
      const size_t at = static_cast<size_t>(row0) * p.N + col0;
      if (res_size == 2)
        stage_rows<kThreads>(
            reinterpret_cast<__nv_bfloat16*>(Rs) + s * tile_c, plain,
            static_cast<const __nv_bfloat16*>(res) + at, p.N, bm, bn,
            rows_valid, cols_valid, mode_r, threadIdx.x);
      else
        stage_rows<kThreads>(reinterpret_cast<float*>(Rs) + s * tile_c,
                             plain, static_cast<const float*>(res) + at, p.N,
                             bm, bn, rows_valid, cols_valid, mode_r,
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
  stage_rows<kThreads>(Ap.p, Ap, A + static_cast<size_t>(row0) * p.K + p.k0,
                       p.K, bm, kc, rows_valid, kc, mode_a,
                         threadIdx.x);
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
    if (active) {
      float acc[1][kFN][4];
#pragma unroll
      for (int j = 0; j < kFN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wr + frag_row(0, e), c = wc + frag_col(j, e);
          acc[0][j][e] = (Cin != nullptr && r < bm && c < bn)
                             ? Cs[s * tile_c + r * bn + c]
                             : 0.0f;
        }
      mma_slab<1, kFN, true>(acc, Ap, wr, bm - wr, b_tile(s), wc, bn - wc,
                             kc);
#pragma unroll
      for (int j = 0; j < kFN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wr + frag_row(0, e), c = wc + frag_col(j, e);
          const int col = t * bn + c;
          if (r >= rows_valid || c >= bn || col >= p.N) continue;
          const size_t at = static_cast<size_t>(row0 + r) * p.N + col;
          if (kFinal) {
            float rv = 0.0f;
            if (res != nullptr) {
              const size_t ri = s * tile_c + r * bn + c;
              rv = res_size == 2
                       ? to_f32(reinterpret_cast<__nv_bfloat16*>(Rs)[ri])
                       : reinterpret_cast<float*>(Rs)[ri];
            }
            const float x = epilogue(
                acc[0][j][e], bias != nullptr,
                bias != nullptr ? Bias_s[s * bn + c] : 0.0f, p.act,
                res != nullptr, rv);
            if (p.out_dtype == kBF16)
              static_cast<__nv_bfloat16*>(C)[at] = from_f32<__nv_bfloat16>(x);
            else
              static_cast<float*>(C)[at] = x;
          } else {
            Cacc[at] = acc[0][j][e];
          }
        }
    }
    __syncthreads();  // stage s is refilled by the next iteration's issue
  }
}

template <int kFN, bool kFinal>
int launch_mma(const void* a, const void* b, const void* c_in, void* c_acc,
               void* c, const void* bias, const void* res, const TbArgs& p,
               size_t smem, cudaStream_t stream) {
  auto kernel = gemm_tb_mma_kernel<kFN, kFinal>;
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
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<const float*>(c_in),
      static_cast<float*>(c_acc), c, static_cast<const float*>(bias), res,
      p));
}

template <typename TIn, int kRows, bool kFinal>
int launch_rows(const void* a, const void* b, const void* c_in, void* c_acc,
                void* c, const void* bias, const void* res, const TbArgs& p,
                size_t smem, cudaStream_t stream) {
  auto kernel = gemm_tb_kernel<TIn, kRows, kFinal>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxSmem);
    configured = true;
  }
  const int n_tiles = (p.N + p.bn - 1) / p.bn;
  dim3 grid((n_tiles + p.tiles_per_cta - 1) / p.tiles_per_cta,
            (p.M + p.bm - 1) / p.bm);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b),
      static_cast<const float*>(c_in), static_cast<float*>(c_acc), c,
      static_cast<const float*>(bias), res, p);
  return static_cast<int>(cudaGetLastError());
}

// Checks the tile against the kernel's limits, sizes the plan's whole
// layout (bias and residual stages included, also for B6a, which leaves
// them unused) and picks the body's instantiation: for bf16 the fragments a
// warp owns, for f32 the rows a thread owns.
template <typename TIn, bool kFinal>
int launch(const void* a, const void* b, const void* c_in, void* c_acc,
           void* c, const void* bias, const void* res, const TbArgs& p,
           bool has_bias, bool has_res, cudaStream_t stream) {
  if (p.bn < 1 || p.bn > kThreads || p.bm < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const TbLayout L = tb_layout(p.bm, p.bk, p.bn, sizeof(TIn),
                               p.res_dtype == kBF16 ? 2 : 4, has_bias,
                               has_res);
  if (L.total > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (sizeof(TIn) == 2) {
    const int blocks = (p.bm + 15) / 16, frags = (p.bn + 7) / 8;
    if (blocks * frags <= kWarps)
      return launch_mma<1, kFinal>(a, b, c_in, c_acc, c, bias, res, p,
                                   L.total, stream);
    if (blocks * ((frags + 1) / 2) <= kWarps)
      return launch_mma<2, kFinal>(a, b, c_in, c_acc, c, bias, res, p,
                                   L.total, stream);
    if (blocks * ((frags + kMaxFrags - 1) / kMaxFrags) <= kWarps)
      return launch_mma<kMaxFrags, kFinal>(a, b, c_in, c_acc, c, bias, res,
                                           p, L.total, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const int groups = kThreads / p.bn;
    const int rows = (p.bm + groups - 1) / groups;
    if (rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
    if (rows <= 1)
      return launch_rows<float, 1, kFinal>(a, b, c_in, c_acc, c, bias, res, p,
                                           L.total, stream);
    if (rows <= 2)
      return launch_rows<float, 2, kFinal>(a, b, c_in, c_acc, c, bias, res, p,
                                           L.total, stream);
    if (rows <= 4)
      return launch_rows<float, 4, kFinal>(a, b, c_in, c_acc, c, bias, res, p,
                                           L.total, stream);
    if (rows <= 8)
      return launch_rows<float, 8, kFinal>(a, b, c_in, c_acc, c, bias, res, p,
                                           L.total, stream);
    return launch_rows<float, kMaxRows, kFinal>(a, b, c_in, c_acc, c, bias, res,
                                                p, L.total, stream);
  }
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

}  // namespace
}  // namespace repro

// Bytes of dynamic shared memory one CTA takes for a tile.
extern "C" int gemm_tb_smem_bytes(int bm, int bk, int bn, int in_dtype,
                                  int res_dtype, int has_bias, int has_res) {
  using namespace repro;
  return static_cast<int>(tb_layout(bm, bk, bn, in_dtype == kBF16 ? 2 : 4,
                                    res_dtype == kBF16 ? 2 : 4, has_bias != 0,
                                    has_res != 0)
                              .total);
}

// B6a: one k-chunk [k0, k0 + kc) accumulated into the (m,n) f32 partial
// c_acc; c_in is the partial of the earlier chunks (null on the first; it
// may be c_acc itself).  A (m,k), B (k,n) row-major and contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int gemm_tb_accumulate_launch(const void* a, const void* b,
                                         const void* c_in, void* c_acc, int m,
                                         int n, int k, int k0, int kc, int bm,
                                         int bk, int bn, int tiles_per_cta,
                                         int in_dtype, int res_dtype,
                                         int has_bias, int has_res, int modes,
                                         void* stream) {
  using namespace repro;
  const TbArgs p = make_args(m, n, k, k0, kc, bm, bk, bn, tiles_per_cta,
                             kNone, kF32, res_dtype, modes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kBF16)
    return launch<__nv_bfloat16, false>(a, b, c_in, c_acc, nullptr, nullptr,
                                        nullptr, p, has_bias != 0,
                                        has_res != 0, s);
  return launch<float, false>(a, b, c_in, c_acc, nullptr, nullptr, nullptr, p,
                              has_bias != 0, has_res != 0, s);
}

// B6b: the last k-chunk [k0, k0 + kc) on top of the partial c_in (null when
// it is the only chunk), then bias (n,) f32 or null -> activation ->
// residual (m,n) or null, written to c (m,n) at out_dtype.
extern "C" int gemm_tb_final_launch(const void* a, const void* b,
                                    const void* c_in, void* c,
                                    const void* bias, const void* res, int m,
                                    int n, int k, int k0, int kc, int bm,
                                    int bk, int bn, int tiles_per_cta,
                                    int in_dtype, int out_dtype,
                                    int res_dtype, int act, int modes,
                                    void* stream) {
  using namespace repro;
  const TbArgs p = make_args(m, n, k, k0, kc, bm, bk, bn, tiles_per_cta, act,
                             out_dtype, res_dtype, modes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kBF16)
    return launch<__nv_bfloat16, true>(a, b, c_in, nullptr, c, bias, res, p,
                                       bias != nullptr, res != nullptr, s);
  return launch<float, true>(a, b, c_in, nullptr, c, bias, res, p,
                             bias != nullptr, res != nullptr, s);
}
