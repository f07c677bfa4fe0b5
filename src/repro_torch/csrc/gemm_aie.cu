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
// Design (bf16 operands): one CTA owns one BM x BN tile of C and walks all
// of k, so nothing is carried between blocks (the TPU grid's sequential k
// axis becomes this loop).  A and B come in BK-deep slabs through a ring of
// kStages shared-memory stages filled by 16-byte cp.async (staging.cuh), so
// several slabs of B are in flight while the tensor cores multiply the
// oldest one; the products are mma_chain.cuh's m16n8k16 chain, each warp
// owning kFM x kFN fragments.  The wrapper (kernels/gemm_aie.py
// cta_tile) picks the CTA shape by m and n: with few rows (m <= 16) one
// 16-row fragment and n split 8, 32 or 64 columns a CTA so that the
// weight-streaming CTAs cover the card (at least one an SM where n / 8
// allows), each with 16 KB or more of B in flight; with more rows a
// 64 x 64 tile.  Ragged edges (m, n, k) load zeros and are not stored,
// so no caller pads.
//
// f32 operands keep the CUDA-core body (gemm_aie_kernel below): a fixed
// 16 x 128 x 32 tile, each thread BM/4 accumulators of one column, one
// fmaf chain over k = 0..K-1 per element, the next tile prefetched into
// registers during the products.
//
// Order invariance: every C element is one chain over k in a fixed order
// (the tensor-core chain of mma_chain.cuh for bf16, the fmaf chain for
// f32), whatever m is, whichever CTA shape runs it and wherever the row
// sits in the tile.  A row's result is therefore the same bits at batch 1
// and inside a continuous batch, which is what keeps continuous-batched
// greedy decoding identical to solo greedy decoding; and B6 (gemm_tb.cu)
// runs the same chains, so it equals this kernel bit for bit.
#include "mma_chain.cuh"
#include "staging.cuh"

namespace repro {
namespace {

constexpr int kBM = 16;
constexpr int kBN = 32;
constexpr int kBK = 128;
constexpr int kThreads = 256;
constexpr int kRowGroups = kThreads / kBN;  // threads per C column
constexpr int kRowsPerThread = kBM / kRowGroups;
constexpr int kALoads = kBM * kBK / kThreads;  // A elements per thread/step
constexpr int kBLoads = kBK * kBN / kThreads;  // B elements per thread/step

template <typename TIn, typename TOut, typename TRes>
__global__ void __launch_bounds__(kThreads)
gemm_aie_kernel(const TIn* __restrict__ A, const TIn* __restrict__ B,
                TOut* __restrict__ C, const float* __restrict__ bias,
                const TRes* __restrict__ res, int M, int N, int K, int act) {
  __shared__ float As[kBM][kBK];
  __shared__ float Bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % kBN;  // C column within the tile
  const int ty = tid / kBN;  // row group: rows ty, ty + kRowGroups, ...
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.0f;

  float ra[kALoads], rb[kBLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int it = 0; it < kALoads; ++it) {
      const int i = tid + it * kThreads;
      const int gr = row0 + i / kBK, gc = k0 + i % kBK;
      ra[it] = (gr < M && gc < K) ? to_f32(A[(size_t)gr * K + gc]) : 0.0f;
    }
#pragma unroll
    for (int it = 0; it < kBLoads; ++it) {
      const int i = tid + it * kThreads;
      const int gr = k0 + i / kBN, gc = col0 + i % kBN;
      rb[it] = (gr < K && gc < N) ? to_f32(B[(size_t)gr * N + gc]) : 0.0f;
    }
  };

  load(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int it = 0; it < kALoads; ++it) {
      const int i = tid + it * kThreads;
      As[i / kBK][i % kBK] = ra[it];
    }
#pragma unroll
    for (int it = 0; it < kBLoads; ++it) {
      const int i = tid + it * kThreads;
      Bs[i / kBN][i % kBN] = rb[it];
    }
    __syncthreads();
    if (k0 + kBK < K) load(k0 + kBK);  // in flight during the products
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float b = Bs[kk][tx];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        acc[i] = fmaf(As[ty + kRowGroups * i][kk], b, acc[i]);
    }
    __syncthreads();
  }

  const int col = col0 + tx;
  if (col >= N) return;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = row0 + ty + kRowGroups * i;
    if (row >= M) continue;
    const float x = epilogue(
        acc[i], bias != nullptr, bias != nullptr ? bias[col] : 0.0f, act,
        res != nullptr,
        res != nullptr ? to_f32(res[(size_t)row * N + col]) : 0.0f);
    C[(size_t)row * N + col] = from_f32<TOut>(x);
  }
}

template <typename TIn, typename TOut, typename TRes>
void launch(const void* a, const void* b, void* c, const void* bias,
            const void* res, int m, int n, int k, int act,
            cudaStream_t stream) {
  dim3 grid(cdiv(n, kBN), cdiv(m, kBM));
  gemm_aie_kernel<TIn, TOut, TRes><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b),
      static_cast<TOut*>(c), static_cast<const float*>(bias),
      static_cast<const TRes*>(res), m, n, k, act);
}

template <typename TIn, typename TOut>
void launch_res(int res_dtype, const void* a, const void* b, void* c,
                const void* bias, const void* res, int m, int n, int k,
                int act, cudaStream_t stream) {
  if (res_dtype == kBF16)
    launch<TIn, TOut, __nv_bfloat16>(a, b, c, bias, res, m, n, k, act, stream);
  else
    launch<TIn, TOut, float>(a, b, c, bias, res, m, n, k, act, stream);
}

template <typename TIn>
void launch_out(int out_dtype, int res_dtype, const void* a, const void* b,
                void* c, const void* bias, const void* res, int m, int n,
                int k, int act, cudaStream_t stream) {
  if (out_dtype == kBF16)
    launch_res<TIn, __nv_bfloat16>(res_dtype, a, b, c, bias, res, m, n, k,
                                   act, stream);
  else
    launch_res<TIn, float>(res_dtype, a, b, c, bias, res, m, n, k, act,
                           stream);
}

// ---------------------------------------------------------------------------
// The tensor-core body (bf16 operands)
// ---------------------------------------------------------------------------

struct AieArgs {
  int M, N, K, act;
  int out_dtype, res_dtype;  // C's and the residual's type (kF32 / kBF16)
  int mode_a, mode_b;        // staging.cuh copy modes of A and B
};

// A CTA shape: kWM x kWN warps, each owning kFM x kFN m16n8 fragments, so a
// BM x BN tile of C; BK-deep slabs through kStages stages.  With kCopyWarps
// > 0 that many more warps do all the staging, so the MMA warps of a
// narrow tile never stall on issuing copies; with 0 every warp stages.
template <int kWM, int kWN, int kFM, int kFN, int kBK_, int kStages_,
          int kCopyWarps_ = 0>
struct MmaShape {
  static constexpr int kMmaWarps = kWM * kWN, kCopyWarps = kCopyWarps_;
  static constexpr int kThreads = 32 * (kMmaWarps + kCopyWarps);
  static constexpr int kCopyThreads = kCopyWarps ? 32 * kCopyWarps : kThreads;
  static constexpr int kBM = 16 * kFM * kWM, kBN = 8 * kFN * kWN;
  static constexpr int kBK = kBK_, kStages = kStages_;
  static constexpr int kWarpM = kWM, kWarpN = kWN, kFragM = kFM, kFragN = kFN;
  static constexpr int kStageElems = kBM * kBK + kBK * kBN;
  static constexpr size_t kSmem = 2 * static_cast<size_t>(kStages) *
                                  kStageElems;
};

// One BM x BK slab of A and one BK x BN slab of B into a stage, zero-filled
// past K, M and N, by the S::kCopyThreads threads (tid: this one's index
// among them).  With m <= 8 rows a 16-row A slab stages only its first 8
// rows (a_rows).
template <typename S>
__device__ __forceinline__ void aie_load(const SmemTile& at,
                                         const SmemTile& bt,
                                         const __nv_bfloat16* A,
                                         const __nv_bfloat16* B,
                                         const AieArgs& p, int row0, int col0,
                                         int rows_valid, int cols_valid,
                                         int a_rows, int k0, int tid) {
  constexpr int kT = S::kCopyThreads;
  const int depth = min(S::kBK, p.K - k0);
  const __nv_bfloat16* a = A + static_cast<size_t>(row0) * p.K + k0;
  const __nv_bfloat16* b = B + static_cast<size_t>(k0) * p.N + col0;
  if (p.mode_a == 2)
    stage_rows16<kT, S::kBK>(at.p, at, a, p.K, a_rows, rows_valid, depth, tid);
  else
    stage_rows<kT>(at.p, at, a, p.K, a_rows, S::kBK, rows_valid, depth,
                   p.mode_a, tid);
  if (p.mode_b == 2)
    stage_rows16<kT, S::kBN>(bt.p, bt, b, p.N, S::kBK, depth, cols_valid,
                             tid);
  else
    stage_rows<kT>(bt.p, bt, b, p.N, S::kBK, S::kBN, depth, cols_valid,
                   p.mode_b, tid);
}

template <typename S>
__global__ void __launch_bounds__(S::kThreads)
gemm_aie_mma_kernel(const __nv_bfloat16* __restrict__ A,
                    const __nv_bfloat16* __restrict__ B, void* C,
                    const float* __restrict__ bias, const void* res,
                    AieArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
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
    return smem_tile(ring + s * S::kStageElems, S::kBK);
  };
  auto b_tile = [&](int s) {
    return smem_tile(ring + s * S::kStageElems + S::kBM * S::kBK, S::kBN);
  };
  const int slabs = (p.K + S::kBK - 1) / S::kBK;
  auto load = [&](int slab) {
    const int s = slab % S::kStages;
    aie_load<S>(a_tile(s), b_tile(s), A, B, p, row0, col0, rows_valid,
                cols_valid, a_rows, slab * S::kBK, tid);
  };

  float acc[S::kFragM][S::kFragN][4];
#pragma unroll
  for (int i = 0; i < S::kFragM; ++i)
#pragma unroll
    for (int j = 0; j < S::kFragN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

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
    if (!mma_warp) continue;
    const int s = i % S::kStages;
    // the slab is zero-filled past K, so its last step runs whole
    const int depth = min(S::kBK, p.K - i * S::kBK);
    if (depth == S::kBK)
      mma_slab<S::kFragM, S::kFragN, kEdge>(acc, a_tile(s), wr, a_rows - wr,
                                            b_tile(s), wc, S::kBN - wc,
                                            S::kBK);
    else
      mma_slab<S::kFragM, S::kFragN, kEdge>(acc, a_tile(s), wr, a_rows - wr,
                                            b_tile(s), wc, S::kBN - wc,
                                            (depth + 15) & ~15);
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
        float rv = 0.0f;
        if (res != nullptr)
          rv = p.res_dtype == kBF16
                   ? to_f32(static_cast<const __nv_bfloat16*>(res)[at])
                   : static_cast<const float*>(res)[at];
        const float x =
            epilogue(acc[i][j][e], bias != nullptr,
                     bias != nullptr ? bias[col0 + c] : 0.0f, p.act,
                     res != nullptr, rv);
        if (p.out_dtype == kBF16)
          static_cast<__nv_bfloat16*>(C)[at] = from_f32<__nv_bfloat16>(x);
        else
          static_cast<float*>(C)[at] = x;
      }
}

template <typename S>
int launch_mma(const void* a, const void* b, void* c, const void* bias,
               const void* res, const AieArgs& p, cudaStream_t stream) {
  auto kernel = gemm_aie_mma_kernel<S>;
  static bool configured = false;  // one attribute call per shape
  if (!configured) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(S::kSmem));
    configured = true;
  }
  dim3 grid(cdiv(p.N, S::kBN), cdiv(p.M, S::kBM));
  kernel<<<grid, S::kThreads, S::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), c,
      static_cast<const float*>(bias), res, p);
  return static_cast<int>(cudaGetLastError());
}

// The CTA shapes of the bf16 body, by the index kernels/gemm_aie.py
// BF16_TILES gives them (its (bm, bk, bn) must match): with m <= 16 one
// 16-row fragment and 1, 4 or 8 MMA warps of one 8-column fragment each,
// 128-deep slabs; the two narrow shapes beside 4 copy warps and 8 stages
// (so 16 KB or more of B is in flight and the MMA warps start on the first
// slab), the widest (many CTAs) staging itself through 4; with more rows
// 64 x 64 (4 warps of 2 x 4 fragments that stage too), 64-deep slabs, 4
// stages.
int launch_bf16(int config, const void* a, const void* b, void* c,
                const void* bias, const void* res, const AieArgs& p,
                cudaStream_t s) {
  switch (config) {
    case 1:
      return launch_mma<MmaShape<1, 1, 1, 1, 128, 8, 4>>(a, b, c, bias, res,
                                                          p, s);
    case 2:
      return launch_mma<MmaShape<1, 4, 1, 1, 128, 8, 4>>(a, b, c, bias, res,
                                                          p, s);
    case 3:
      return launch_mma<MmaShape<1, 8, 1, 1, 128, 4>>(a, b, c, bias, res, p,
                                                       s);
    case 4:
      return launch_mma<MmaShape<2, 2, 2, 4, 64, 4>>(a, b, c, bias, res, p, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro

// A (m,k), B (k,n), C (m,n) row-major and contiguous; bias (n,) f32 or
// null; residual (m,n) or null.  bf16 operands run the tensor-core body with
// CTA shape ``config`` (1..4, see launch_bf16) and the staging copy modes
// ``modes`` (2 bits each: A, then B); f32 operands the fmaf body, which
// ignores both.  Returns cudaGetLastError() after the launch.
extern "C" int gemm_aie_launch(const void* a, const void* b, void* c,
                               const void* bias, const void* res, int m,
                               int n, int k, int in_dtype, int out_dtype,
                               int res_dtype, int act, int config, int modes,
                               void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kBF16) {
    AieArgs p;
    p.M = m, p.N = n, p.K = k, p.act = act;
    p.out_dtype = out_dtype, p.res_dtype = res_dtype;
    p.mode_a = modes & 3, p.mode_b = (modes >> 2) & 3;
    return launch_bf16(config, a, b, c, bias, res, p, s);
  }
  launch_out<float>(out_dtype, res_dtype, a, b, c, bias, res, m, n, k, act,
                    s);
  return static_cast<int>(cudaGetLastError());
}
