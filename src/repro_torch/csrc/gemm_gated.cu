// gemm_gated — dual-B gated GEMM act(A Wg) * (A Wu), for Hopper.
//
// Replaces: repro/kernels/gemm_gated.py gemm_gated (pallas_call at :114,
// body _gated_kernel at :34): the SwiGLU gate/up pair in one pass, the
// activation and the product in f32 on the flush.  The (m, d_ff) gate/up
// intermediates never reach device memory.
//
// What bounds it on an H100: the two (k, n) weight matrices, read once each.
// At smollm-360m's decode (m = 8, two 960 x 2560 bf16 weights) that is 9.8 MB
// a launch, 2.9 us at 3.35 TB/s, against 79 MFLOP (0.08 us at 989 TFLOP/s);
// a 300-token prefill moves the same weights and 1.5 GFLOP (1.5 us), so it
// is still bound by bytes.  One SM streams only 5.5-13.5 B a cycle (PERF.md
// §6, tools/hopper_probe.cu), so the weights must be spread over most SMs
// with many bytes in flight on each.
//
// Design (bf16 operands): B1's tensor-core dataflow (gemm_aie.cu) with two B
// streams.  One CTA owns a BM x BN tile of both products and walks all of
// k; A, Wg and Wu come in BK-deep slabs through a ring of kStages stages
// filled by 16-byte cp.async (staging.cuh), and one staged A slab feeds both
// the Wg and the Wu fragments.  kernels/gemm_gated.py cta_tile picks the CTA
// shape by m: with m <= 16 one 16-row fragment and 16 columns, so that
// smollm-360m's n = 2560 gives 160 CTAs, at least 7/8 of the SMs, with four
// copy warps and 8 stages: 64 KB of weights in flight an SM, and the MMA
// warps never stall on issuing copies; with more rows a 64 x 64 tile whose
// four warps own 32 x 32 of each product (2 x 32 f32 accumulators a
// thread).  Ragged edges (m, n, k) load zeros and are not stored, so no
// caller pads.
//
// Both accumulators run mma_chain.cuh's chain (mma_slab), the one B1 and B6
// run: each gate and each up element is one mma.sync m16n8k16 sequence over
// k = 0, 16, 32, ... ascending, from zero, the k tail read as zeros.  So
// they are bit for bit B1's gemm_aie(a, b, out_dtype=float32) on the same
// operands, and a row's bits do not depend on m or on its place in the tile
// (continuous == solo greedy: B2 runs at m = 8 in decode and at the prompt's
// m in prefill).
//
// f32 operands keep the CUDA-core body (gemm_gated_kernel below): a fixed
// 16 x 64 x 32 tile, one fmaf chain over k = 0..K-1 per element, the next
// tile prefetched into registers during the products.
#include "mma_chain.cuh"
#include "staging.cuh"

namespace repro {
namespace {

constexpr int kBM = 16;
constexpr int kBN = 32;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kRowGroups = kThreads / kBN;
constexpr int kRowsPerThread = kBM / kRowGroups;
constexpr int kALoads = kBM * kBK / kThreads;
constexpr int kBLoads = kBK * kBN / kThreads;

template <typename TOut>
__global__ void __launch_bounds__(kThreads)
gemm_gated_kernel(const float* __restrict__ A, const float* __restrict__ Bg,
                  const float* __restrict__ Bu, TOut* __restrict__ C, int M,
                  int N, int K, int act) {
  __shared__ float As[kBM][kBK];
  __shared__ float Gs[kBK][kBN];
  __shared__ float Us[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % kBN;
  const int ty = tid / kBN;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  float acc_g[kRowsPerThread], acc_u[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc_g[i] = acc_u[i] = 0.0f;

  float ra[kALoads], rg[kBLoads], ru[kBLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int it = 0; it < kALoads; ++it) {
      const int i = tid + it * kThreads;
      const int gr = row0 + i / kBK, gc = k0 + i % kBK;
      ra[it] = (gr < M && gc < K) ? A[(size_t)gr * K + gc] : 0.0f;
    }
#pragma unroll
    for (int it = 0; it < kBLoads; ++it) {
      const int i = tid + it * kThreads;
      const int gr = k0 + i / kBN, gc = col0 + i % kBN;
      const bool ok = gr < K && gc < N;
      const size_t at = (size_t)gr * N + gc;
      rg[it] = ok ? Bg[at] : 0.0f;
      ru[it] = ok ? Bu[at] : 0.0f;
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
      Gs[i / kBN][i % kBN] = rg[it];
      Us[i / kBN][i % kBN] = ru[it];
    }
    __syncthreads();
    if (k0 + kBK < K) load(k0 + kBK);  // in flight during the products
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float g = Gs[kk][tx];
      const float u = Us[kk][tx];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float a = As[ty + kRowGroups * i][kk];
        acc_g[i] = fmaf(a, g, acc_g[i]);
        acc_u[i] = fmaf(a, u, acc_u[i]);
      }
    }
    __syncthreads();
  }

  const int col = col0 + tx;
  if (col >= N) return;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = row0 + ty + kRowGroups * i;
    if (row >= M) continue;
    C[(size_t)row * N + col] = from_f32<TOut>(activate(acc_g[i], act) * acc_u[i]);
  }
}

template <typename TOut>
void launch_f32(const void* a, const void* bg, const void* bu, void* c, int m,
                int n, int k, int act, cudaStream_t stream) {
  dim3 grid(cdiv(n, kBN), cdiv(m, kBM));
  gemm_gated_kernel<TOut><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(bg),
      static_cast<const float*>(bu), static_cast<TOut*>(c), m, n, k, act);
}

// ---------------------------------------------------------------------------
// The tensor-core body (bf16 operands)
// ---------------------------------------------------------------------------

struct GatedArgs {
  int M, N, K, act;
  int out_dtype;       // C's type (kF32 / kBF16)
  int mode_a, mode_b;  // staging.cuh copy modes of A and of both Bs
};

// A CTA shape: kWM x kWN MMA warps, each owning kFM x kFN m16n8 fragments
// of both products, so a BM x BN tile; BK-deep slabs through kStages
// stages.  With kCopyWarps > 0 that many more warps do all the staging;
// with 0 every warp stages.  A stage holds the A slab, then the Wg slab,
// then the Wu slab.
template <int kWM, int kWN, int kFM, int kFN, int kBK_, int kStages_,
          int kCopyWarps_ = 0>
struct GatedShape {
  static constexpr int kMmaWarps = kWM * kWN, kCopyWarps = kCopyWarps_;
  static constexpr int kThreads = 32 * (kMmaWarps + kCopyWarps);
  static constexpr int kCopyThreads = kCopyWarps ? 32 * kCopyWarps : kThreads;
  static constexpr int kBM = 16 * kFM * kWM, kBN = 8 * kFN * kWN;
  static constexpr int kBK = kBK_, kStages = kStages_;
  static constexpr int kWarpN = kWN, kFragM = kFM, kFragN = kFN;
  static constexpr int kAElems = kBM * kBK, kBElems = kBK * kBN;
  static constexpr int kStageElems = kAElems + 2 * kBElems;
  static constexpr size_t kSmem = 2 * static_cast<size_t>(kStages) *
                                  kStageElems;
};

// One BK x BN slab of a B stream into its stage tile, zero-filled past K
// and N, by the S::kCopyThreads threads (tid: this one's index among them).
template <typename S>
__device__ __forceinline__ void stage_b(const SmemTile& bt,
                                        const __nv_bfloat16* b,
                                        const GatedArgs& p, int depth,
                                        int cols_valid, int tid) {
  constexpr int kT = S::kCopyThreads;
  if (p.mode_b == 2)
    stage_rows16<kT, S::kBN>(bt.p, bt, b, p.N, S::kBK, depth, cols_valid,
                             tid);
  else
    stage_rows<kT>(bt.p, bt, b, p.N, S::kBK, S::kBN, depth, cols_valid,
                   p.mode_b, tid);
}

template <typename S>
__global__ void __launch_bounds__(S::kThreads)
gemm_gated_mma_kernel(const __nv_bfloat16* __restrict__ A,
                      const __nv_bfloat16* __restrict__ Bg,
                      const __nv_bfloat16* __restrict__ Bu, void* C,
                      GatedArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  const int row0 = blockIdx.y * S::kBM, col0 = blockIdx.x * S::kBN;
  const int rows_valid = min(S::kBM, p.M - row0);
  const int cols_valid = min(S::kBN, p.N - col0);
  const int warp = threadIdx.x >> 5;
  const bool mma_warp = warp < S::kMmaWarps;
  const int tid = threadIdx.x - (S::kCopyWarps ? 32 * S::kMmaWarps : 0);
  const bool copier = tid >= 0;
  const int wr = (warp / S::kWarpN) * 16 * S::kFragM;  // warp's rows
  const int wc = (warp % S::kWarpN) * 8 * S::kFragN;   // warp's columns
  // one 16-row fragment (the few-row shapes): at m <= 8 only 8 rows of A
  // are staged, and the fragment's other 8 read as zero
  constexpr bool kEdge = S::kBM == 16;
  const int a_rows = kEdge && rows_valid <= 8 ? 8 : S::kBM;
  auto a_tile = [&](int s) {
    return smem_tile(ring + s * S::kStageElems, S::kBK);
  };
  auto g_tile = [&](int s) {
    return smem_tile(ring + s * S::kStageElems + S::kAElems, S::kBN);
  };
  auto u_tile = [&](int s) {
    return smem_tile(ring + s * S::kStageElems + S::kAElems + S::kBElems,
                     S::kBN);
  };
  const int slabs = (p.K + S::kBK - 1) / S::kBK;
  auto load = [&](int slab) {
    const int s = slab % S::kStages, k0 = slab * S::kBK;
    const int depth = min(S::kBK, p.K - k0);
    const SmemTile at = a_tile(s);
    const __nv_bfloat16* a = A + static_cast<size_t>(row0) * p.K + k0;
    if (p.mode_a == 2)
      stage_rows16<S::kCopyThreads, S::kBK>(at.p, at, a, p.K, a_rows,
                                            rows_valid, depth, tid);
    else
      stage_rows<S::kCopyThreads>(at.p, at, a, p.K, a_rows, S::kBK,
                                  rows_valid, depth, p.mode_a, tid);
    const size_t b_at = static_cast<size_t>(k0) * p.N + col0;
    stage_b<S>(g_tile(s), Bg + b_at, p, depth, cols_valid, tid);
    stage_b<S>(u_tile(s), Bu + b_at, p, depth, cols_valid, tid);
  };

  float acc_g[S::kFragM][S::kFragN][4], acc_u[S::kFragM][S::kFragN][4];
#pragma unroll
  for (int i = 0; i < S::kFragM; ++i)
#pragma unroll
    for (int j = 0; j < S::kFragN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_g[i][j][e] = acc_u[i][j][e] = 0.0f;

  // The ring, as B1's: with copy warps, slab 0 goes first and the MMA warps
  // start on it while the copy warps fill the other stages; without,
  // kStages - 1 slabs are in flight before the first products.  Slab
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
    const int k_len = depth == S::kBK ? S::kBK : (depth + 15) & ~15;
    const SmemTile at = a_tile(s);
    mma_slab<S::kFragM, S::kFragN, kEdge>(acc_g, at, wr, a_rows - wr,
                                          g_tile(s), wc, S::kBN - wc, k_len);
    mma_slab<S::kFragM, S::kFragN, kEdge>(acc_u, at, wr, a_rows - wr,
                                          u_tile(s), wc, S::kBN - wc, k_len);
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
        const float x =
            __fmul_rn(activate(acc_g[i][j][e], p.act), acc_u[i][j][e]);
        if (p.out_dtype == kBF16)
          static_cast<__nv_bfloat16*>(C)[at] = from_f32<__nv_bfloat16>(x);
        else
          static_cast<float*>(C)[at] = x;
      }
}

template <typename S>
int launch_mma(const void* a, const void* bg, const void* bu, void* c,
               const GatedArgs& p, cudaStream_t stream) {
  auto kernel = gemm_gated_mma_kernel<S>;
  static bool configured = false;  // one attribute call per shape
  if (!configured) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(S::kSmem));
    configured = true;
  }
  dim3 grid(cdiv(p.N, S::kBN), cdiv(p.M, S::kBM));
  kernel<<<grid, S::kThreads, S::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(bg),
      static_cast<const __nv_bfloat16*>(bu), c, p);
  return static_cast<int>(cudaGetLastError());
}

// The CTA shapes of the bf16 body, by the index kernels/gemm_gated.py
// BF16_TILES gives them (its (bm, bk, bn) must match): with m <= 16 one
// 16-row fragment and 2 MMA warps of one 8-column fragment of each
// product, 128-deep slabs, 4 copy warps and 8 stages (8 x 12 KB of shared
// memory); with more rows 64 x 64 (4 warps of 2 x 4 fragments of each
// product that stage too), 64-deep slabs, 4 stages (96 KB).
int launch_bf16(int config, const void* a, const void* bg, const void* bu,
                void* c, const GatedArgs& p, cudaStream_t s) {
  switch (config) {
    case 1:
      return launch_mma<GatedShape<1, 2, 1, 1, 128, 8, 4>>(a, bg, bu, c, p, s);
    case 2:
      return launch_mma<GatedShape<2, 2, 2, 4, 64, 4>>(a, bg, bu, c, p, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro

// A (m,k), Wg/Wu (k,n), C (m,n) row-major and contiguous.  bf16 operands run
// the tensor-core body with CTA shape ``config`` (1 or 2, see launch_bf16)
// and the staging copy modes ``modes`` (2 bits each: A, then both Bs); f32
// operands the fmaf body, which ignores both.  Returns cudaGetLastError()
// after the launch.
extern "C" int gemm_gated_launch(const void* a, const void* bg,
                                 const void* bu, void* c, int m, int n,
                                 int k, int in_dtype, int out_dtype, int act,
                                 int config, int modes, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kBF16) {
    GatedArgs p;
    p.M = m, p.N = n, p.K = k, p.act = act, p.out_dtype = out_dtype;
    p.mode_a = modes & 3, p.mode_b = (modes >> 2) & 3;
    return launch_bf16(config, a, bg, bu, c, p, s);
  }
  if (out_dtype == kBF16)
    launch_f32<__nv_bfloat16>(a, bg, bu, c, m, n, k, act, s);
  else
    launch_f32<float>(a, bg, bu, c, m, n, k, act, s);
  return static_cast<int>(cudaGetLastError());
}
