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
//
// W8A16 (repro/kernels/gemm_gated.py:50-51, :104-108): int8 gate and up
// weights are staged at one byte an element and widened to bf16 once each
// slab lands (mma_chain.cuh widen_int8, B1's widening), and each accumulator is
// scaled by its (1, n) scale on the flush, before the gate; so relu(B1
// W8A16) * B1 W8A16 still holds bit for bit.  The f32 body widens int8
// weights as it loads them.  An int8 A is not taken: the planner never
// routes a gated GEMM to W8A8 (repro/kernels/api.py:1106-1109).
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

template <typename TB>
__global__ void __launch_bounds__(kThreads)
gemm_gated_kernel(const float* __restrict__ A, const TB* __restrict__ Bg,
                  const TB* __restrict__ Bu, const float* __restrict__ sg,
                  const float* __restrict__ su, void* __restrict__ C, int M,
                  int N, int K, int act, int out_dtype) {
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
      // int8 weights (W8A16 on f32 activations) widen on load, exactly
      rg[it] = ok ? to_f32(Bg[at]) : 0.0f;
      ru[it] = ok ? to_f32(Bu[at]) : 0.0f;
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
    const float x = activate(dequant(acc_g[i], sg, col), act) *
                    dequant(acc_u[i], su, col);
    store_out(C, (size_t)row * N + col, x, out_dtype, nullptr);
  }
}

template <typename TB>
int launch_f32(const void* a, const void* bg, const void* bu, const void* sg,
               const void* su, void* c, int m, int n, int k, int act,
               int out_dtype, cudaStream_t stream) {
  dim3 grid(cdiv(n, kBN), cdiv(m, kBM));
  gemm_gated_kernel<TB><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const TB*>(bg),
      static_cast<const TB*>(bu), static_cast<const float*>(sg),
      static_cast<const float*>(su), c, m, n, k, act, out_dtype);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The tensor-core body (bf16 activations)
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
// then the Wu slab, the weights at kBSize bytes an element (2: bf16; 1:
// int8, W8A16).
template <int kWM, int kWN, int kFM, int kFN, int kBK_, int kStages_,
          int kCopyWarps_ = 0>
struct GatedShape {
  static constexpr int kMmaWarps = kWM * kWN, kCopyWarps = kCopyWarps_;
  static constexpr int kThreads = 32 * (kMmaWarps + kCopyWarps);
  static constexpr int kCopyThreads = kCopyWarps ? 32 * kCopyWarps : kThreads;
  static constexpr int kBM = 16 * kFM * kWM, kBN = 8 * kFN * kWN;
  static constexpr int kBK = kBK_, kStages = kStages_;
  static constexpr int kWarpN = kWN, kFragM = kFM, kFragN = kFN;
  static constexpr int kABytes = 2 * kBM * kBK;
  template <int kBSize>
  __host__ __device__ static constexpr int stage_bytes() {
    return kABytes + 2 * kBK * kBN * kBSize;
  }
  // the ring, then (int8 weights) both slabs widened to bf16
  template <int kBSize>
  __host__ __device__ static constexpr size_t smem() {
    return static_cast<size_t>(kStages) * stage_bytes<kBSize>() +
           (kBSize == 1 ? 2 * kBK * kBN * 2 : 0);
  }
};

// One BK x BN slab of a B stream into its stage, zero-filled past K and N,
// by the S::kCopyThreads threads (tid: this one's index among them): bf16
// into mma_chain.cuh's swizzled tile, int8 row-major at one byte an element.
template <typename S, bool kB8>
__device__ __forceinline__ void stage_b(unsigned char* dst, const void* src,
                                        size_t at, const GatedArgs& p,
                                        int depth, int cols_valid, int tid) {
  constexpr int kT = S::kCopyThreads;
  if constexpr (kB8) {
    // the wrapper picks mode 2 only when a row of the tile is 16-byte units
    stage_rows<kT>(reinterpret_cast<int8_t*>(dst), Rows8{S::kBN},
                   static_cast<const int8_t*>(src) + at, p.N, S::kBK, S::kBN,
                   depth, cols_valid, p.mode_b, tid);
  } else {
    const SmemTile bt = smem_tile(reinterpret_cast<__nv_bfloat16*>(dst), S::kBN);
    const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(src) + at;
    if (p.mode_b == 2)
      stage_rows16<kT, S::kBN>(bt.p, bt, b, p.N, S::kBK, depth, cols_valid,
                               tid);
    else
      stage_rows<kT>(bt.p, bt, b, p.N, S::kBK, S::kBN, depth, cols_valid,
                     p.mode_b, tid);
  }
}

// kB8: int8 weights (W8A16), widened to bf16 once each slab lands and
// scaled by sg / su on the flush, before the gate.
template <typename S, bool kB8>
__global__ void __launch_bounds__(S::kThreads)
gemm_gated_mma_kernel(const __nv_bfloat16* __restrict__ A,
                      const void* __restrict__ Bg,
                      const void* __restrict__ Bu,
                      const float* __restrict__ sg,
                      const float* __restrict__ su, void* C, GatedArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kBBytes = S::kBK * S::kBN * (kB8 ? 1 : 2);
  constexpr int kStage = S::template stage_bytes<kB8 ? 1 : 2>();
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
  auto stage_at = [&](int s) { return smem + s * kStage; };
  auto a_tile = [&](int s) {
    return smem_tile(reinterpret_cast<__nv_bfloat16*>(stage_at(s)), S::kBK);
  };
  auto g_tile = [&](int s) {
    return smem_tile(
        reinterpret_cast<__nv_bfloat16*>(stage_at(s) + S::kABytes), S::kBN);
  };
  auto u_tile = [&](int s) {
    return smem_tile(
        reinterpret_cast<__nv_bfloat16*>(stage_at(s) + S::kABytes + kBBytes),
        S::kBN);
  };
  auto g_bytes = [&](int s) {
    return reinterpret_cast<const int8_t*>(stage_at(s) + S::kABytes);
  };
  auto u_bytes = [&](int s) {
    return reinterpret_cast<const int8_t*>(stage_at(s) + S::kABytes +
                                           kBBytes);
  };
  // int8 weights: the landed gate and up slabs widened to bf16, after the
  // ring
  __nv_bfloat16* wide =
      reinterpret_cast<__nv_bfloat16*>(smem + S::kStages * kStage);
  const SmemTile gw = smem_tile(wide, S::kBN);
  const SmemTile uw = smem_tile(wide + S::kBK * S::kBN, S::kBN);
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
    stage_b<S, kB8>(stage_at(s) + S::kABytes, Bg, b_at, p, depth, cols_valid,
                    tid);
    stage_b<S, kB8>(stage_at(s) + S::kABytes + kBBytes, Bu, b_at, p, depth,
                    cols_valid, tid);
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
    const int s = i % S::kStages;
    // int8 weights, once landed, widened to bf16 by every thread (the MMA
    // warps of slab i - 1 are past the barrier above)
    if constexpr (kB8) {
      widen_int8<S::kThreads>(g_bytes(s), Rows8{S::kBN}, gw.p, Tile16{gw},
                              S::kBK, S::kBN, threadIdx.x);
      widen_int8<S::kThreads>(u_bytes(s), Rows8{S::kBN}, uw.p, Tile16{uw},
                              S::kBK, S::kBN, threadIdx.x);
      __syncthreads();
    }
    if (!mma_warp) continue;
    // the slab is zero-filled past K, so its last step runs whole
    const int depth = min(S::kBK, p.K - i * S::kBK);
    const int k_len = depth == S::kBK ? S::kBK : (depth + 15) & ~15;
    const SmemTile at = a_tile(s);
    if constexpr (kB8) {
      mma_slab<S::kFragM, S::kFragN, kEdge>(acc_g, at, wr, a_rows - wr, gw,
                                            wc, S::kBN - wc, k_len);
      mma_slab<S::kFragM, S::kFragN, kEdge>(acc_u, at, wr, a_rows - wr, uw,
                                            wc, S::kBN - wc, k_len);
    } else {
      mma_slab<S::kFragM, S::kFragN, kEdge>(acc_g, at, wr, a_rows - wr,
                                            g_tile(s), wc, S::kBN - wc, k_len);
      mma_slab<S::kFragM, S::kFragN, kEdge>(acc_u, at, wr, a_rows - wr,
                                            u_tile(s), wc, S::kBN - wc, k_len);
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
        float xg = acc_g[i][j][e], xu = acc_u[i][j][e];
        if constexpr (kB8) {
          xg = dequant(xg, sg, col0 + c);
          xu = dequant(xu, su, col0 + c);
        }
        store_out(C, at, __fmul_rn(activate(xg, p.act), xu), p.out_dtype,
                  nullptr);
      }
}

template <typename S, bool kB8>
int launch_mma(const void* a, const void* bg, const void* bu, const void* sg,
               const void* su, void* c, const GatedArgs& p,
               cudaStream_t stream) {
  auto kernel = gemm_gated_mma_kernel<S, kB8>;
  constexpr size_t kSmem = S::template smem<kB8 ? 1 : 2>();
  static bool configured = false;  // one attribute call per shape
  if (!configured) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kSmem));
    configured = true;
  }
  dim3 grid(cdiv(p.N, S::kBN), cdiv(p.M, S::kBM));
  kernel<<<grid, S::kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(a), bg, bu,
      static_cast<const float*>(sg), static_cast<const float*>(su), c, p);
  return static_cast<int>(cudaGetLastError());
}

// The CTA shapes of the tensor-core body, by the index kernels/gemm_gated.py
// BF16_TILES / INT8_TILES gives them (its (bm, bk, bn) must match): with
// m <= 16 one 16-row fragment and 2 MMA warps of one 8-column fragment of
// each product, 4 copy warps and 8 stages (8 x 12 KB of shared memory with
// bf16 weights); with more rows 64 x 64 (4 warps of 2 x 4 fragments of each
// product that stage too), 4 stages (96 KB with bf16 weights).  Slabs are
// 128 deep (64 for 64 x 64) with bf16 weights and twice as deep with int8
// ones, so a stage holds as many bytes of weights.
template <bool kB8>
int launch_tc(int config, const void* a, const void* bg, const void* bu,
              const void* sg, const void* su, void* c, const GatedArgs& p,
              cudaStream_t s) {
  constexpr int kD = kB8 ? 2 : 1;  // the slab depth's factor
  switch (config) {
    case 1:
      return launch_mma<GatedShape<1, 2, 1, 1, 128 * kD, 8, 4>, kB8>(
          a, bg, bu, sg, su, c, p, s);
    case 2:
      return launch_mma<GatedShape<2, 2, 2, 4, 64 * kD, 4>, kB8>(
          a, bg, bu, sg, su, c, p, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro

// A (m,k), Wg/Wu (k,n), C (m,n) row-major and contiguous; with int8
// weights (W8A16) sg / su (n,) f32 are their per-column dequant scales (or
// null), applied to each accumulator before the gate.  bf16 activations run
// the tensor-core body with CTA shape ``config`` (1 or 2, see launch_tc)
// and the staging copy modes ``modes`` (2 bits each: A, then both Bs); f32
// activations the fmaf body, which ignores both.  Returns
// cudaGetLastError() after the launch.
extern "C" int gemm_gated_launch(const void* a, const void* bg,
                                 const void* bu, const void* sg,
                                 const void* su, void* c, int m, int n,
                                 int k, int a_dtype, int b_dtype,
                                 int out_dtype, int act, int config,
                                 int modes, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dtype == kBF16) {
    GatedArgs p;
    p.M = m, p.N = n, p.K = k, p.act = act, p.out_dtype = out_dtype;
    p.mode_a = modes & 3, p.mode_b = (modes >> 2) & 3;
    return b_dtype == kI8
               ? launch_tc<true>(config, a, bg, bu, sg, su, c, p, s)
               : launch_tc<false>(config, a, bg, bu, sg, su, c, p, s);
  }
  return b_dtype == kI8
             ? launch_f32<int8_t>(a, bg, bu, sg, su, c, m, n, k, act,
                                  out_dtype, s)
             : launch_f32<float>(a, bg, bu, sg, su, c, m, n, k, act,
                                 out_dtype, s);
}
