// gemm_gated — dual-B gated GEMM act(A Wg) * (A Wu), for Hopper.
//
// Replaces: repro/kernels/gemm_gated.py gemm_gated (pallas_call at :114,
// body _gated_kernel at :34): the SwiGLU gate/up pair in one pass.
//
// What bounds it on an H100: the two (k, n) weight matrices, read once each,
// on the decode path (m = 1..8); the operations only at large prefill m.
//
// Design: the gemm_aie tiling (csrc/gemm_aie.cu), with its register prefetch
// of the next k-step, and two B streams.  One A tile is staged per k-step and
// used against both the Wg and the Wu tile, so A is read once; two register
// accumulators hold the gate and up sums, and
// the flush computes act(acc_g) * acc_u in f32.  The (m, d_ff) gate/up
// intermediates never reach device memory.  The same order-invariance rule
// as gemm_aie holds: each accumulator is one fmaf chain over k in order,
// independent of m and of the row's position in the tile.
#include "common.cuh"

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

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
gemm_gated_kernel(const TIn* __restrict__ A, const TIn* __restrict__ Bg,
                  const TIn* __restrict__ Bu, TOut* __restrict__ C, int M,
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
      ra[it] = (gr < M && gc < K) ? to_f32(A[(size_t)gr * K + gc]) : 0.0f;
    }
#pragma unroll
    for (int it = 0; it < kBLoads; ++it) {
      const int i = tid + it * kThreads;
      const int gr = k0 + i / kBN, gc = col0 + i % kBN;
      const bool ok = gr < K && gc < N;
      const size_t at = (size_t)gr * N + gc;
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
    C[(size_t)row * N + col] = from_f32<TOut>(activate(acc_g[i], act) * acc_u[i]);
  }
}

template <typename TIn, typename TOut>
void launch(const void* a, const void* bg, const void* bu, void* c, int m,
            int n, int k, int act, cudaStream_t stream) {
  dim3 grid(cdiv(n, kBN), cdiv(m, kBM));
  gemm_gated_kernel<TIn, TOut><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(bg),
      static_cast<const TIn*>(bu), static_cast<TOut*>(c), m, n, k, act);
}

}  // namespace
}  // namespace repro

// A (m,k), Wg/Wu (k,n), C (m,n) row-major and contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int gemm_gated_launch(const void* a, const void* bg,
                                 const void* bu, void* c, int m, int n,
                                 int k, int in_dtype, int out_dtype, int act,
                                 void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kBF16) {
    if (out_dtype == kBF16)
      launch<__nv_bfloat16, __nv_bfloat16>(a, bg, bu, c, m, n, k, act, s);
    else
      launch<__nv_bfloat16, float>(a, bg, bu, c, m, n, k, act, s);
  } else {
    if (out_dtype == kBF16)
      launch<float, __nv_bfloat16>(a, bg, bu, c, m, n, k, act, s);
    else
      launch<float, float>(a, bg, bu, c, m, n, k, act, s);
  }
  return static_cast<int>(cudaGetLastError());
}
