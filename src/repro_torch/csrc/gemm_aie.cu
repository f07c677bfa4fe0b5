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
// only large-m prefill GEMMs reach the operations side.
//
// Design: one CTA owns one BM x BN tile of C and walks k inside the block,
// so nothing is carried between blocks (the TPU grid's sequential k axis
// becomes this loop).  Each k-step stages a BM x BK tile of A and a BK x BN
// tile of B in shared memory as f32 (bf16 widens exactly); each thread keeps
// BM/4 accumulators of one C column and reads each B element once per tile.
// The next step's tiles are loaded into registers while the current one is
// multiplied, so a CTA keeps its whole next tile of loads in flight (with
// few rows the kernel is latency-bound per CTA, not compute-bound).
// Ragged edges (k, n not tile multiples, m = 1..8) load zeros and are not
// stored, so no caller pads.
//
// Order invariance: every C element is one fmaf chain over k = 0, 1, ...,
// K-1 in that order (padding terms add exact zeros), whatever m is and
// wherever the row sits in the tile.  A row's result is therefore the same
// bits at batch 1 and inside a continuous batch, which is what keeps
// continuous-batched greedy decoding identical to solo greedy decoding.
#include "common.cuh"

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

}  // namespace
}  // namespace repro

// A (m,k), B (k,n), C (m,n) row-major and contiguous; bias (n,) f32 or
// null; residual (m,n) or null.  Returns cudaGetLastError() after the launch.
extern "C" int gemm_aie_launch(const void* a, const void* b, void* c,
                               const void* bias, const void* res, int m,
                               int n, int k, int in_dtype, int out_dtype,
                               int res_dtype, int act, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kBF16)
    launch_out<__nv_bfloat16>(out_dtype, res_dtype, a, b, c, bias, res, m, n,
                              k, act, s);
  else
    launch_out<float>(out_dtype, res_dtype, a, b, c, bias, res, m, n, k, act,
                      s);
  return static_cast<int>(cudaGetLastError());
}
