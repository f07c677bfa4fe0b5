// gemm_grouped — the grouped ragged GEMM of the MoE experts (kernel B7), for
// Hopper.
//
// Replaces: repro/kernels/gemm_grouped.py gemm_grouped (pallas_call at :196,
// body _grouped_kernel at :90, steering tables group_metadata at :54).
// Computes C[r, :] = epilogue(A[r, :] @ B[g(r)]) for group-sorted rows: A is
// (m, k), B the (E, k, n) expert bank, g(r) the group that owns row r under
// group_sizes (E,); the epilogue is an optional per-expert bias (E, n) then
// silu / gelu(tanh) / relu, in f32 on the register flush.  Rows at and beyond
// sum(group_sizes) belong to no group and are left as the caller gave them
// (kernels/gemm_grouped.py hands in a zeroed C).
//
// What bounds it on an H100: the bytes of the expert banks.  At decode (64
// routed rows over some fifty experts) every live expert's k x n panel is
// streamed for one or two rows, so the kernel moves about a gigabyte a
// projection and does a few operations a byte; in prefill the rows per
// expert grow, but the banks still dominate the bytes.
//
// Design: the steering tables are built on the device by the wrapper with a
// static length tiles_m + E - 1 (kernels/gemm_grouped.py group_metadata), so
// no host ever learns the live instance count: the grid is the static worst
// case, blockIdx.x an n tile, blockIdx.y an instance (so the CTAs reading one
// expert's panel launch side by side and read its k-rows together), and a
// CTA at or past the live count (read from device memory) exits at once.  A live CTA owns
// the (bm x bn) C tile at m tile m_tile_ids[i] and streams the A rows of that
// tile and its expert's (k x bn) slab of B through two cp.async stages of
// kBK k-rows, so the next stage's loads are in flight during this stage's
// products.  A thread owns one C column and kRows rows (at most 4, templated
// so the row loops unroll to exactly the rows in use), and computes only
// the rows its group owns.
//
// No blend: the Pallas body merges a tile shared by several groups by
// reading its output block back (gemm_grouped.py:131), which is sound only
// because Pallas runs the instances in order.  Here instances run
// concurrently, so each CTA stores only the rows its group owns; the rows of
// a straddled tile are disjoint between its CTAs, and nothing is read back.
//
// Order invariance: every C element is one fmaf chain over k = 0..K-1 in
// that order (the zero-filled tail of the last stage adds exact zeros),
// flushed through the epilogue() of common.cuh that B1 and B6 use.  Row r of
// B7 is therefore B1's A[r] @ B[g(r)] bit for bit, and a token's expert
// output does not depend on which other tokens share the batch.
#include "staging.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;     // core/hardware.py B7_THREADS
constexpr int kMaxRows = 4;       // core/hardware.py B7_MAX_ROWS_PER_THREAD
constexpr int kBK = 64;           // k rows a stage (kernels/gemm_grouped.py)
constexpr int kMaxSmem = 232448;  // 227 KiB: one CTA's limit on sm_90

struct GroupedArgs {
  int M, N, K;
  int bm, bn;     // the plan's C tile
  int act;
  int out_dtype;  // kF32 / kBF16
  int mode_a, mode_b;  // staging modes (staging.cuh)
};

__host__ __device__ inline size_t smem_bytes(int bm, int bn, int in_size) {
  return 2 * static_cast<size_t>(bm + bn) * kBK * in_size;  // A + B, 2 stages
}

template <typename TIn, int kRows>
__global__ void __launch_bounds__(kThreads)
gemm_grouped_kernel(const TIn* __restrict__ A, const TIn* __restrict__ B,
                    void* C, const float* __restrict__ bias,
                    const int* __restrict__ offsets,
                    const int* __restrict__ group_ids,
                    const int* __restrict__ m_tile_ids,
                    const int* __restrict__ num_instances, GroupedArgs p) {
  const int inst = blockIdx.y;
  if (inst >= *num_instances) return;  // past the live count
  const int g = group_ids[inst];
  const int row0 = m_tile_ids[inst] * p.bm;
  // the rows of this tile that group g owns
  const int lo = max(offsets[g], row0);
  const int hi = min(min(offsets[g + 1], row0 + p.bm), p.M);
  if (lo >= hi) return;

  extern __shared__ __align__(16) unsigned char smem[];
  const int bm = p.bm, bn = p.bn;
  TIn* As = reinterpret_cast<TIn*>(smem);  // 2 stages of bm x kBK
  TIn* Bs = As + 2 * bm * kBK;             // 2 stages of kBK x bn
  const int col0 = blockIdx.x * bn;
  const int rows_valid = min(bm, p.M - row0);
  const int cols_valid = min(bn, p.N - col0);
  const int groups = kThreads / bn;  // row groups of bn threads
  const int tx = threadIdx.x % bn, ty = threadIdx.x / bn;
  // rows r = ty, ty + groups, ... < bm of this thread (0 for idle threads);
  // bit i of live: row ty + groups * i belongs to group g.  A warp's 32
  // threads share ty (bn is a multiple of 32), so the branches on live
  // are uniform, and a warp whose rows all belong to other groups skips
  // the products: at decode a tile holds one or two of g's rows.
  const int my_rows =
      ty < groups ? max(0, (bm - ty + groups - 1) / groups) : 0;
  unsigned live = 0;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = row0 + ty + groups * i;
    if (i < my_rows && row >= lo && row < hi) live |= 1u << i;
  }
  const TIn* Bg = B + static_cast<size_t>(g) * p.K * p.N;

  auto issue = [&](int k0, int s) {
    const int kc = min(kBK, p.K - k0);
    stage<kThreads>(As + s * bm * kBK, kBK,
                    A + static_cast<size_t>(row0) * p.K + k0, p.K, bm, kBK,
                    rows_valid, kc, p.mode_a);
    stage<kThreads>(Bs + s * kBK * bn, bn,
                    Bg + static_cast<size_t>(k0) * p.N + col0, p.N, kBK, bn,
                    kc, cols_valid, p.mode_b);
  };

  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.0f;
  issue(0, 0);
  cp_async_commit();
  for (int k0 = 0, s = 0; k0 < p.K; k0 += kBK, s ^= 1) {
    if (k0 + kBK < p.K) {
      issue(k0 + kBK, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live != 0) {
      const TIn* At = As + s * bm * kBK;
      const TIn* Bt = Bs + s * kBK * bn;
#pragma unroll 4
      for (int kk = 0; kk < kBK; kk += 4) {
        const float b0 = to_f32(Bt[(kk + 0) * bn + tx]);
        const float b1 = to_f32(Bt[(kk + 1) * bn + tx]);
        const float b2 = to_f32(Bt[(kk + 2) * bn + tx]);
        const float b3 = to_f32(Bt[(kk + 3) * bn + tx]);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (live & (1u << i)) {
            float a[4];
            load4(At + (ty + groups * i) * kBK + kk, a);
            acc[i] = fmaf(a[0], b0, acc[i]);
            acc[i] = fmaf(a[1], b1, acc[i]);
            acc[i] = fmaf(a[2], b2, acc[i]);
            acc[i] = fmaf(a[3], b3, acc[i]);
          }
        }
      }
    }
    __syncthreads();  // stage s is refilled by the next iteration's issue
  }

  if (tx >= cols_valid) return;
  const int col = col0 + tx;
  const bool has_bias = bias != nullptr;
  const float bv =
      has_bias ? bias[static_cast<size_t>(g) * p.N + col] : 0.0f;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (!(live & (1u << i))) continue;
    const int row = row0 + ty + groups * i;
    const float x = epilogue(acc[i], has_bias, bv, p.act, false, 0.0f);
    const size_t at = static_cast<size_t>(row) * p.N + col;
    if (p.out_dtype == kBF16)
      static_cast<__nv_bfloat16*>(C)[at] = from_f32<__nv_bfloat16>(x);
    else
      static_cast<float*>(C)[at] = x;
  }
}

template <typename TIn, int kRows>
int launch_rows(const void* a, const void* b, void* c, const void* bias,
                const int* offsets, const int* group_ids,
                const int* m_tile_ids, const int* num_instances,
                int n_instances, const GroupedArgs& p, size_t smem,
                cudaStream_t stream) {
  auto kernel = gemm_grouped_kernel<TIn, kRows>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxSmem);
    configured = true;
  }
  dim3 grid((p.N + p.bn - 1) / p.bn, n_instances);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b), c,
      static_cast<const float*>(bias), offsets, group_ids, m_tile_ids,
      num_instances, p);
  return static_cast<int>(cudaGetLastError());
}

// Checks the tile against the kernel's limits and picks the row count a
// thread needs.
template <typename TIn>
int launch(const void* a, const void* b, void* c, const void* bias,
           const int* offsets, const int* group_ids, const int* m_tile_ids,
           const int* num_instances, int n_instances, const GroupedArgs& p,
           cudaStream_t stream) {
  if (p.bn < 1 || p.bn > kThreads || p.bm < 1 || n_instances < 1 ||
      n_instances > 65535)  // gridDim.y's limit
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = kThreads / p.bn;
  const int rows = (p.bm + groups - 1) / groups;
  const size_t smem = smem_bytes(p.bm, p.bn, sizeof(TIn));
  if (rows > kMaxRows || smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 1)
    return launch_rows<TIn, 1>(a, b, c, bias, offsets, group_ids, m_tile_ids,
                               num_instances, n_instances, p, smem, stream);
  if (rows <= 2)
    return launch_rows<TIn, 2>(a, b, c, bias, offsets, group_ids, m_tile_ids,
                               num_instances, n_instances, p, smem, stream);
  return launch_rows<TIn, kMaxRows>(a, b, c, bias, offsets, group_ids,
                                    m_tile_ids, num_instances, n_instances, p,
                                    smem, stream);
}

}  // namespace
}  // namespace repro

// A (m,k) group-sorted rows, B (E,k,n), C (m,n) row-major and contiguous;
// bias (E,n) f32 or null.  offsets (E+1,), group_ids and m_tile_ids
// (n_instances,) and num_instances (a scalar) are int32 on the device.
// Returns cudaGetLastError() after the launch.
extern "C" int gemm_grouped_launch(const void* a, const void* b, void* c,
                                   const void* bias, const void* offsets,
                                   const void* group_ids,
                                   const void* m_tile_ids,
                                   const void* num_instances, int n_instances,
                                   int m, int n, int k, int bm, int bn,
                                   int in_dtype, int out_dtype, int act,
                                   int mode_a, int mode_b, void* stream) {
  using namespace repro;
  GroupedArgs p;
  p.M = m, p.N = n, p.K = k, p.bm = bm, p.bn = bn, p.act = act;
  p.out_dtype = out_dtype, p.mode_a = mode_a, p.mode_b = mode_b;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* offs = static_cast<const int*>(offsets);
  const int* gids = static_cast<const int*>(group_ids);
  const int* tids = static_cast<const int*>(m_tile_ids);
  const int* live = static_cast<const int*>(num_instances);
  if (in_dtype == kBF16)
    return launch<__nv_bfloat16>(a, b, c, bias, offs, gids, tids, live,
                                 n_instances, p, s);
  return launch<float>(a, b, c, bias, offs, gids, tids, live, n_instances, p,
                       s);
}
