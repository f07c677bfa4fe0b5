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
// streamed for one or two rows; in prefill (2400 rows, about 19 an expert)
// the banks still dominate the bytes and the products stay far below the
// tensor cores' rate.  So the design streams each live panel once, with
// enough bytes in flight on every SM (one SM streams 5.5 / 9.2 / 13.5 B a
// cycle with 32 / 64 / 128 KB of cp.async in flight: PERF.md §6).
//
// Steering: the tables are built on the device with a static length
// tiles_m + E - 1 at the CTA's m tile (grouped_tables_kernel below, the
// function of kernels/gemm_grouped.py group_metadata), so no host ever learns
// the live instance count: the grid is the static worst case, blockIdx.x an
// n tile, blockIdx.y an instance (so the CTAs reading one expert's panel
// launch side by side and read its k-rows together), and a CTA at or past
// the live count (read from device memory) exits at once.  A live CTA owns
// the rows [lo, lo + rows) of its m tile that its group owns, and the
// columns of its n tile.  The CTAs zero the rows past the groups between
// them, so C needs no clearing first.
//
// Design (bf16 operands): B1's tensor-core chain (mma_chain.cuh) on the
// group's rows, fed by the tensor memory accelerator.  One thread fills each
// stage of a ring of kStages with a few box copies (the expert's BK x 64
// column panels of B, and the group's rows of A from its first row, 16 at a
// time), which land on the stage's mbarrier in the 128-byte swizzle that
// mma_chain.cuh's ldmatrix reads; several stages are in flight while the
// warps multiply the oldest.  A warp whose 16-row block holds none of the
// group's rows skips the products.  The wrapper (kernels/gemm_grouped.py
// cta_tile) picks the CTA shape by rows per expert: at decode one 16-row
// block and eight warps across a 128-column n tile, 128-deep slabs, four
// stages (144 KB: one CTA an SM, 108 KB of B in flight), so no warp idles
// on rows another group owns; in prefill a 64-row m tile of four 16-row
// blocks by two 64-column halves, 64-deep slabs, four stages (96 KB, two
// CTAs an SM), so most experts' rows fit one instance and their panels
// stream once.  An operand whose rows are not whole 16-byte units (no
// tensor map) is staged by cp.async into the same layout instead.
//
// W8A16 (repro/kernels/gemm_grouped.py:109-111, :177): an int8 expert bank is
// staged as 128-column panels of 128-byte rows (the same tensor-map box
// and 128-byte swizzle, now over int8; cp.async rows that are not whole
// 16-byte units, here 16 columns, in the same layout), widened in registers
// as ldmatrix reads it (mma_chain.cuh mma_slab_b8: the bf16 chain on the
// widened values, no conversion pass and no extra barrier), and scaled on
// the flush by its expert's row of the (E, 1, n) scale, steered by the same
// tables; an int8 row equals B1's W8A16 row bit for bit.  The f32 body
// takes an int8 bank too.
//
// f32 operands keep the CUDA-core body (gemm_grouped_f32_kernel): a thread
// owns one C column and kRows rows of the tile, and one fmaf chain over
// k = 0..K-1 per element, through two cp.async stages.
//
// No blend: the Pallas body merges a tile shared by several groups by
// reading its output block back (gemm_grouped.py:131), which is sound only
// because Pallas runs the instances in order.  Here instances run
// concurrently, so each CTA stores only the rows its group owns; the rows of
// a straddled tile are disjoint between its CTAs, and nothing is read back.
//
// Order invariance: every C element is B1's chain, flushed through the
// epilogue() of common.cuh that B1 and B6 use: for bf16 one mma.sync
// m16n8k16 sequence over k = 0, 16, 32, ... ascending, from zero, the k tail
// zero-filled up to the 16-grid (mma_chain.cuh's mma_slab, the one B1 runs);
// for f32 one fmaf chain over k in order.  Nothing splits k.  Row r of B7 is
// therefore B1's A[r] @ B[g(r)] on the same operands bit for bit, at any CTA
// shape, group layout or batch, and a token's expert output does not depend
// on which other tokens share the batch.
#include "mma_chain.cuh"
#include "staging.cuh"
#include "tma.cuh"

namespace repro {
namespace {

constexpr int kMaxSmem = 232448;  // 227 KiB: one CTA's limit on sm_90
constexpr int kSmSmem = 233472;   // 228 KiB: one SM's shared memory

struct GroupedArgs {
  int M, N, K, E;
  int bm, bn;     // the C tile (the f32 body's; the bf16 shape fixes its own)
  int act;
  int out_dtype;  // kF32 / kBF16
  int mode_a, mode_b;  // staging modes (staging.cuh)
};

// The instance this CTA runs (blockIdx.y) on an m tile of bm rows: its group
// g, the tile's first row row0, and the rows [lo, hi) of the tile that g
// owns.  False for an instance past the live count or an empty row range.
__device__ __forceinline__ bool instance_rows(const int* offsets,
                                              const int* group_ids,
                                              const int* m_tile_ids,
                                              const int* num_instances,
                                              int bm, int M, int& g,
                                              int& row0, int& lo, int& hi) {
  const int inst = blockIdx.y;
  if (inst >= *num_instances) return false;  // past the live count
  g = group_ids[inst];
  row0 = m_tile_ids[inst] * bm;
  lo = max(offsets[g], row0);
  hi = min(min(offsets[g + 1], row0 + bm), M);
  return lo < hi;
}

// Rows at and past the groups' end belong to no group: every CTA of the
// grid zeroes its share of them, before it looks at its instance.
__device__ __forceinline__ void zero_tail(void* C, const int* offsets,
                                          const GroupedArgs& p) {
  const size_t end = static_cast<size_t>(p.M) * p.N;
  const size_t step =
      static_cast<size_t>(gridDim.x) * gridDim.y * blockDim.x;
  for (size_t i = static_cast<size_t>(min(offsets[p.E], p.M)) * p.N +
                  (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                      blockDim.x +
                  threadIdx.x;
       i < end; i += step) {
    if (p.out_dtype == kBF16)
      static_cast<__nv_bfloat16*>(C)[i] = from_f32<__nv_bfloat16>(0.0f);
    else
      static_cast<float*>(C)[i] = 0.0f;
  }
}

// An exclusive prefix sum over the kTablesThreads threads of a CTA, and the
// total; every thread calls it.
constexpr int kTablesThreads = 256;

__device__ __forceinline__ int block_exclusive_sum(int x, int& total) {
  __shared__ int warp_sums[kTablesThreads / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[w] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int i = 0; i < kTablesThreads / 32; ++i) {
    before += i < w ? warp_sums[i] : 0;
    total += warp_sums[i];
  }
  __syncthreads();  // warp_sums is free for the next call
  return before + incl - x;
}

// The steering tables of group_metadata (kernels/gemm_grouped.py) in one
// CTA: offsets (E + 1) the groups' row offsets; the live instances in group
// order, group g owning the m tiles floor(start / bm) .. ceil(end / bm) - 1
// (none when empty), their count in num_instances.  The entries past it
// pad as the reference's repeats do: the last group, and the m tiles after
// the last live one, then the last m tile.  Thread t takes a run of
// ceil(E / 256) groups; two prefix sums over the threads give each run its
// first row and its first instance.
__global__ void __launch_bounds__(kTablesThreads)
grouped_tables_kernel(const int* __restrict__ sizes, int e, int m, int bm,
                      int n_instances, int* __restrict__ offsets,
                      int* __restrict__ group_ids,
                      int* __restrict__ m_tile_ids,
                      int* __restrict__ num_instances) {
  const int per = (e + kTablesThreads - 1) / kTablesThreads;
  const int g0 = min(e, static_cast<int>(threadIdx.x) * per);
  const int g1 = min(e, g0 + per);
  int rows = 0;
  for (int g = g0; g < g1; ++g) rows += sizes[g];
  int all_rows;
  const int start = block_exclusive_sum(rows, all_rows);
  int count = 0;
  for (int g = g0, s = start; g < g1; ++g) {
    const int end = s + sizes[g];
    offsets[g + 1] = end;
    if (end > s) count += (end + bm - 1) / bm - s / bm;
    s = end;
  }
  if (threadIdx.x == 0) offsets[0] = 0;
  int all_instances;
  int inst = block_exclusive_sum(count, all_instances);
  for (int g = g0, s = start; g < g1; ++g) {
    const int end = s + sizes[g];
    if (end > s)
      for (int t = s / bm; t < (end + bm - 1) / bm; ++t, ++inst)
        if (inst < n_instances) group_ids[inst] = g, m_tile_ids[inst] = t;
    s = end;
  }
  const int live = min(all_instances, n_instances);
  if (threadIdx.x == 0) *num_instances = live;
  const int next_tile = all_rows > 0 ? (all_rows - 1) / bm + 1 : 0;
  const int last_tile = (m + bm - 1) / bm - 1;
  for (int i = live + threadIdx.x; i < n_instances; i += kTablesThreads)
    group_ids[i] = e - 1,
    m_tile_ids[i] = min(next_tile + (i - live), last_tile);
}

// ---------------------------------------------------------------------------
// The CUDA-core body (f32 operands)
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kRows = 4;    // rows a thread at either f32 tile
constexpr int kF32BK = 64;  // k rows a stage

template <typename TB>
__global__ void __launch_bounds__(kF32Threads)
gemm_grouped_f32_kernel(const float* __restrict__ A,
                        const TB* __restrict__ B, void* C,
                        const float* __restrict__ bias,
                        const float* __restrict__ scale,
                        const int* __restrict__ offsets,
                        const int* __restrict__ group_ids,
                        const int* __restrict__ m_tile_ids,
                        const int* __restrict__ num_instances,
                        GroupedArgs p) {
  zero_tail(C, offsets, p);
  int g, row0, lo, hi;
  if (!instance_rows(offsets, group_ids, m_tile_ids, num_instances, p.bm,
                     p.M, g, row0, lo, hi))
    return;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bm = p.bm, bn = p.bn;
  float* As = reinterpret_cast<float*>(smem);  // 2 stages of bm x kF32BK
  TB* Bs = reinterpret_cast<TB*>(As + 2 * bm * kF32BK);  // 2 of kF32BK x bn
  const int col0 = blockIdx.x * bn;
  const int rows_valid = min(bm, p.M - row0);
  const int cols_valid = min(bn, p.N - col0);
  const int groups = kF32Threads / bn;  // row groups of bn threads
  const int tx = threadIdx.x % bn, ty = threadIdx.x / bn;
  // rows r = ty, ty + groups, ... < bm of this thread (kRows at both tiles);
  // bit i of live: row ty + groups * i belongs to group g.  A warp's 32
  // threads share ty (bn is a multiple of 32), so the branches on live
  // are uniform, and a warp whose rows all belong to other groups skips
  // the products.
  const int my_rows =
      ty < groups ? max(0, (bm - ty + groups - 1) / groups) : 0;
  unsigned live = 0;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = row0 + ty + groups * i;
    if (i < my_rows && row >= lo && row < hi) live |= 1u << i;
  }
  const TB* Bg = B + static_cast<size_t>(g) * p.K * p.N;

  auto issue = [&](int k0, int s) {
    const int kc = min(kF32BK, p.K - k0);
    stage<kF32Threads>(As + s * bm * kF32BK, kF32BK,
                       A + static_cast<size_t>(row0) * p.K + k0, p.K, bm,
                       kF32BK, rows_valid, kc, p.mode_a);
    stage<kF32Threads>(Bs + s * kF32BK * bn, bn,
                       Bg + static_cast<size_t>(k0) * p.N + col0, p.N,
                       kF32BK, bn, kc, cols_valid, p.mode_b);
  };

  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.0f;
  issue(0, 0);
  cp_async_commit();
  for (int k0 = 0, s = 0; k0 < p.K; k0 += kF32BK, s ^= 1) {
    if (k0 + kF32BK < p.K) {
      issue(k0 + kF32BK, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live != 0) {
      const float* At = As + s * bm * kF32BK;
      const TB* Bt = Bs + s * kF32BK * bn;
#pragma unroll 4
      for (int kk = 0; kk < kF32BK; kk += 4) {
        // an int8 bank (W8A16 on f32 activations) widens as it is read
        const float b0 = to_f32(Bt[(kk + 0) * bn + tx]);
        const float b1 = to_f32(Bt[(kk + 1) * bn + tx]);
        const float b2 = to_f32(Bt[(kk + 2) * bn + tx]);
        const float b3 = to_f32(Bt[(kk + 3) * bn + tx]);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (live & (1u << i)) {
            float a[4];
            load4(At + (ty + groups * i) * kF32BK + kk, a);
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
    const float x = epilogue(
        dequant(acc[i],
                scale != nullptr ? scale + static_cast<size_t>(g) * p.N
                                 : nullptr,
                col),
        has_bias, bv, p.act, false, 0.0f);
    store_out(C, static_cast<size_t>(row) * p.N + col, x, p.out_dtype,
              nullptr);
  }
}

// The operands of one launch: A, the bank B, C, and the per-expert bias
// and (an int8 bank's) scale rows, or null.
struct GroupedOperands {
  const void *a, *b;
  void* c;
  const float *bias, *scale;
};

// The f32 body's C tiles, by the config index kernels/gemm_grouped.py
// F32_TILES gives them: 8 x 128 at decode, 16 x 64 in prefill.  TB is the
// bank's type (f32, or int8).
template <typename TB>
int launch_f32(int config, const GroupedOperands& o, const int* offsets,
               const int* group_ids,
               const int* m_tile_ids, const int* num_instances,
               int n_instances, GroupedArgs p, cudaStream_t stream) {
  if (config == 1)
    p.bm = 8, p.bn = 128;
  else if (config == 2)
    p.bm = 16, p.bn = 64;
  else
    return static_cast<int>(cudaErrorInvalidValue);
  // A + B, 2 stages
  const size_t smem = 2 * static_cast<size_t>(kF32BK) *
                      (p.bm * sizeof(float) + p.bn * sizeof(TB));
  auto kernel = gemm_grouped_f32_kernel<TB>;
  static bool configured = false;  // one attribute call
  if (!configured) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxSmem);
    configured = true;
  }
  dim3 grid(cdiv(p.N, p.bn), n_instances);
  kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(o.a), static_cast<const TB*>(o.b), o.c,
      o.bias, o.scale, offsets, group_ids, m_tile_ids, num_instances, p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The tensor-core body (bf16 operands)
// ---------------------------------------------------------------------------

// A CTA shape: kWM x kWN MMA warps, each owning one 16-row block of the m
// tile and kFN m16n8 fragments of the n tile, so a BM x BN tile of C;
// BK-deep slabs (a multiple of 64) through a ring of kStages stages.  A
// stage holds the A slab as BK / 64 panels of BM rows x 64 columns, then
// the B slab as BN / 64 panels of BK rows x 64 columns, each panel 128
// bytes a row in the tensor memory accelerator's 128-byte swizzle (=
// mma_chain.cuh's smem_tile(p, 64)).  Two CTAs share an SM when their
// shared memory fits.
template <int kWM, int kWN, int kFN, int kBK_, int kStages_>
struct GroupedShape {
  static constexpr int kWarps = kWM * kWN, kThreads = 32 * kWarps;
  static constexpr int kBM = 16 * kWM, kBN = 8 * kFN * kWN;
  static constexpr int kBK = kBK_, kStages = kStages_;
  static constexpr int kWarpN = kWN, kFragN = kFN;
  static_assert(kBK % 64 == 0 && kBN % 64 == 0 && 64 % (8 * kFN) == 0,
                "whole 64-column panels, a warp's columns inside one");
  static constexpr int kAElems = kBM * kBK;
  static constexpr int kStageElems = kAElems + kBK * kBN;
  // the ring, and 1 KB to align it to the swizzle's 1024-byte period
  static constexpr size_t kSmem =
      2 * static_cast<size_t>(kStages) * kStageElems + 1024;
  // with the ring's barriers and the 1 KB the card reserves for each CTA
  static constexpr int kMinBlocks =
      2 * (kSmem + 8 * kStages + 1024) <= kSmSmem ? 2 : 1;
};

// The same for an int8 bank: 128-column panels of kRows rows of 128 bytes,
// each in the 128-byte swizzle (mma_chain.cuh Swz128).
template <int kRows>
struct Panels8 {
  __device__ __forceinline__ int at(int r, int c) const {
    return (c >> 7) * (kRows * 128) + Swz128{}.at(r, c & 127);
  }
};

// With tensor maps (tma), thread 0 fills a stage with box copies; without
// (an operand whose rows are not whole 16-byte units), every thread stages
// it by cp.async, zero-filled, into the same layout.  kB8: an int8 bank
// (W8A16), staged as 128-column panels at one byte an element, widened in
// registers as the chain reads it (mma_slab_b8), and scaled by its
// expert's row of ``scale`` on the flush.
template <typename S, bool kB8>
__global__ void __launch_bounds__(S::kThreads, S::kMinBlocks)
gemm_grouped_mma_kernel(const __nv_bfloat16* __restrict__ A,
                        const void* __restrict__ B, void* C,
                        const float* __restrict__ bias,
                        const float* __restrict__ scale,
                        const int* __restrict__ offsets,
                        const int* __restrict__ group_ids,
                        const int* __restrict__ m_tile_ids,
                        const int* __restrict__ num_instances,
                        const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b,
                        GroupedArgs p, bool tma) {
  zero_tail(C, offsets, p);
  int g, row0, lo, hi;
  if (!instance_rows(offsets, group_ids, m_tile_ids, num_instances, S::kBM,
                     p.M, g, row0, lo, hi))
    return;
  const int rows = hi - lo;  // the group's rows, from A tile row 0
  // rows staged: rounded up to whole 16-row blocks; a 16-row tile with at
  // most 8 rows uses 8, and its fragment's other 8 read as zero (B1's edge)
  constexpr bool kEdge = S::kBM == 16;
  const int a_rows =
      kEdge && rows <= 8 ? 8 : min(S::kBM, (rows + 15) & ~15);
  const int col0 = blockIdx.x * S::kBN;
  const int cols_valid = min(S::kBN, p.N - col0);
  const int warp = threadIdx.x >> 5;
  const int wr = (warp / S::kWarpN) * 16;               // warp's rows
  const int wc = (warp % S::kWarpN) * 8 * S::kFragN;   // warp's columns
  // a warp whose 16-row block holds none of the group's rows skips the
  // products (uniform over the warp)
  const bool live = wr < rows;

  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kBBytes = S::kBK * S::kBN * (kB8 ? 1 : 2);
  constexpr int kStage = 2 * S::kAElems + kBBytes;
  unsigned char* ring = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  auto a_slab = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(ring + s * kStage);
  };
  auto b_slab = [&](int s) { return ring + s * kStage + 2 * S::kAElems; };
  __shared__ uint64_t full[S::kStages];  // stage s has landed
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int slabs = (p.K + S::kBK - 1) / S::kBK;
  auto load = [&](int slab) {
    const int s = slab % S::kStages, k0 = slab * S::kBK;
    if (tma) {
      if (threadIdx.x == 0) {
        // the stage's last generic reads (ldmatrix), then the copy
        // engine's writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const int a_boxes = (a_rows + 15) / 16;  // 16 rows x 64 columns
        mbar_expect(&full[s], 2 * a_boxes * 16 * S::kBK + kBBytes);
        for (int u = 0; u < S::kBK / 64; ++u)
          for (int i = 0; i < a_boxes; ++i)
            tma_2d(a_slab(s) + u * S::kBM * 64 + i * 16 * 64, &map_a,
                   k0 + 64 * u, lo + 16 * i, &full[s]);
        // BK rows x 64 bf16 columns, or x 128 int8 columns: 128-byte rows
        constexpr int kPanel = kB8 ? 128 : 64;
        for (int h = 0; h < S::kBN / kPanel; ++h)
          tma_3d(b_slab(s) + h * S::kBK * 128, &map_b, col0 + kPanel * h, k0,
                 g, &full[s]);
      }
    } else {
      constexpr int kT = S::kThreads;
      const int depth = min(S::kBK, p.K - k0);
      const __nv_bfloat16* a = A + static_cast<size_t>(lo) * p.K + k0;
      const size_t b_at = static_cast<size_t>(g) * p.K * p.N +
                          static_cast<size_t>(k0) * p.N + col0;
      stage_rows<kT>(a_slab(s), Panels<S::kBM>{}, a, p.K, a_rows, S::kBK,
                     rows, depth, p.mode_a, threadIdx.x);
      if constexpr (kB8)
        stage_rows<kT>(reinterpret_cast<int8_t*>(b_slab(s)), Panels8<S::kBK>{},
                       static_cast<const int8_t*>(B) + b_at, p.N, S::kBK,
                       S::kBN, depth, cols_valid, p.mode_b, threadIdx.x);
      else
        stage_rows<kT>(reinterpret_cast<__nv_bfloat16*>(b_slab(s)),
                       Panels<S::kBK>{},
                       static_cast<const __nv_bfloat16*>(B) + b_at, p.N,
                       S::kBK, S::kBN, depth, cols_valid, p.mode_b,
                       threadIdx.x);
      if (threadIdx.x == 0) mbar_arrive(&full[s]);
    }
  };

  float acc[1][S::kFragN][4];
#pragma unroll
  for (int j = 0; j < S::kFragN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][j][e] = 0.0f;

  // The ring: kStages - 1 slabs in flight before the first products; slab
  // i + kStages - 1 is issued in iteration i, into the stage that slab
  // i - 1 left, after the barrier that says every warp is done with it, so
  // the wait for a slab overlaps the products of the slab before it.
  for (int s = 0; s < S::kStages - 1; ++s) {
    if (s < slabs) load(s);
    cp_async_commit();
  }
  for (int i = 0; i < slabs; ++i) {
    const int s = i % S::kStages;
    cp_async_wait<S::kStages - 2>();
    mbar_wait(&full[s], (i / S::kStages) & 1);
    __syncthreads();  // slab i landed; every warp is done with slab i - 1
    if (i + S::kStages - 1 < slabs) load(i + S::kStages - 1);
    cp_async_commit();
    if (!live) continue;
    // the k tail reads zeros up to the 16-grid (out of the tensor, or
    // zero-filled)
    const int k_len = (min(S::kBK, p.K - i * S::kBK) + 15) & ~15;
#pragma unroll
    for (int u = 0; u < S::kBK / 64; ++u) {
      const int kl = min(64, k_len - 64 * u);
      if (kl <= 0) break;
      const SmemTile at = smem_tile(a_slab(s) + u * S::kBM * 64, 64);
      if constexpr (kB8) {  // the warp's 128-column int8 panel, widened
        mma_slab_b8<1, S::kFragN, kEdge>(
            acc, at, wr, a_rows - wr,
            smem_tile(reinterpret_cast<__nv_bfloat16*>(
                          b_slab(s) + (wc >> 7) * S::kBK * 128 +
                          u * 64 * 128),
                      64),
            wc & 127, kl);
      } else {  // the warp's 64-column bf16 panel and its column there
        const int wh = wc >> 6, wcol = wc & 63;
        mma_slab<1, S::kFragN, kEdge>(
            acc, at, wr, a_rows - wr,
            smem_tile(reinterpret_cast<__nv_bfloat16*>(b_slab(s)) +
                          wh * S::kBK * 64 + u * 64 * 64,
                      64),
            wcol, 64 - wcol, kl);
      }
    }
  }

  if (!live) return;
  const bool has_bias = bias != nullptr;
  const float* bg = has_bias ? bias + static_cast<size_t>(g) * p.N : nullptr;
#pragma unroll
  for (int j = 0; j < S::kFragN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = wr + frag_row(0, e),
                col = wc + (kB8 ? b8_col(j, e) : frag_col(j, e));
      if (r >= rows || col >= cols_valid) continue;
      const size_t at = static_cast<size_t>(lo + r) * p.N + col0 + col;
      float x = acc[0][j][e];
      if constexpr (kB8)
        x = dequant(x,
                    scale != nullptr ? scale + static_cast<size_t>(g) * p.N
                                     : nullptr,
                    col0 + col);
      x = epilogue(x, has_bias, has_bias ? bg[col0 + col] : 0.0f, p.act,
                   false, 0.0f);
      store_out(C, at, x, p.out_dtype, nullptr);
    }
}

template <typename S, bool kB8>
int launch_mma(const GroupedOperands& o, const int* offsets,
               const int* group_ids, const int* m_tile_ids,
               const int* num_instances, int n_instances,
               const GroupedArgs& p, cudaStream_t stream) {
  auto kernel = gemm_grouped_mma_kernel<S, kB8>;
  // the ring (its B slab at the bank's width) and the 1 KB alignment slack
  constexpr size_t kSmem =
      static_cast<size_t>(S::kStages) *
          (2 * S::kAElems + S::kBK * S::kBN * (kB8 ? 1 : 2)) +
      1024;
  static bool configured = false;  // one attribute call per shape
  if (!configured) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kSmem));
    configured = true;
  }
  const int eb = kB8 ? 1 : 2;  // the bank's bytes an element
  // tensor maps need 16-byte aligned bases and rows (copy mode 2): A as
  // (M rows, K), B as (E, K rows, N)
  CUtensorMap map_a{}, map_b{};
  bool tma = p.mode_a == 2 && p.mode_b == 2;
  if (tma) {
    const cuuint64_t da[2] = {static_cast<cuuint64_t>(p.K),
                              static_cast<cuuint64_t>(p.M)};
    const cuuint64_t sa[1] = {static_cast<cuuint64_t>(p.K) * 2};
    const cuuint64_t db[3] = {static_cast<cuuint64_t>(p.N),
                              static_cast<cuuint64_t>(p.K),
                              static_cast<cuuint64_t>(p.E)};
    const cuuint64_t sb[2] = {static_cast<cuuint64_t>(p.N) * eb,
                              static_cast<cuuint64_t>(p.N) * p.K * eb};
    tma = tensor_map(&map_a, o.a, false, 2, da, sa, 16) &&
          tensor_map(&map_b, o.b, kB8, 3, db, sb, S::kBK);
  }
  dim3 grid(cdiv(p.N, S::kBN), n_instances);
  kernel<<<grid, S::kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(o.a), o.b, o.c, o.bias, o.scale,
      offsets, group_ids, m_tile_ids, num_instances, map_a, map_b, p, tma);
  return static_cast<int>(cudaGetLastError());
}

// The CTA shapes of the tensor-core body, by the index kernels/gemm_grouped.py
// BF16_TILES / INT8_TILES gives them (its (bm, bk, bn) must match): 1 at
// decode, one 16-row block by eight warps of 16 columns, 4 stages, 128-deep
// slabs with a bf16 bank (144 KB) and 256-deep with an int8 one (as many
// bytes of B a stage, 96 KB of it in flight; 161 KB); 2 in prefill, four
// 16-row blocks by two warps of 64 columns, 64-deep slabs, 4 stages (96 KB
// bf16, 65 KB int8: two CTAs an SM).
template <bool kB8>
int launch_tc(int config, const GroupedOperands& o, const int* offsets,
              const int* group_ids, const int* m_tile_ids,
              const int* num_instances, int n_instances,
              const GroupedArgs& p, cudaStream_t s) {
  switch (config) {
    case 1:
      return launch_mma<GroupedShape<1, 8, 2, kB8 ? 256 : 128, 4>, kB8>(
          o, offsets, group_ids, m_tile_ids, num_instances, n_instances, p,
          s);
    case 2:
      return launch_mma<GroupedShape<4, 2, 8, 64, 4>, kB8>(
          o, offsets, group_ids, m_tile_ids, num_instances, n_instances, p,
          s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro

// The steering tables of m rows over the E groups of sizes (int32, on the
// device) at an m tile of bm rows, into offsets (E+1,), group_ids and
// m_tile_ids (n_instances,) and num_instances (a scalar), int32 on the
// device.  Returns cudaGetLastError() after the launch.
extern "C" int grouped_tables_launch(const void* sizes, int e, int m, int bm,
                                     int n_instances, void* offsets,
                                     void* group_ids, void* m_tile_ids,
                                     void* num_instances, void* stream) {
  using namespace repro;
  grouped_tables_kernel<<<1, kTablesThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sizes), e, m, bm, n_instances,
      static_cast<int*>(offsets), static_cast<int*>(group_ids),
      static_cast<int*>(m_tile_ids), static_cast<int*>(num_instances));
  return static_cast<int>(cudaGetLastError());
}

// A (m,k) group-sorted rows, B (E,k,n), C (m,n) row-major and contiguous;
// bias (E,n) f32 or null; b_scale (E,n) f32 or null, an int8 bank's
// per-expert dequant rows (W8A16; applied before the epilogue).  offsets (E+1,), group_ids and m_tile_ids and
// num_instances (a scalar) are int32 on the device, the tables built at the
// m tile of CTA shape ``config`` (kernels/gemm_grouped.py BF16_TILES /
// F32_TILES); the grid runs their first n_instances entries, which hold
// every live one.  ``mode_a`` / ``mode_b`` are the staging copy modes.
// Every element of C is written.  Returns cudaGetLastError() after the
// launch.
extern "C" int gemm_grouped_launch(const void* a, const void* b, void* c,
                                   const void* bias, const void* b_scale,
                                   const void* offsets,
                                   const void* group_ids,
                                   const void* m_tile_ids,
                                   const void* num_instances, int n_instances,
                                   int m, int n, int k, int e, int config,
                                   int a_dtype, int b_dtype, int out_dtype,
                                   int act,
                                   int mode_a, int mode_b, void* stream) {
  using namespace repro;
  if (n_instances < 1 || n_instances > 65535)  // gridDim.y's limit
    return static_cast<int>(cudaErrorInvalidValue);
  GroupedArgs p;
  p.M = m, p.N = n, p.K = k, p.E = e, p.bm = 0, p.bn = 0, p.act = act;
  p.out_dtype = out_dtype, p.mode_a = mode_a, p.mode_b = mode_b;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* offs = static_cast<const int*>(offsets);
  const int* gids = static_cast<const int*>(group_ids);
  const int* tids = static_cast<const int*>(m_tile_ids);
  const int* live = static_cast<const int*>(num_instances);
  const GroupedOperands o{a, b, c, static_cast<const float*>(bias),
                          static_cast<const float*>(b_scale)};
  const bool b8 = b_dtype == kI8;
  if (a_dtype == kBF16)
    return b8 ? launch_tc<true>(config, o, offs, gids, tids, live,
                                n_instances, p, s)
              : launch_tc<false>(config, o, offs, gids, tids, live,
                                 n_instances, p, s);
  return b8 ? launch_f32<int8_t>(config, o, offs, gids, tids, live,
                                 n_instances, p, s)
            : launch_f32<float>(config, o, offs, gids, tids, live,
                                n_instances, p, s);
}
