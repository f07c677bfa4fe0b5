// The warp-specialised, TMA-fed bf16 body shared by kernel B1 (gemm_aie.cu,
// output-stationary) and kernel B6 (gemm_tb.cu, A-stationary, both sites),
// for Hopper.
//
// What bounds the two kernels on an H100: at decode the bytes of B (the
// weights, read once), in training and long prefills the tensor cores.  The
// sm_80 shape they had (cp.async issued by every thread, mma.sync
// m16n8k16 fragments a warp) reached neither: one SM streamed 13.5 B a cycle
// with 128 KB of cp.async in flight, and mma.sync runs at a fraction of
// wgmma's rate.  This body is Hopper's own shape:
//
//   - Data in.  The tensor memory accelerator (tma.cuh) loads A and B in
//     64-deep k slabs, 128-byte swizzled, into a ring of stages in dynamic
//     shared memory; each stage has a full and an empty mbarrier.  One SM
//     streams 45 B a cycle from 64 KB of boxes in flight (PERF.md §6).
//   - Producer.  Thread 0 of the first warpgroup keeps the ring full with
//     box copies; beside two consumer warpgroups the producer warpgroup
//     gives up registers (setmaxnreg) to them.
//   - Products.  One or two consumer warpgroups run wgmma.mma_async
//     m64nNk16 (wgmma.cuh) on the stages that have landed, A K-major, B
//     MN-major ([k][n] rows, as the callers keep it).  With few rows (m <=
//     16, decode) a GEMM is bound by the bytes of B and by each element's
//     dependent chain of k/16 steps, so it wants many narrow CTAs: up to 8
//     consumer warps run mma_chain.cuh's mma.sync chain on 8 to 256
//     columns a CTA, or (B1, where n is wide) the roles swap, B's 64
//     columns a panel on wgmma's 64-row side and the rows on its N = 16
//     side (C^T = B^T A^T).  chip_smoke.py decode_form_phase times the
//     two against each other.
//   - Flush.  common.cuh's epilogue on the f32 registers: bias -> silu /
//     gelu(tanh) / relu -> residual, then f32 or bf16 out (B6a: the bare
//     f32 partial).
//   - Edges.  Ragged m, n and k edges land as zeros from TMA's out-of-bounds
//     fill; nothing is stored past an edge, and no caller pads.  An operand
//     whose base or rows are not 16-byte multiples has no tensor map: the
//     producer warp then stages the same layout by cp.async (staging.cuh)
//     and releases the stage after its copies land.
//
// The bits.  Every C element is one chain of k16 steps over k = 0, 16, ...
// ascending with an f32 accumulator, from zero (B1, B6's first chunk) or
// from B6's stored f32 partial; the k tail past K (or past the chunk) reads
// zeros up to the 16-grid and no step beyond it runs; nothing splits k.
// tools/hopper_probe.cu probe 4 found wgmma m64nNk16 (N = 8 .. 256) and its
// swapped form accumulate each k16 step to the same f32 bits as mma.sync
// m16n8k16 (mma_chain.cuh mma_slab) on this card, from zero and from a
// non-zero C, at k = 16 .. 4096.  So this body equals the mma.sync chain
// that B2, B7 and the int8 W8A16 paths still run, bit for bit, and a row's
// bits do not depend on m, the CTA shape or the chunking: B6 == B1, B7 ==
// B1, B2 == relu(B1) * B1 and W8A16 == the widened bf16 body hold as they
// did.
//
// The two dataflows.  B1 (kTb false): a CTA owns one kBM x kBN tile of C and
// walks all of k, each stage holding A's and B's slab.  B6 (kTb true): a CTA
// owns bm rows and a range of n tiles; the (rows x kc) panel of A is loaded
// once, resident, in 64-deep boxes, each stage holds one slab of B, and each
// n tile's accumulators start from the f32 partial of the chunk before,
// loaded by TMA into a C stage while the tile before it runs.  The C stage
// is read by the consumers' plain loads and rewritten by TMA, which is the
// async proxy: both sides fence the proxies (fence.proxy.async) around the
// barrier that hands it back, or the copy for the next tile can overwrite
// values a consumer has not read yet.  The host chunks K
// (kernels/gemm_tb.py) and B6's chunks launch as programmatic dependents: a
// chunk loads its panel and first B slab before it waits for the partial of
// the chunk before.
#pragma once

#include "mma_chain.cuh"
#include "staging.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace repro {
namespace ws {

constexpr int kBK = 64;         // k a stage (one 128-byte row of bf16)
constexpr int kMaxStages = 16;
// B6's ring: kTbStages stages, or, for the mma.sync form's narrow B slabs,
// as many as hold kTbRingBytes, up to kMaxStages (core/hardware.py
// ws_tb_stages)
constexpr int kTbStages = 4;
constexpr int kTbRingBytes = 65536;

// A CTA shape: a producer warpgroup and the consumers.  kWG consumer warpgroups on
// wgmma (64 rows each), kBN the n width the products cover (wgmma's N, or
// 64 a panel when swapped); kSwapN > 0: the swapped form, the rows of C on
// wgmma's N = kSwapN side.  kMmaSync: few rows (16) on the mma.sync
// m16n8k16 chain of mma_chain.cuh instead, min(8, kBN / 8) consumer warps
// each owning kBN / 8 / warps fragments of 8 columns: more CTAs for a
// narrow n, and a k16 step of a decode GEMM's dependent chain in less time
// than a wgmma's (PERF.md §6).  B is staged as panels of 64 columns, or
// one panel of kBN < 64, each in the TMA swizzle of its row width
// (smem_tile(p, cols) reads it).
template <int kWG, int kBN, int kSwapN, bool kMmaSync = false>
struct Shape {
  static constexpr bool kMma = kMmaSync;
  static constexpr bool kSwap = kSwapN > 0 && !kMmaSync;
  static constexpr int kSwapRows = kSwapN;
  static constexpr int kWGs = kMmaSync ? 0 : kWG;  // consumer warpgroups
  static constexpr int kN = kBN;
  static constexpr int kRows = kMmaSync ? 16 : kSwap ? kSwapN : 64 * kWG;
  static constexpr int kWarps =
      kMmaSync ? (kBN / 8 < 8 ? kBN / 8 : 8) : 4 * kWG;  // consumer warps
  static constexpr int kFN = kMmaSync ? kBN / (8 * kWarps) : 0;
  static constexpr int kConsumers = 32 * kWarps;
  static constexpr int kThreads = 128 + kConsumers;
  static constexpr int kPanelCols = kBN < 64 ? kBN : 64;
  static constexpr int kPanels = (kBN + 63) / 64;
  static constexpr int kPanelBytes = kBK * kPanelCols * 2;
  static constexpr int kABox = kRows * 128;           // one k slab of A
  static constexpr int kBStage = kPanels * kPanelBytes;
  // accumulator blocks of 8 columns a thread
  static constexpr int kBlocks =
      kMmaSync ? kFN : kSwap ? kPanels * (kSwapN / 8) : kBN / 8;
  static_assert(!kSwap || (kWG == 1 && kBN % 64 == 0),
                "swapped: 64-column panels");
  static_assert(kBN % 8 == 0 && kBN <= 256, "wgmma N");
  static_assert(!kMmaSync || (kBN & (kBN - 1)) == 0, "mma.sync: 8 .. 256");
};

struct Args {
  int M, N, K;
  int k0, kc;          // the k range this launch walks: [k0, k0 + kc)
  int bk;              // B6: the plan's k-chunk (the panel's size)
  int bm, bn;          // rows and columns of one C tile (<= kRows, kBN)
  int tiles_per_cta;   // n tiles a CTA sweeps (B1: 1)
  int stages;          // ring stages (<= kMaxStages)
  int act, out_dtype, res_dtype;
  int tma;             // 1: tensor maps; 0: the producer stages by cp.async
  int mode_a, mode_b, mode_c;  // cp.async copy modes (staging.cuh)
};

struct Operands {
  const __nv_bfloat16 *a, *b;  // (the cp.async path)
  const float* cin;   // B6: the partial of the chunks before (null: none)
  void* c;            // B6a: the f32 partial (may alias cin); else C
  const float* bias;
  const void* res;
  const float* out_scale;
};

// Bytes of dynamic shared memory: B1 the ring of A + B slabs; B6 the A
// panel, the ring of B slabs and the C stage.
template <typename S, bool kTb>
__host__ __device__ constexpr size_t smem_bytes(int stages, int bk, int bn) {
  return kTb ? static_cast<size_t>((bk + kBK - 1) / kBK) * S::kABox +
                   static_cast<size_t>(stages) * S::kBStage +
                   static_cast<size_t>(S::kRows) * bn * 4
             : static_cast<size_t>(stages) * (S::kABox + S::kBStage);
}

// The C tile row and column of accumulator element (b, e) of this thread
// (cw: its consumer warpgroup, or its consumer warp under mma.sync; wq:
// its warp there).  Unswapped, the warpgroup's 64 rows, 16 a warp, by kBN
// columns (wgmma.cuh's layout); swapped, block b = kSwapN / 8 q + jb holds
// C^T's 16 rows of this warp in panel q (B's columns 64 q + 16 wq ..) by
// C's rows 8 jb ..; mma.sync, the 16 rows by the warp's kFN fragments.
template <typename S>
__device__ __forceinline__ int tile_row(int cw, int wq, int b, int e) {
  if constexpr (S::kMma)
    return frag_row(0, e);
  else if constexpr (S::kSwap)
    return frag_col(b % (S::kSwapRows / 8), e);
  else
    return 64 * cw + 16 * wq + frag_row(0, e);
}
template <typename S>
__device__ __forceinline__ int tile_col(int cw, int wq, int b, int e) {
  if constexpr (S::kMma)
    return 8 * S::kFN * cw + frag_col(b, e);
  else if constexpr (S::kSwap)
    return 64 * (b / (S::kSwapRows / 8)) + 16 * wq + frag_row(0, e);
  else
    return frag_col(b, e);
}

// One stage's kSteps k16 steps for a consumer warpgroup on wgmma, as one
// batch of asynchronous products, committed and waited for.  wgmma writes its
// accumulators after the instruction issues, so nothing but the products
// may touch them until the wait: the batch is straight-line code (no loop
// whose iterations the compiler could join with register moves), and the
// accumulators are pinned in place (wgmma_hold) before the first product
// and after the wait.  Unswapped: C (the warpgroup's 64 rows x kN) +=
// A (64 x 16 a step, K-major) B (16 x kN, MN-major panels kPanelBytes
// apart); swapped, for each panel q: C^T (its 64 columns x kSwapRows) +=
// B^T (MN-major as the 64-row operand) A^T (the rows, K-major).
template <typename S, int kSteps>
__device__ __forceinline__ void slab_products(float (&acc)[S::kBlocks][4],
                                              const unsigned char* as,
                                              const unsigned char* bs) {
  const uint64_t da = wgmma_desc(as, kWg128, 16, 1024);
  wgmma_hold(acc);
  wgmma_fence();
  if constexpr (S::kSwap) {
    constexpr int kNB = S::kSwapRows / 8;
#pragma unroll
    for (int q = 0; q < S::kPanels; ++q) {
      const uint64_t db =
          wgmma_desc(bs + q * S::kPanelBytes, kWg128, S::kPanelBytes, 1024);
      float(&aq)[kNB][4] = *reinterpret_cast<float(*)[kNB][4]>(&acc[q * kNB]);
#pragma unroll
      for (int st = 0; st < kSteps; ++st)
        Wgmma<S::kSwapRows, 1, 0>::run(aq, wgmma_desc_add(db, 2048 * st),
                                       wgmma_desc_add(da, 32 * st));
    }
  } else {
    const uint64_t db = wgmma_desc(bs, kWg128, S::kPanelBytes, 1024);
#pragma unroll
    for (int st = 0; st < kSteps; ++st)
      Wgmma<S::kN, 0, 1>::run(acc, wgmma_desc_add(da, 32 * st),
                              wgmma_desc_add(db, 2048 * st));
  }
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_hold(acc);
}

__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
}
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
}

template <typename S, bool kTb, bool kFinal>
__global__ void __launch_bounds__(S::kThreads, 1)
gemm_ws_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b,
               const __grid_constant__ CUtensorMap map_c, Operands o,
               Args p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ uint64_t a_full, c_full, c_empty;
  const int n_tiles = (p.N + p.bn - 1) / p.bn;
  const int t_begin = blockIdx.x * p.tiles_per_cta;
  const int t_end = min(n_tiles, t_begin + p.tiles_per_cta);
  if (t_begin >= t_end) return;  // the whole CTA
  const int row0 = blockIdx.y * p.bm;
  const int slabs = (p.kc + kBK - 1) / kBK;
  const bool chained = kTb && o.cin != nullptr;
  // B6: the panel's boxes, then the ring, then the C stage; B1: the ring,
  // each stage A's box then B's panels
  unsigned char* panel = smem;
  unsigned char* ring =
      smem + (kTb ? ((p.bk + kBK - 1) / kBK) * S::kABox : 0);
  constexpr int kStage = (kTb ? 0 : S::kABox) + S::kBStage;
  float* cst = reinterpret_cast<float*>(ring + p.stages * kStage);
  auto a_box = [&](int s, int i) {
    return kTb ? panel + i * S::kABox : ring + s * kStage;
  };
  auto b_stage = [&](int s) {
    return ring + s * kStage + (kTb ? 0 : S::kABox);
  };

  if (threadIdx.x == 0) {
    if (smem_addr(smem) & 1023) __trap();  // the swizzle's 1024-byte period
    const int arrivals = p.tma ? 1 : 128;
    // every consumer thread releases what it read
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], arrivals);
      mbar_init(&empty[s], S::kConsumers);
    }
    mbar_init(&a_full, arrivals);
    mbar_init(&c_full, arrivals);
    mbar_init(&c_empty, S::kConsumers);
    fence_barrier_init();
  }
  __syncthreads();
  // Programmatic dependent launch: B1 and B6's first chunk read operands the
  // kernels before them wrote; a later chunk of B6 reads only the partial of
  // the chunk before (its producer waits before loading it).
  if (!chained) grid_dependency_wait();
  grid_launch_dependents();

  // the producer: the first warpgroup.  Its thread 0 issues the box
  // copies; without tensor maps all 128 stage by cp.async.
  const int tid = threadIdx.x;
  const bool issuer = tid == 0;
  if (tid < 128) {
    // ------------------------------------------------------------ producer
    if constexpr (S::kWGs == 2) reg_dealloc();
    if (p.tma && tid >= 32) return;
    const int rows_valid = p.M - row0;
    // one k slab of A (rows row0.., columns k..k + 63) into dst
    auto load_a = [&](unsigned char* dst, int k, uint64_t* bar) {
      if (p.tma) {
        if (issuer) tma_2d(dst, &map_a, k, row0, bar);
      } else {
        stage_rows<128>(reinterpret_cast<__nv_bfloat16*>(dst),
                       Panels<S::kRows>{},
                       o.a + static_cast<size_t>(row0) * p.K + k, p.K,
                       S::kRows, kBK, rows_valid, p.K - k, p.mode_a, tid);
      }
    };
    auto load_b = [&](unsigned char* dst, int col0, int k, uint64_t* bar) {
      if (p.tma) {
        if (issuer)
          for (int q = 0; q < S::kPanels; ++q)
            tma_2d(dst + q * S::kPanelBytes, &map_b, col0 + 64 * q, k, bar);
      } else if constexpr (S::kPanelCols < 64) {  // one narrow panel
        __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(dst);
        stage_rows<128>(d, Tile16{smem_tile(d, S::kPanelCols)},
                        o.b + static_cast<size_t>(k) * p.N + col0, p.N, kBK,
                        S::kPanelCols, p.K - k, p.N - col0, p.mode_b, tid);
      } else {
        stage_rows<128>(reinterpret_cast<__nv_bfloat16*>(dst), Panels<kBK>{},
                        o.b + static_cast<size_t>(k) * p.N + col0, p.N, kBK,
                        64 * S::kPanels, p.K - k, p.N - col0, p.mode_b, tid);
      }
    };
    // The cp.async path releases a stage once its copies have landed and
    // are visible to the async proxy (wgmma reads through it).  A ring
    // stage's copies stay in flight behind the next kLag - 1 stages' (the
    // stages issued in order land in order); kLag <= stages, so the
    // consumers never wait on a stage the producer still holds.  The A
    // panel and the C stage are released at once, with everything before.
    constexpr int kLag = 3;
    uint64_t* pending[kLag];
    int n_pending = 0;
    auto drain = [&]() {
      cp_async_wait<0>();
      fence_proxy_async();
      for (int x = 0; x < n_pending; ++x) mbar_arrive(pending[x]);
      n_pending = 0;
    };
    auto release = [&](uint64_t* bar) {
      cp_async_commit();
      drain();
      mbar_arrive(bar);
    };
    auto release_stage = [&](uint64_t* bar) {
      cp_async_commit();
      pending[n_pending++] = bar;
      if (n_pending == kLag) {
        cp_async_wait<kLag - 1>();
        fence_proxy_async();
        mbar_arrive(pending[0]);
        for (int x = 1; x < kLag; ++x) pending[x - 1] = pending[x];
        --n_pending;
      }
    };
    if constexpr (kTb) {
      const int boxes = slabs;
      if (p.tma && issuer) mbar_expect(&a_full, boxes * S::kABox);
      for (int i = 0; i < boxes; ++i)
        load_a(a_box(0, i), p.k0 + kBK * i, &a_full);
      if (!p.tma) release(&a_full);
    }
    int j = 0;  // slabs issued into the ring
    for (int t = t_begin; t < t_end; ++t) {
      const int col0 = t * p.bn;
      for (int i = 0; i < slabs; ++i, ++j) {
        const int s = j % p.stages;
        if (j >= p.stages) {
          mbar_wait(&empty[s], (j / p.stages - 1) & 1);
          fence_proxy_async();  // wgmma's reads, then the next copies
        }
        const int k = p.k0 + kBK * i;
        if (p.tma && issuer)
          mbar_expect(&full[s], (kTb ? 0 : S::kABox) + S::kBStage);
        if constexpr (!kTb) load_a(a_box(s, i), k, &full[s]);
        load_b(b_stage(s), col0, k, &full[s]);
        if (!p.tma) release_stage(&full[s]);
        if (chained && i == 0) {
          // the tile's partial, after its first slab: the first waits for
          // the chunk before to finish writing it
          if (t == t_begin) {
            grid_dependency_wait();
          } else {
            mbar_wait(&c_empty, (t - t_begin - 1) & 1);
            fence_proxy_async();  // the consumers' reads, then the copy
          }
          if (p.tma) {
            if (issuer) {
              mbar_expect(&c_full, S::kRows * p.bn * 4);
              tma_2d(cst, &map_c, col0, row0, &c_full);
            }
          } else {
            stage_rows<128>(cst, RowMajor{p.bn},
                            o.cin + static_cast<size_t>(row0) * p.N + col0,
                            p.N, S::kRows, p.bn, rows_valid, p.N - col0,
                            p.mode_c, tid);
            release(&c_full);
          }
        }
      }
    }
    if (!p.tma) drain();
    return;
  }

  // -------------------------------------------------------------- consumers
  if constexpr (S::kWGs == 2) reg_alloc();
  // the consumer warpgroup (mma.sync: the consumer warp) and its warp
  const int cw = S::kMma ? (tid >> 5) - 4 : tid / 128 - 1;
  const int wq = (threadIdx.x >> 5) & 3;
  if (kTb) mbar_wait(&a_full, 0);
  int j = 0;
  for (int t = t_begin; t < t_end; ++t) {
    const int col0 = t * p.bn;
    float acc[S::kBlocks][4];
#pragma unroll
    for (int b = 0; b < S::kBlocks; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[b][e] = 0.0f;
    if (chained) {
      mbar_wait(&c_full, (t - t_begin) & 1);
#pragma unroll
      for (int b = 0; b < S::kBlocks; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = tile_row<S>(cw, wq, b, e);
          const int c = tile_col<S>(cw, wq, b, e);
          if (c < p.bn) acc[b][e] = cst[r * p.bn + c];
        }
      // these generic reads before the next partial's TMA (async-proxy)
      // writes into the stage
      fence_proxy_async();
      mbar_arrive(&c_empty);
    }
    for (int i = 0; i < slabs; ++i, ++j) {
      const int s = j % p.stages;
      mbar_wait(&full[s], (j / p.stages) & 1);
      const int steps = (min(kBK, p.kc - kBK * i) + 15) >> 4;
      unsigned char* as =
          a_box(s, i) + (S::kSwap || S::kMma ? 0 : cw * 64 * 128);
      unsigned char* bs = b_stage(s);
      if constexpr (S::kMma) {
        // the warp's kFN fragments inside one panel, read by ldmatrix
        const int c0 = 8 * S::kFN * cw, qc = c0 % 64;
        __nv_bfloat16* a16 = reinterpret_cast<__nv_bfloat16*>(as);
        __nv_bfloat16* b16 = reinterpret_cast<__nv_bfloat16*>(
            bs + (c0 / 64) * S::kPanelBytes);
        mma_slab<1, S::kFN, false>(
            *reinterpret_cast<float(*)[1][S::kFN][4]>(&acc[0]),
            smem_tile(a16, kBK), 0, 16, smem_tile(b16, S::kPanelCols), qc,
            S::kPanelCols - qc, 16 * steps);
        fence_proxy_async();  // these generic reads, then the next copies
      } else {
        switch (steps) {  // straight-line batches only (see slab_products)
          case 1:
            slab_products<S, 1>(acc, as, bs);
            break;
          case 2:
            slab_products<S, 2>(acc, as, bs);
            break;
          case 3:
            slab_products<S, 3>(acc, as, bs);
            break;
          default:
            slab_products<S, 4>(acc, as, bs);
        }
      }
      mbar_arrive(&empty[s]);
    }

    // the flush: B6a the bare f32 partial, else the epilogue
#pragma unroll
    for (int b = 0; b < S::kBlocks; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = tile_row<S>(cw, wq, b, e);
        const int c = tile_col<S>(cw, wq, b, e);
        const int row = row0 + r, col = col0 + c;
        if (r >= p.bm || c >= p.bn || row >= p.M || col >= p.N) continue;
        const size_t at = static_cast<size_t>(row) * p.N + col;
        if (kTb && !kFinal) {
          static_cast<float*>(o.c)[at] = acc[b][e];
          continue;
        }
        float rv = 0.0f;
        if (o.res != nullptr)
          rv = p.res_dtype == kBF16
                   ? to_f32(static_cast<const __nv_bfloat16*>(o.res)[at])
                   : static_cast<const float*>(o.res)[at];
        const float x =
            epilogue(acc[b][e], o.bias != nullptr,
                     o.bias != nullptr ? o.bias[col] : 0.0f, p.act,
                     o.res != nullptr, rv);
        store_out(o.c, at, x, p.out_dtype, o.out_scale);
      }
  }
}

// The barriers' static shared memory, padded to the 1024-byte alignment of
// the dynamic array after it, and the most dynamic shared memory a launch
// takes beside it: one CTA's 227 KiB in all.
constexpr int kStaticSmem = 1024;
constexpr int kMaxDynSmem = 232448 - kStaticSmem;

// One launch of the body at shape S: tensor maps for A (boxes of 64 k x
// kRows rows), B (a panel's columns x 64 k) and, for a chained chunk of
// B6, the f32 partial (bn x kRows), each through tma.cuh's cache; without
// them (p.mode_* not all 2, or no map), the producer warp stages by
// cp.async.  The CTA
// grid is (n tile groups, m blocks).  A programmatic dependent launch.
// Returns the launch's error, then cudaGetLastError().
template <typename S, bool kTb, bool kFinal>
int launch(const Operands& o, Args p, cudaStream_t stream) {
  auto kernel = gemm_ws_kernel<S, kTb, kFinal>;
  const size_t smem = smem_bytes<S, kTb>(p.stages, p.bk, p.bn);
  if (p.stages < 1 || p.stages > kMaxStages || smem > kMaxDynSmem ||
      p.bm < 1 || p.bm > S::kRows || p.bn < 1 || p.bn > S::kN)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxDynSmem);
    configured = true;
  }
  CUtensorMap ma{}, mb{}, mc{};
  const bool chained = kTb && o.cin != nullptr;
  p.tma = p.mode_a == 2 && p.mode_b == 2 && (!chained || p.mode_c == 2) &&
          tensor_map_2d_cached(&ma, o.a, 2, p.M, p.K, p.K, kBK, S::kRows) &&
          tensor_map_2d_cached(&mb, o.b, 2, p.K, p.N, p.N, S::kPanelCols,
                               kBK) &&
          (!chained || tensor_map_2d_cached(&mc, o.cin, 4, p.M, p.N, p.N,
                                            p.bn, S::kRows));
  const int n_tiles = (p.N + p.bn - 1) / p.bn;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_tiles + p.tiles_per_cta - 1) / p.tiles_per_cta,
                     (p.M + p.bm - 1) / p.bm);
  cfg.blockDim = dim3(S::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, ma, mb, mc, o, p);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

}  // namespace ws

// Kernel B1's launch of this body at CTA shape ``config`` (gemm_aie_ws.cu).
int gemm_aie_ws_launch(int config, const ws::Operands& o, const ws::Args& p,
                       cudaStream_t s);

}  // namespace repro
