// The bf16 body of the decode kernels B4 (flash_decode.cu, dense cache) and
// B5 (flash_decode_paged.cu, page pool): a key-split grid whose CTAs run
// B3's tensor-core block step, and the merge of their partials.  It
// replaces the bodies of the Pallas kernels repro/kernels/flash_decode.py
// flash_decode (pallas_call :144) and flash_decode_paged (:275), which walk
// a slot's kv blocks in sequence on one core.
//
// What bounds them on an H100: the cache bytes of the pos + 1 keys each slot
// has written (K and V rows of hkv * d elements), read once, and at serving
// lengths (a few hundred keys a slot) the latency of a launch and of one
// CTA's loads, far above those bytes' 0.6-1.0 us.  So the design spreads a
// slot's keys over CTAs that each wait out one round of loads, and keeps
// every row's arithmetic on a grid fixed from key 0:
//
//   * The grid is (split group, kv head, slot).  A split is kSplit = 64
//     keys counted from key 0, one warp, one partial; a CTA holds kG = 1, 2
//     or 4 consecutive splits, a warp each, chosen at launch (B4's
//     ``bkv`` = 64 kG keys a CTA; B5 takes kG = 1).  At kD = 256 four
//     warps' tiles would take 256 KB of shared memory, past the 227 KB a
//     CTA may have, so kD = 256 takes kG = 1 or 2.  The default is kG = 1:
//     on an H100 one warp a CTA beat two and four (then 128- and 256-key
//     splits of one warp) at smollm-360m's and qwen3-moe's decode steps
//     (PERF.md §6).  The split axis is sized from what the host knows (the
//     cache's or the table's length), never from pos: a warp whose split
//     holds no key the slot sees returns at once.
//   * The warp stages its split's K and V rows with 16-byte cp.async into
//     swizzled [key][kD] tiles (4-byte copies or plain loads where rows are
//     not 16-byte chunks), K and V in two commit groups so that V lands
//     while the scores are computed; keys outside [lo, hi) are zero-filled,
//     never read.
//   * The block step is B3's (flash_attention.cu): the GQA group's q rows
//     (3 in smollm-360m, 16 in qwen3-moe) padded to one m16 tile and held as
//     A fragments; S = Q K^T and O = P V on mma.sync m16n8k16 with K by
//     ldmatrix and V by ldmatrix.trans (mma_chain.cuh); scores scaled in f32
//     by d^-0.5 log2 e; P rounded to bf16 from S's accumulators; l sums the
//     rounded P, its row reductions two quad shuffles.  head_dim is padded
//     with zeros to kD = 32, 64, 128 or 256.  The K and V tiles live in
//     dynamic shared memory: 64 KB at kD = 256 (recurrentgemma-9b's local
//     layers), past the 48 KB a CTA gets without the opt-in.  A warp's
//     q fragments (kD / 4 registers) die with S, before the O accumulator
//     (kD / 2) fills, so kD = 256 keeps q in registers.
//   * Each split writes its partial (m, l and acc, in f32, for the group's
//     rows) to scratch the wrapper allocates.  decode_merge_kernel then
//     folds a slot's partials in ascending split order, by
//     merge_partial, and writes acc / (l > 0 ? l : 1); a thread takes four
//     columns of one row, so a (kv head, slot) spreads over
//     ceil(group * ceil(d / 4) / 128) CTAs (4 at qwen3-moe's 16 x 128, 8 at
//     recurrentgemma-9b's 16 x 256).  It
//     is launched as a programmatic dependent, so its launch overlaps the
//     split grid.
//
// Invariance: a row's bits depend only on its q, the keys and values it
// sees, its pos and the window: the split grid starts at key 0, a split's
// partial does not depend on how many CTAs ran or how many splits share a
// CTA (each warp's work is one split's, alone), and the merge visits the
// splits [lo / 64, ceil(hi / 64)) in order, with
// [lo, hi) = [max(0, pos - window + 1), min(length, pos + 1)).  Not on b,
// other slots, the length beyond pos + 1, the page size or the table's
// order, or the SM count.  B5 differs from B4 only in where a key's row is
// found (PagedKeys against DenseKeys below), so B5 == B4 bit for bit.  A
// partial with no visible key (m = NEG_INF) merges as the identity, so a
// split the merge skips and an empty one merged give the same bits.
#pragma once

#include "common.cuh"
#include "mma_chain.cuh"
#include "staging.cuh"

#include <cstddef>

namespace repro {
namespace {  // each including kernel file gets its own copy

constexpr int kSplit = 64;  // keys a split: one warp, one partial

struct SplitArgs {
  int hq, hkv, d, group;
  int length;          // keys a row may see at most: S, or max_pages * ps
  int window;          // > 0: keys > pos - window only
  int n_splits;        // cdiv(length, kSplit): partials a (slot, kv head)
  int mode_k, mode_v;  // staging.cuh copy modes of k and v
  float scale_log2;    // softmax scale * log2 e
};

// The keys [lo, hi) a slot at position pos sees.
__device__ __forceinline__ void visible_keys(int pos, const SplitArgs& p,
                                             int& lo, int& hi) {
  hi = min(p.length, pos + 1);
  lo = p.window > 0 ? max(0, pos - p.window + 1) : 0;
}

// Where key kp of slot bi starts, in elements from the head's base pointer.
// begin() runs once a split, on every lane of the warp; at() is then asked
// for the split's visible keys only (j = kp - kv0).
struct DenseKeys {  // caches (b, S, hkv, d)
  int S;
  size_t row_stride;  // hkv * d
  __device__ __forceinline__ void begin(size_t*, int, int, int, int,
                                        int) const {}
  __device__ __forceinline__ size_t at(const size_t*, int bi, int kp,
                                       int) const {
    return (static_cast<size_t>(bi) * S + kp) * row_stride;
  }
};

// A pool (n_pages, ps, hkv, d) seen through slot bi's table row: key kp in
// page table[bi][kp / ps] at offset kp % ps.  begin() looks the split's
// visible keys up once into row_at (kSplit entries in shared memory):
// kSplit / ps table entries, or one when the page is larger.
struct PagedKeys {
  const int* table;
  int ps, max_pages;
  size_t page_stride, row_stride;
  __device__ __forceinline__ void begin(size_t* row_at, int bi, int kv0,
                                        int lo, int hi, int lane) const {
    const int* row = table + static_cast<size_t>(bi) * max_pages;
    for (int j = lane; j < kSplit; j += 32) {
      const int kp = kv0 + j;
      if (kp >= lo && kp < hi)
        row_at[j] = static_cast<size_t>(row[kp / ps]) * page_stride +
                    static_cast<size_t>(kp % ps) * row_stride;
    }
    __syncwarp();
  }
  __device__ __forceinline__ size_t at(const size_t* row_at, int, int,
                                       int j) const {
    return row_at[j];
  }
};

// Stage split [kv0, kv0 + kSplit) of K or V into its tile: visible key
// kp's row from src + keys.at(...), the rest zero-filled, columns past d
// zero.  mode 2: 16-byte cp.async (d % 8 == 0); 1: 4-byte (d even); 0:
// plain loads and stores.
template <int kD, typename Keys>
__device__ __forceinline__ void stage_split(const SmemTile& t,
                                            const __nv_bfloat16* src,
                                            const Keys& keys,
                                            const size_t* row_at, int bi,
                                            int kv0, int lo, int hi, int d,
                                            int mode, int lane) {
  if (mode == 2) {
    constexpr int units = kD / 8, step = 32 / units;
    const int r0 = lane / units, c = (lane % units) * 8;
    const int nb = c < d ? 16 : 0;
#pragma unroll 4
    for (int r = r0; r < kSplit; r += step) {
      const int kp = kv0 + r;
      const int n = kp >= lo && kp < hi ? nb : 0;
      cp_async16(t.p + t.at(r, c),
                 n ? src + keys.at(row_at, bi, kp, r) + c : src, n);
    }
  } else if (mode == 1) {
    constexpr int units = kD / 2;
    for (int i = lane; i < kSplit * units; i += 32) {
      const int r = i / units, c = (i % units) * 2;
      const int kp = kv0 + r;
      const int n = kp >= lo && kp < hi && c < d ? 4 : 0;
      cp_async4(t.p + t.at(r, c),
                n ? src + keys.at(row_at, bi, kp, r) + c : src, n);
    }
  } else {
    for (int i = lane; i < kSplit * kD; i += 32) {
      const int r = i / kD, c = i % kD;
      const int kp = kv0 + r;
      const bool ok = kp >= lo && kp < hi && c < d;
      t.p[t.at(r, c)] = ok ? src[keys.at(row_at, bi, kp, r) + c]
                           : __float2bfloat16(0.0f);
    }
  }
}

// kG splits a CTA, warp w taking split kG blockIdx.x + w.
template <int kD, int kG, typename Keys>
__global__ void __launch_bounds__(32 * kG)
decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ pos, float* __restrict__ part_acc,
                    float2* __restrict__ part_ml, SplitArgs p, Keys keys) {
  constexpr int kQK = kD / 16;      // k16 steps of S = Q K^T
  constexpr int kSF = kSplit / 8;   // n8 score fragments a split
  constexpr int kPV = kSplit / 16;  // k16 steps of O = P V
  constexpr int kOF = kD / 8;       // n8 output fragments
  constexpr int kTile = kSplit * kD;
  // the merge kernel may launch now; it waits for this grid to finish
  grid_launch_dependents();

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x * kG + w, kvh = blockIdx.y, bi = blockIdx.z;
  const int kv0 = split * kSplit;
  int lo, hi;
  visible_keys(pos[bi], p, lo, hi);
  // past the split axis, or no visible key: no partial (no warp of the CTA
  // waits for another, so a warp may leave alone)
  if (split >= p.n_splits || kv0 >= hi || kv0 + kSplit <= lo) return;

  // the warp's K, then V tile
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem) + 2 * w * kTile;
  __shared__ size_t row_ats[kG][kSplit];
  size_t* row_at = row_ats[w];
  const SmemTile kt = smem_tile(tiles, kD), vt = smem_tile(tiles + kTile, kD);

  const size_t head = static_cast<size_t>(kvh) * p.d;
  keys.begin(row_at, bi, kv0, lo, hi, lane);
  stage_split<kD>(kt, k + head, keys, row_at, bi, kv0, lo, hi, p.d, p.mode_k,
                  lane);
  cp_async_commit();
  stage_split<kD>(vt, v + head, keys, row_at, bi, kv0, lo, hi, p.d, p.mode_v,
                  lane);
  cp_async_commit();

  // the group's q rows as A fragments, zero past d and past the group
  const __nv_bfloat16* qg =
      q + (static_cast<size_t>(bi) * p.hq + static_cast<size_t>(kvh) * p.group) *
              p.d;
  uint32_t qa[kQK][4];
#pragma unroll
  for (int s = 0; s < kQK; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = g + 8 * (r & 1), c = 16 * s + 2 * t + 8 * (r >> 1);
      const __nv_bfloat16* qr = qg + static_cast<size_t>(row) * p.d;
      const bool ok = row < p.group;
      const uint32_t lo16 = ok && c < p.d ? __bfloat16_as_ushort(qr[c]) : 0u;
      const uint32_t hi16 =
          ok && c + 1 < p.d ? __bfloat16_as_ushort(qr[c + 1]) : 0u;
      qa[s][r] = lo16 | hi16 << 16;
    }

  cp_async_wait<1>();  // K landed
  __syncwarp();
  float sc[kSF][4];  // S = Q K^T
#pragma unroll
  for (int jj = 0; jj < kSF; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[jj][e] = 0.0f;
  mma_qkt<kD>(sc, qa, kt);
  // scale and mask in f32 (every row of the slot sees the same keys); the
  // row max over the quad is the split's m
  uint32_t live = 0;  // bit 4 jj + e: key visible
  float m[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int jj = 0; jj < kSF; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kp = kv0 + 8 * jj + 2 * t + (e & 1);
      const bool ok = kp >= lo && kp < hi;
      sc[jj][e] = ok ? __fmul_rn(sc[jj][e], p.scale_log2) : kNegInf;
      live |= static_cast<uint32_t>(ok) << (4 * jj + e);
      m[e >> 1] = fmaxf(m[e >> 1], sc[jj][e]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
  }
  // p = exp2(s - m), zero where masked, rounded to bf16 as the A fragments
  // of P V; l sums the rounded values
  uint32_t pa[kPV][4];
  float l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int jj = 0; jj < kSF; ++jj) {
    float pv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = (live >> (4 * jj + e)) & 1u
                          ? exp2f(__fsub_rn(sc[jj][e], m[e >> 1]))
                          : 0.0f;
      pv[e] = __bfloat162float(__float2bfloat16(x));
      l[e >> 1] = __fadd_rn(l[e >> 1], pv[e]);
    }
    pa[jj >> 1][2 * (jj & 1)] = pack_bf16(pv[0], pv[1]);
    pa[jj >> 1][2 * (jj & 1) + 1] = pack_bf16(pv[2], pv[3]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = __fadd_rn(l[h], __shfl_xor_sync(0xffffffffu, l[h], 1));
    l[h] = __fadd_rn(l[h], __shfl_xor_sync(0xffffffffu, l[h], 2));
  }

  cp_async_wait<0>();  // V landed
  __syncwarp();
  float acc[kOF][4];  // O = P V
#pragma unroll
  for (int jo = 0; jo < kOF; ++jo)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jo][e] = 0.0f;
  mma_pv<kD>(acc, pa, vt);

  // the split's partial: rows of the group only, columns below d
  const size_t at0 =
      (static_cast<size_t>(bi * p.hkv + kvh) * p.n_splits + split) * p.group;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = g + 8 * h;
    if (row >= p.group) continue;
    if (t == 0) part_ml[at0 + row] = make_float2(m[h], l[h]);
    float* dst = part_acc + (at0 + row) * kD;
#pragma unroll
    for (int jo = 0; jo < kOF; ++jo) {
      const int c = 8 * jo + 2 * t;
      if (c < p.d)
        *reinterpret_cast<float2*>(dst + c) =
            make_float2(acc[jo][2 * h], acc[jo][2 * h + 1]);
    }
  }
}

// Fold one partial (m, l, a) of four columns into a row's running (M, L,
// A).  A partial with no visible key (m = NEG_INF) leaves the state as it
// is, and the first partial is taken as it is.
__device__ __forceinline__ void merge_partial(float& M, float& L,
                                              float (&A)[4], float m, float l,
                                              const float4& a) {
  if (m == kNegInf) return;
  if (M == kNegInf) {
    M = m, L = l;
    A[0] = a.x, A[1] = a.y, A[2] = a.z, A[3] = a.w;
    return;
  }
  const float mn = fmaxf(M, m);
  const float alpha = mn == M ? 1.0f : exp2f(__fsub_rn(M, mn));
  const float beta = mn == m ? 1.0f : exp2f(__fsub_rn(m, mn));
  L = __fadd_rn(__fmul_rn(alpha, L), __fmul_rn(beta, l));
  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int u = 0; u < 4; ++u)
    A[u] = __fadd_rn(__fmul_rn(alpha, A[u]), __fmul_rn(beta, av[u]));
  M = mn;
}

constexpr int kMergeThreads = 128;
constexpr int kMergeBatch = 4;  // partials loaded ahead of their merges

// CTA (x, kv head, slot): thread i merges four columns (one float4 of each
// partial, padded to kd) of one of the group's rows, element
// x * kMergeThreads + i of the group's rows x ceil(d / 4) quads, over the
// slot's live splits, ascending.
__global__ void __launch_bounds__(kMergeThreads)
decode_merge_kernel(const float* __restrict__ part_acc,
                    const float2* __restrict__ part_ml,
                    const int* __restrict__ pos, __nv_bfloat16* __restrict__ o,
                    SplitArgs p, int kd) {
  const int kvh = blockIdx.y, bi = blockIdx.z;
  const int quads = (p.d + 3) / 4;
  const int e = blockIdx.x * kMergeThreads + threadIdx.x;
  int lo, hi;
  visible_keys(pos[bi], p, lo, hi);
  const int s_lo = lo / kSplit;
  const int s_hi = hi > lo ? (hi + kSplit - 1) / kSplit : s_lo;
  grid_dependency_wait();  // the split grid's partials are written
  if (e >= p.group * quads) return;
  const int row = e / quads, c = (e - row * quads) * 4;
  const size_t base = static_cast<size_t>(bi * p.hkv + kvh) * p.n_splits;
  float M = kNegInf, L = 0.0f, A[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int s0 = s_lo; s0 < s_hi; s0 += kMergeBatch) {
    float2 ml[kMergeBatch];
    float4 a[kMergeBatch];
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) {
      const size_t at = (base + min(s0 + u, s_hi - 1)) * p.group + row;
      ml[u] = part_ml[at];
      a[u] = *reinterpret_cast<const float4*>(part_acc + at * kd + c);
    }
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u)
      if (s0 + u < s_hi) merge_partial(M, L, A, ml[u].x, ml[u].y, a[u]);
  }
  const float denom = L > 0.0f ? L : 1.0f;
  __nv_bfloat16* orow =
      o + (static_cast<size_t>(bi) * p.hq +
           static_cast<size_t>(kvh) * p.group + row) * p.d;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (c + u < p.d) orow[c + u] = __float2bfloat16(A[u] / denom);
}

template <int kD, int kG, typename Keys>
int launch_split_kd(const void* q, const void* k, const void* v,
                    const int* pos, void* o, float* part_acc, float2* part_ml,
                    int b, const SplitArgs& p, const Keys& keys,
                    cudaStream_t stream) {
  auto kernel = decode_split_kernel<kD, kG, Keys>;
  constexpr size_t kSmem = 2 * static_cast<size_t>(kG) * kSplit * kD *
                           sizeof(__nv_bfloat16);
  static_assert(kSmem <= 227 * 1024, "a CTA's shared memory on an H100");
  static bool configured = false;  // one attribute call per shape
  if (kSmem > 48 * 1024 && !configured) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kSmem));
    configured = true;
  }
  dim3 grid(cdiv(p.n_splits, kG), p.hkv, b);
  kernel<<<grid, 32 * kG, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), pos, part_acc, part_ml, p, keys);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim =
      dim3(cdiv(p.group * cdiv(p.d, 4), kMergeThreads), p.hkv, b);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, decode_merge_kernel, static_cast<const float*>(part_acc),
      static_cast<const float2*>(part_ml), pos,
      static_cast<__nv_bfloat16*>(o), p, kD));
}

// kG = ``per_cta`` splits a CTA at head kD (1, 2 or 4; 1 or 2 at kD =
// 256; at most kMaxG), else cudaErrorInvalidValue.
template <int kD, int kMaxG, typename Keys>
int launch_split_g(const void* q, const void* k, const void* v,
                   const int* pos, void* o, float* acc, float2* ml, int b,
                   const SplitArgs& p, const Keys& keys, int per_cta,
                   cudaStream_t s) {
  if (per_cta == 1)
    return launch_split_kd<kD, 1>(q, k, v, pos, o, acc, ml, b, p, keys, s);
  if constexpr (kMaxG >= 2)
    if (per_cta == 2)
      return launch_split_kd<kD, 2>(q, k, v, pos, o, acc, ml, b, p, keys, s);
  if constexpr (kMaxG >= 4 && kD < 256)
    if (per_cta == 4)
      return launch_split_kd<kD, 4>(q, k, v, pos, o, acc, ml, b, p, keys, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 decode: split grid, then merge.  part_acc holds b * hkv *
// n_splits * group * kD floats (kD = head_dim padded to 32, 64, 128 or
// 256),
// part_ml b * hkv * n_splits * group float2 (kernels/flash_attention.py
// decode_grid gives both sizes); ``per_cta`` splits a CTA, compiled up to
// kMaxG (B4: 4; B5: 1).
template <int kMaxG, typename Keys>
int launch_split(const void* q, const void* k, const void* v, const int* pos,
                 void* o, void* part_acc, void* part_ml, int b, SplitArgs p,
                 const Keys& keys, float scale, int per_cta,
                 cudaStream_t s) {
  if (p.d < 1 || p.d > 256 || p.group < 1 || p.group > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  p.n_splits = cdiv(p.length, kSplit);
  p.scale_log2 = scale * kLog2e;
  float* acc = static_cast<float*>(part_acc);
  float2* ml = static_cast<float2*>(part_ml);
  if (p.d <= 32)
    return launch_split_g<32, kMaxG>(q, k, v, pos, o, acc, ml, b, p, keys,
                                     per_cta, s);
  if (p.d <= 64)
    return launch_split_g<64, kMaxG>(q, k, v, pos, o, acc, ml, b, p, keys,
                                     per_cta, s);
  if (p.d <= 128)
    return launch_split_g<128, kMaxG>(q, k, v, pos, o, acc, ml, b, p, keys,
                                      per_cta, s);
  return launch_split_g<256, kMaxG>(q, k, v, pos, o, acc, ml, b, p, keys,
                                    per_cta, s);
}

}  // namespace
}  // namespace repro
