// B3's tensor-core body (bf16), as templates over the CTA's shape: kD the
// padded head, kR the (q position, q head) rows a CTA holds and kStage the
// keys one pipeline stage copies.  flash_attention.cu holds the design
// notes and the entry point; it, flash_attention_d128.cu and
// flash_attention_d256.cu each instantiate launch_bf16_kd for some kD, so
// the instances compile in parallel.
//
// The shapes a launch may take (kernels/flash_attention.py B3_BLOCKS):
//   * kR = 16, 32, 64 or 128 rows, a warp a 16-row group (1, 2, 4 or 8
//     warps); at kD = 256 two warps share a 16-row group, each keeping half
//     of O's columns, so 16, 32 or 64 rows (2, 4 or 8 warps);
//   * kStage = 64 or 128 keys: a stage copies one or two 64-key blocks into
//     a two-stage ring.  2 stages x (K + V) x kStage x kD x 2 B: a 128-key
//     stage at kD = 256 would take 256 KB of the 227 KB a CTA may have, so
//     kD = 256 stages 64 keys only.
// Neither changes a bit of any output row: the online-softmax step is
// always one 64-key block of the fixed grid from key 0, visited in
// ascending order, and what a warp computes for its 16 rows does not depend
// on how many warps share the CTA, where the CTA's tile starts or how many
// blocks one copy stages.  The default shape is 64 rows and 64 keys (32
// rows at kD = 256).
#pragma once

#include <cstddef>

#include "mma_chain.cuh"
#include "staging.cuh"

namespace repro {

constexpr int kBkv = 64;  // keys a block: the fixed key grid

struct FaArgs {
  int batch, sq, skv, hq, hkv, d, group, causal, window, q_offset;
  int rows;            // sq * group: rows of one (batch row, kv head)
  int mode_k, mode_v;  // staging.cuh copy modes of k and v
  float scale_log2;    // softmax scale * log2 e
};

// The kD = 256 body's split: two warps a 16-row group, one O half each.
template <int kD>
constexpr bool kSplitCols = kD > 128;
// The output columns one warp keeps.
template <int kD>
constexpr int kColsOf = kSplitCols<kD> ? kD / 2 : kD;
// Threads of a CTA of kR rows.
__host__ __device__ constexpr int fa_threads(int kD, int kR) {
  return 32 * (kR / 16) * (kD > 128 ? 2 : 1);
}
// A CTA's shared memory: the ring (2 stages of K and V, kStage keys each)
// and, at kD = 256, the q tile of its rows.
__host__ __device__ constexpr size_t fa_smem(int kD, int kR, int kStage) {
  return (2 * 2 * static_cast<size_t>(kStage) + (kD > 128 ? kR : 0)) * kD *
         sizeof(__nv_bfloat16);
}

// kR rows, head_dim padded to kD, kStage keys a stage.
template <int kD, int kR, int kStage>
__global__ void __launch_bounds__(fa_threads(kD, kR))
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, FaArgs p) {
  constexpr int kThreads = fa_threads(kD, kR);
  constexpr int kQK = kD / 16;    // k16 steps of S = Q K^T
  constexpr int kSF = kBkv / 8;   // n8 score fragments a block
  constexpr int kPV = kBkv / 16;  // k16 steps of O += P V
  constexpr bool kQSmem = kSplitCols<kD>;  // q from shared memory a step
  constexpr int kOF = kColsOf<kD> / 8;     // the warp's n8 output fragments
  constexpr int kTile = kBkv * kD;
  constexpr int kSub = kStage / kBkv;      // blocks a stage
  static_assert(kStage % kBkv == 0 && kR % 16 == 0, "whole blocks, groups");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);

  // the CTA's work: q tiles in descending order (causally heaviest first),
  // then kv head, then batch row
  const int tiles = (p.rows + kR - 1) / kR;
  const int per_tile = p.hkv * p.batch;
  const int tile = tiles - 1 - static_cast<int>(blockIdx.x) / per_tile;
  const int rest = static_cast<int>(blockIdx.x) % per_tile;
  const int kvh = rest % p.hkv, bi = rest / p.hkv;
  const int f0 = tile * kR;  // first flat row: position f / group,
                             // q head kvh * group + f % group
  const int f_last = min(f0 + kR, p.rows) - 1;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // the warp's 16-row group and its first output column
  const int wrow = kQSmem ? warp >> 1 : warp;
  const int col0 = kQSmem ? (warp & 1) * kColsOf<kD> : 0;

  // this thread's two rows (g and g + 8 of its warp's 16)
  int qpos[2];
  bool row_ok[2];
  const __nv_bfloat16* qrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = f0 + 16 * wrow + g + 8 * h;
    row_ok[h] = f < p.rows;
    const int fc = row_ok[h] ? f : 0;
    const int pos = fc / p.group;
    const int head = kvh * p.group + (fc - pos * p.group);
    qpos[h] = p.q_offset + pos;
    qrow[h] = q + ((static_cast<size_t>(bi) * p.sq + pos) * p.hq + head) *
                      p.d;
  }
  // q as A fragments, zero past d and past the rows; at kD = 256 as a
  // shared tile of the CTA's rows instead (visible after the loop's first
  // __syncthreads, before any product)
  uint32_t qa[kQSmem ? 1 : kQK][4];
  const SmemTile qt = smem_tile(ring + 4 * kSub * kTile, kD);
  if constexpr (kQSmem) {
    for (int i = tid; i < kR * (kD / 8); i += kThreads) {
      const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
      const int f = f0 + r;
      const int pos = f / p.group;
      const __nv_bfloat16* row =
          q + ((static_cast<size_t>(bi) * p.sq + pos) * p.hq + kvh * p.group +
               (f - pos * p.group)) * p.d;
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c0 = c + 2 * e;
        const uint32_t lo = f < p.rows && c0 < p.d
                                ? __bfloat16_as_ushort(row[c0]) : 0u;
        const uint32_t hi = f < p.rows && c0 + 1 < p.d
                                ? __bfloat16_as_ushort(row[c0 + 1]) : 0u;
        w[e] = lo | hi << 16;
      }
      *reinterpret_cast<uint4*>(qt.p + qt.at(r, c)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
#pragma unroll
    for (int s = 0; s < kQK; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = r & 1, c = 16 * s + 2 * t + 8 * (r >> 1);
        const __nv_bfloat16* row = qrow[h];
        const uint32_t lo = row_ok[h] && c < p.d
                                ? __bfloat16_as_ushort(row[c]) : 0u;
        const uint32_t hi = row_ok[h] && c + 1 < p.d
                                ? __bfloat16_as_ushort(row[c + 1]) : 0u;
        qa[s][r] = lo | hi << 16;
      }
  }

  // the keys the CTA's rows can see, on the fixed grid
  const int qpos_lo = p.q_offset + f0 / p.group;
  const int qpos_hi = p.q_offset + f_last / p.group;
  const int kv_end = p.causal ? min(p.skv, qpos_hi + 1) : p.skv;
  const int kv_begin =
      p.window > 0 ? max(0, qpos_lo - p.window + 1) / kBkv * kBkv : 0;
  const int blocks = kv_end > kv_begin ? (kv_end - kv_begin + kBkv - 1) / kBkv
                                       : 0;
  const int stages = (blocks + kSub - 1) / kSub;
  // the warp's own rows, for skipping blocks masked for all of them
  const int wf0 = f0 + 16 * wrow;
  const bool warp_live = wf0 < p.rows;
  const int wq_lo = p.q_offset + min(wf0, p.rows - 1) / p.group;
  const int wq_hi = p.q_offset + min(wf0 + 15, p.rows - 1) / p.group;

  const size_t kv_ld = static_cast<size_t>(p.hkv) * p.d;
  const size_t kv_at =
      static_cast<size_t>(bi) * p.skv * kv_ld + static_cast<size_t>(kvh) * p.d;
  // block u of ring stage s: K at tile 2 kSub s + u, V at (2 s + 1) kSub + u
  auto k_tile = [&](int s, int u) {
    return smem_tile(ring + (2 * s * kSub + u) * kTile, kD);
  };
  auto v_tile = [&](int s, int u) {
    return smem_tile(ring + ((2 * s + 1) * kSub + u) * kTile, kD);
  };
  // copy stage i's blocks (those below `blocks`) into ring stage i & 1
  auto stage_copy = [&](int i) {
    for (int u = 0; u < kSub; ++u) {
      const int j = i * kSub + u;
      if (j >= blocks) break;
      const int kv0 = kv_begin + j * kBkv;
      const int valid = min(kBkv, p.skv - kv0);
      const size_t at = kv_at + static_cast<size_t>(kv0) * kv_ld;
      const SmemTile kt = k_tile(i & 1, u), vt = v_tile(i & 1, u);
      if (p.mode_k == 2)
        stage_rows16<kThreads, kD>(kt.p, kt, k + at, kv_ld, kBkv, valid, p.d,
                                   tid);
      else
        stage_rows<kThreads>(kt.p, kt, k + at, kv_ld, kBkv, kD, valid, p.d,
                             p.mode_k, tid);
      if (p.mode_v == 2)
        stage_rows16<kThreads, kD>(vt.p, vt, v + at, kv_ld, kBkv, valid, p.d,
                                   tid);
      else
        stage_rows<kThreads>(vt.p, vt, v + at, kv_ld, kBkv, kD, valid, p.d,
                             p.mode_v, tid);
    }
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[kOF][4];
#pragma unroll
  for (int j = 0; j < kOF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  if (stages > 0) stage_copy(0);
  cp_async_commit();
  for (int i = 0; i < stages; ++i) {
    if (i + 1 < stages) stage_copy(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // stage i landed in every thread's view
    for (int u = 0; u < kSub; ++u) {
      const int j = i * kSub + u;
      if (j >= blocks) break;
      const int kv0 = kv_begin + j * kBkv;
      const bool skip =
          !warp_live || (p.causal && kv0 > wq_hi) ||
          (p.window > 0 && kv0 + kBkv - 1 <= wq_lo - p.window);
      if (skip) continue;
      const SmemTile kt = k_tile(i & 1, u), vt = v_tile(i & 1, u);
      // S = Q K^T
      float sc[kSF][4];
#pragma unroll
      for (int jj = 0; jj < kSF; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[jj][e] = 0.0f;
      if constexpr (kQSmem)
        mma_qkt_smem<kD>(sc, qt, 16 * wrow, kt);
      else
        mma_qkt<kD>(sc, qa, kt);
      // scale and mask in f32; the row max over the quad
      uint32_t live = 0;  // bit 4 jj + e: (row, key) visible
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int jj = 0; jj < kSF; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = kv0 + 8 * jj + 2 * t + (e & 1);
          const int qp = qpos[e >> 1];
          const bool ok = kp < p.skv && (!p.causal || kp <= qp) &&
                          (p.window <= 0 || kp > qp - p.window);
          sc[jj][e] = ok ? __fmul_rn(sc[jj][e], p.scale_log2) : kNegInf;
          live |= static_cast<uint32_t>(ok) << (4 * jj + e);
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[jj][e]);
        }
      float alpha[2], ps[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = m_new == m[h] ? 1.0f : exp2f(__fsub_rn(m[h], m_new));
        m[h] = m_new;
      }
      // p = exp2(s - m), re-zeroed where masked, rounded to bf16 as the A
      // fragments of P V; l sums the rounded values
      uint32_t pa[kPV][4];
#pragma unroll
      for (int jj = 0; jj < kSF; ++jj) {
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = (live >> (4 * jj + e)) & 1u
                              ? exp2f(__fsub_rn(sc[jj][e], m[e >> 1]))
                              : 0.0f;
          pv[e] = __bfloat162float(__float2bfloat16(x));
          ps[e >> 1] = __fadd_rn(ps[e >> 1], pv[e]);
        }
        pa[jj >> 1][2 * (jj & 1)] = pack_bf16(pv[0], pv[1]);
        pa[jj >> 1][2 * (jj & 1) + 1] = pack_bf16(pv[2], pv[3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ps[h] = __fadd_rn(ps[h], __shfl_xor_sync(0xffffffffu, ps[h], 1));
        ps[h] = __fadd_rn(ps[h], __shfl_xor_sync(0xffffffffu, ps[h], 2));
        l[h] = __fadd_rn(__fmul_rn(alpha[h], l[h]), ps[h]);
      }
#pragma unroll
      for (int jo = 0; jo < kOF; ++jo)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[jo][e] = __fmul_rn(acc[jo][e], alpha[e >> 1]);
      // O += P V, over the warp's columns
      mma_pv<kD>(acc, pa, vt, col0 / 8);
    }
    __syncthreads();  // every warp is done with stage i's blocks
  }

  if (!warp_live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
    const float denom = l[h] > 0.0f ? l[h] : 1.0f;
    __nv_bfloat16* orow = o + (qrow[h] - q);
#pragma unroll
    for (int jo = 0; jo < kOF; ++jo)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = col0 + 8 * jo + 2 * t + e;
        if (c < p.d) orow[c] = __float2bfloat16(acc[jo][2 * h + e] / denom);
      }
  }
}

template <int kD, int kR, int kStage>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               const FaArgs& p, cudaStream_t stream) {
  auto kernel = flash_attention_mma_kernel<kD, kR, kStage>;
  constexpr size_t kSmem = fa_smem(kD, kR, kStage);
  static_assert(kSmem <= 227 * 1024, "a CTA's shared memory on an H100");
  static bool configured = false;  // one attribute call per shape
  if (!configured) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kSmem));
    configured = true;
  }
  const int tiles = (p.rows + kR - 1) / kR;
  kernel<<<tiles * p.hkv * p.batch, fa_threads(kD, kR), kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      p);
  return static_cast<int>(cudaGetLastError());
}

// One compiled shape of head kD: ``rows`` a CTA and ``stage`` keys a stage;
// a shape that is not compiled returns cudaErrorInvalidValue.
template <int kD, int kStage>
int launch_rows(const void* q, const void* k, const void* v, void* o,
                const FaArgs& p, int rows, cudaStream_t s) {
  switch (rows) {
    case 16: return launch_mma<kD, 16, kStage>(q, k, v, o, p, s);
    case 32: return launch_mma<kD, 32, kStage>(q, k, v, o, p, s);
    case 64: return launch_mma<kD, 64, kStage>(q, k, v, o, p, s);
    case 128:
      if constexpr (!kSplitCols<kD>)
        return launch_mma<kD, 128, kStage>(q, k, v, o, p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int kD>
int launch_bf16_kd(const void* q, const void* k, const void* v, void* o,
                   const FaArgs& p, int rows, int stage, cudaStream_t s) {
  if (stage == 64) return launch_rows<kD, 64>(q, k, v, o, p, rows, s);
  if constexpr (!kSplitCols<kD>)
    if (stage == 128) return launch_rows<kD, 128>(q, k, v, o, p, rows, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// launch_bf16_kd<128> and <256>, compiled in flash_attention_d128.cu and
// flash_attention_d256.cu.
int launch_bf16_d128(const void* q, const void* k, const void* v, void* o,
                     const FaArgs& p, int rows, int stage, cudaStream_t s);
int launch_bf16_d256(const void* q, const void* k, const void* v, void* o,
                     const FaArgs& p, int rows, int stage, cudaStream_t s);

}  // namespace repro
