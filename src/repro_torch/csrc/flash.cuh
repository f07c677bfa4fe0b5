// The online-softmax kv-block step shared by flash_attention.cu (prefill)
// and flash_decode.cu (decode).
//
// A CTA of kFaThreads = 128 threads holds up to kFaRows = 16 query rows:
// 16 consecutive query positions of one head in prefill, or the GQA group of
// q heads that share one kv head in decode.  Warp w owns rows w, w+4, w+8,
// w+12; inside a kv block of kFaBkv = 32 keys, lane j scores key j, so the
// block's row max and row sum are one xor-shuffle tree over the warp and no
// (rows x keys) score tile is ever kept beyond one 32-wide row of p.
//
// Accumulation order of one row (a paged decode kernel must repeat it, with
// a page of 32 keys per block, to be bit-identical to the dense one):
//   * kv blocks are visited in ascending key order;
//   * a score is one fmaf chain over the head dim in order, on q already
//     multiplied by the softmax scale;
//   * m_new = max(m, warp max of the block), p = exp(s - m_new) re-zeroed
//     where masked, alpha = exp(m - m_new), l = alpha * l + warp sum of p;
//   * acc = fmaf chain over the block's 32 keys in order, starting from
//     acc * alpha;
//   * the output is acc / (l > 0 ? l : 1).
// A block in which every key is masked for a row leaves that row's state
// unchanged (p = 0, alpha = 1), so skipping such blocks is exact.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kFaRows = 16;
constexpr int kFaBkv = 32;
constexpr int kFaDmax = 128;
constexpr int kFaThreads = 128;
constexpr int kFaRowsPerWarp = kFaRows / (kFaThreads / 32);
constexpr int kFaDChunks = kFaDmax / 32;

struct FlashSmem {
  float q[kFaRows][kFaDmax];
  float k[kFaBkv][kFaDmax + 1];  // +1: lane j reads row j conflict-free
  float v[kFaBkv][kFaDmax];
  float p[kFaRows][kFaBkv];
};

// The running state of this thread's warp rows (each lane holds the row's
// m and l; lane j holds acc columns j, j + 32, j + 64, j + 96).
struct FlashState {
  float m[kFaRowsPerWarp];
  float l[kFaRowsPerWarp];
  float acc[kFaRowsPerWarp][kFaDChunks];
};

__device__ __forceinline__ void flash_init(FlashState& st) {
#pragma unroll
  for (int r = 0; r < kFaRowsPerWarp; ++r) {
    st.m[r] = kNegInf;
    st.l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kFaDChunks; ++c) st.acc[r][c] = 0.0f;
  }
}

// Stage n_rows query rows (row r at q + r * row_stride), pre-scaled.
template <typename T>
__device__ __forceinline__ void flash_load_q(FlashSmem& sm, const T* q,
                                             size_t row_stride, int n_rows,
                                             int d, float scale) {
  for (int i = threadIdx.x; i < kFaRows * kFaDmax; i += kFaThreads) {
    const int r = i / kFaDmax, c = i % kFaDmax;
    sm.q[r][c] =
        (r < n_rows && c < d) ? to_f32(q[(size_t)r * row_stride + c]) * scale
                              : 0.0f;
  }
  __syncthreads();
}

// One kv block [kv0, kv0 + 32).  Key j of the cache lives at
// k + j * kv_row_stride.  Row r's query position is qpos0 + r * qpos_step;
// a key is visible when kp < kv_len, kp <= qpos (causal) and
// kp > qpos - window (window > 0).
template <typename T>
__device__ __forceinline__ void flash_block(FlashSmem& sm, FlashState& st,
                                            const T* k, const T* v,
                                            size_t kv_row_stride, int kv0,
                                            int kv_len, int d, int n_rows,
                                            int qpos0, int qpos_step,
                                            bool causal, int window) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kFaBkv * d; i += kFaThreads) {
    const int j = i / d, c = i % d;
    const int kp = kv0 + j;
    const bool ok = kp < kv_len;
    const size_t at = (size_t)kp * kv_row_stride + c;
    sm.k[j][c] = ok ? to_f32(k[at]) : 0.0f;
    sm.v[j][c] = ok ? to_f32(v[at]) : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < kFaRowsPerWarp; ++rr) {
    const int row = warp + 4 * rr;
    if (row >= n_rows) continue;  // uniform across the warp
    float s = 0.0f;
    for (int c = 0; c < d; ++c) s = fmaf(sm.q[row][c], sm.k[lane][c], s);
    const int kp = kv0 + lane;
    const int qpos = qpos0 + row * qpos_step;
    bool valid = kp < kv_len;
    if (causal) valid = valid && kp <= qpos;
    if (window > 0) valid = valid && kp > qpos - window;
    s = valid ? s : kNegInf;
    const float m_new = fmaxf(st.m[rr], warp_max(s));
    const float p = valid ? expf(s - m_new) : 0.0f;
    const float alpha = expf(st.m[rr] - m_new);
    st.l[rr] = alpha * st.l[rr] + warp_sum(p);
    st.m[rr] = m_new;
    sm.p[row][lane] = p;
    __syncwarp();
#pragma unroll
    for (int cc = 0; cc < kFaDChunks; ++cc) {
      const int dd = lane + 32 * cc;
      if (dd < d) {
        float a = st.acc[rr][cc] * alpha;
#pragma unroll 8
        for (int j = 0; j < kFaBkv; ++j) a = fmaf(sm.p[row][j], sm.v[j][dd], a);
        st.acc[rr][cc] = a;
      }
    }
  }
  __syncthreads();  // the next block overwrites k, v and p
}

// Write acc / (l > 0 ? l : 1) for n_rows rows (row r at o + r * row_stride).
template <typename T>
__device__ __forceinline__ void flash_store(const FlashState& st, T* o,
                                            size_t row_stride, int n_rows,
                                            int d) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int rr = 0; rr < kFaRowsPerWarp; ++rr) {
    const int row = warp + 4 * rr;
    if (row >= n_rows) continue;
    const float denom = st.l[rr] > 0.0f ? st.l[rr] : 1.0f;
#pragma unroll
    for (int cc = 0; cc < kFaDChunks; ++cc) {
      const int dd = lane + 32 * cc;
      if (dd < d) o[(size_t)row * row_stride + dd] = from_f32<T>(st.acc[rr][cc] / denom);
    }
  }
}

}  // namespace repro
