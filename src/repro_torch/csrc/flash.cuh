// The f32 online-softmax kv-block step: B3's f32 body (flash_attention.cu)
// and the f32 path of the decode kernels B4 (flash_decode.cu, dense cache)
// and B5 (flash_decode_paged.cu, page pool).  Their bf16 bodies run the
// tensor cores with their own block orders (flash_attention.cu,
// decode_split.cuh).  Only f32 instantiates it: the smoke models, the card
// == CPU gate and the f32 edge cases.
//
// A CTA of kFaThreads = 128 threads holds up to kFaRows = 16 query rows:
// the GQA group of q heads that share one kv head in decode, or 16
// consecutive query positions of one head in B3's f32 prefill.  Warp w owns rows w, w+4, w+8,
// w+12; inside a kv block of kFaBkv = 32 keys, lane j scores key j, so the
// block's row max and row sum are one xor-shuffle tree over the warp and no
// (rows x keys) score tile is ever kept beyond one 32-wide row of p.
//
// The tiles are sized for a head of up to kDmax columns, 128 (d <= 128) or
// kFaDmax = 256, and live in dynamic shared memory: FlashSmem<256> is 82 KB,
// past the 48 KB a CTA gets without flash_smem_optin.  Nothing in the
// arithmetic depends on kDmax: a row's bits are the same in either.  The
// kernels declare __launch_bounds__(kFaThreads, 1): with the tiles in
// dynamic shared memory ptxas otherwise budgets registers for more CTAs
// an SM than the tiles allow, and the paged kernel spilled.
//
// Accumulation order of one row (the paged decode kernel repeats it over
// logical 32-key blocks, whatever the page size, so it is bit-identical to
// the dense one; only where a key's row is found differs, DenseRows against
// PagedRows):
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
constexpr int kFaDmax = 256;  // the widest head of any instantiation
constexpr int kFaThreads = 128;
constexpr int kFaRowsPerWarp = kFaRows / (kFaThreads / 32);

template <int kDmax>
struct FlashSmem {
  float q[kFaRows][kDmax];
  float k[kFaBkv][kDmax + 1];  // +1: lane j reads row j conflict-free
  float v[kFaBkv][kDmax];
  float p[kFaRows][kFaBkv];
};

// The running state of this thread's warp rows (each lane holds the row's
// m and l; lane j holds acc columns j, j + 32, j + 64, ...).
template <int kDmax>
struct FlashState {
  float m[kFaRowsPerWarp];
  float l[kFaRowsPerWarp];
  float acc[kFaRowsPerWarp][kDmax / 32];
};

// The f32 kernels' shared memory, FlashSmem<kDmax> in the dynamic segment.
template <int kDmax>
__device__ __forceinline__ FlashSmem<kDmax>& flash_smem() {
  extern __shared__ __align__(16) unsigned char smem[];
  return *reinterpret_cast<FlashSmem<kDmax>*>(smem);
}

namespace {  // each including kernel file keeps its own flags
// Let `kernel` take FlashSmem<kDmax> of dynamic shared memory (once per
// kernel; a no-op below 48 KB).  Returns the bytes to launch with.
template <int kDmax, typename Kernel>
size_t flash_smem_optin(Kernel kernel) {
  constexpr size_t kBytes = sizeof(FlashSmem<kDmax>);
  static bool configured = false;
  if (kBytes > 48 * 1024 && !configured) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kBytes));
    configured = true;
  }
  return kBytes;
}
}  // namespace

template <int kDmax>
__device__ __forceinline__ void flash_init(FlashState<kDmax>& st) {
#pragma unroll
  for (int r = 0; r < kFaRowsPerWarp; ++r) {
    st.m[r] = kNegInf;
    st.l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kDmax / 32; ++c) st.acc[r][c] = 0.0f;
  }
}

// Stage n_rows query rows (row r at q + r * row_stride), pre-scaled.
template <int kDmax, typename T>
__device__ __forceinline__ void flash_load_q(FlashSmem<kDmax>& sm, const T* q,
                                             size_t row_stride, int n_rows,
                                             int d, float scale) {
  for (int i = threadIdx.x; i < kFaRows * kDmax; i += kFaThreads) {
    const int r = i / kDmax, c = i % kDmax;
    sm.q[r][c] =
        (r < n_rows && c < d) ? to_f32(q[(size_t)r * row_stride + c]) * scale
                              : 0.0f;
  }
  __syncthreads();
}

// Where a key's row starts, in elements from the k / v base pointer.
// flash_block calls begin_block(kv0, kv_len) once per block (every thread),
// then at(kp, j) for block key j = kp - kv0 < kv_len.
// Dense caches: kp rows of row_stride.
struct DenseRows {
  size_t row_stride;
  __device__ __forceinline__ void begin_block(int, int) const {}
  __device__ __forceinline__ size_t at(int kp, int) const {
    return (size_t)kp * row_stride;
  }
};

// A page pool seen through one slot's table: key kp lives in physical page
// table[kp / ps] at offset kp % ps.  The block's 32 row offsets are looked
// up once, by the first warp, into row_at (shared memory), so the staging
// loop does no division and no table read per element.
struct PagedRows {
  const int* table;
  int ps;
  size_t page_stride;
  size_t row_stride;
  size_t* row_at;  // kFaBkv entries in shared memory
  __device__ __forceinline__ void begin_block(int kv0, int kv_len) const {
    const int kp = kv0 + (int)threadIdx.x;
    if (threadIdx.x < kFaBkv && kp < kv_len)
      row_at[threadIdx.x] =
          (size_t)table[kp / ps] * page_stride + (size_t)(kp % ps) * row_stride;
    __syncthreads();
  }
  __device__ __forceinline__ size_t at(int, int j) const { return row_at[j]; }
};

// One kv block [kv0, kv0 + 32).  Key kp of the cache starts at
// k + rows.at(kp, kp - kv0).  Row r's query position is
// qpos0 + r * qpos_step; a key is visible when kp < kv_len, kp <= qpos
// (causal) and kp > qpos - window (window > 0).
template <int kDmax, typename T, typename KeyRows>
__device__ __forceinline__ void flash_block(FlashSmem<kDmax>& sm,
                                            FlashState<kDmax>& st,
                                            const T* k, const T* v,
                                            const KeyRows& rows, int kv0,
                                            int kv_len, int d, int n_rows,
                                            int qpos0, int qpos_step,
                                            bool causal, int window) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  rows.begin_block(kv0, kv_len);
  for (int i = threadIdx.x; i < kFaBkv * d; i += kFaThreads) {
    const int j = i / d, c = i % d;
    const int kp = kv0 + j;
    const bool ok = kp < kv_len;
    const size_t at = ok ? rows.at(kp, j) + c : 0;
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
    for (int cc = 0; cc < kDmax / 32; ++cc) {
      const int dd = lane + 32 * cc;
      if (dd < d) {
        float a = st.acc[rr][cc] * alpha;
#pragma unroll 8
        for (int j = 0; j < kFaBkv; ++j) a = fmaf(sm.p[row][j], sm.v[j][dd], a);
        st.acc[rr][cc] = a;
      }
    }
  }
  __syncthreads();  // the next block overwrites k, v, p (and row_at)
}

// Write acc / (l > 0 ? l : 1) for n_rows rows (row r at o + r * row_stride).
template <int kDmax, typename T>
__device__ __forceinline__ void flash_store(const FlashState<kDmax>& st, T* o,
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
    for (int cc = 0; cc < kDmax / 32; ++cc) {
      const int dd = lane + 32 * cc;
      if (dd < d) o[(size_t)row * row_stride + dd] = from_f32<T>(st.acc[rr][cc] / denom);
    }
  }
}

}  // namespace repro
