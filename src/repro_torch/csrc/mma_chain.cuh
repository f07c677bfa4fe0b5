// The one tensor-core chain of the bf16 GEMMs, shared by kernel B1
// (gemm_aie.cu, output-stationary), kernel B6 (gemm_tb.cu, A-stationary),
// B2 (gemm_gated.cu) and B7 (gemm_grouped.cu, on each group's rows), and
// the fragment -> (row, col) map of their flush; and the
// two products of the attention block step (mma_qkt, mma_pv), shared by B3
// and the decode kernels B4 and B5.
//
// The chain: every C element is one sequence of
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 instructions with an
// f32 accumulator, over k = 0, 16, 32, ... ascending, from zero (B1, and
// B6's first k-chunk) or from the stored f32 partial of the k before it
// (B6's later chunks, whose boundaries fall on the 16-grid).  The k tail
// (K, or B6's last chunk, not a multiple of 16) reads as zeros up to the
// 16-grid, and no step past it runs.  A warp that owns a C fragment walks
// all of its k: nothing splits k across warps or CTAs.  An element's bits
// depend only on its row of A, its column of B and that sequence, so they
// are the same at any m, tile, chunk count or position in the tile, and B1
// and B6 agree bit for bit.
//
// Operands come from shared memory through ldmatrix (B with .trans: both
// kernels keep B as [k][n] row-major).  A tile whose rows are not whole
// 16-byte chunks, and a partial tail step that is not zero-filled in shared
// memory, take a masked path that builds the same fragment registers element
// by element; it runs outside the hot loop.
#pragma once

#include "common.cuh"

namespace repro {

// A bf16 tile in shared memory, row-major with rows of ``ld`` elements.
// When a row is whole 16-byte chunks (ld % 8 == 0), chunk q of row r is
// stored at chunk q ^ ((r >> sh) & mask): the 8 rows one ldmatrix phase
// reads then fall on 8 distinct groups of 4 banks.  Otherwise the tile is
// plain and mma_slab reads it by the scalar path.
struct SmemTile {
  __nv_bfloat16* p;
  int ld, sh, mask;
  __device__ __forceinline__ int at(int r, int c) const {
    return r * ld + ((((c >> 3) ^ ((r >> sh) & mask)) << 3) | (c & 7));
  }
  __device__ __forceinline__ bool chunked() const { return (ld & 7) == 0; }
};

__device__ __forceinline__ SmemTile smem_tile(__nv_bfloat16* p, int ld) {
  SmemTile t{p, ld, 3, 0};
  if ((ld & 7) == 0) {
    const int w = ld >> 3;          // 16-byte chunks a row
    const int pw = min(w & -w, 8);  // 1, 2, 4 or 8 chunks permuted
    t.mask = pw - 1;                // by (r >> sh) & mask: 8 / pw rows
    t.sh = pw == 8 ? 0 : pw == 4 ? 1 : pw == 2 ? 2 : 3;  // share one
  }
  return t;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3,
                                          const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1,
                                          const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_addr(p)));
}

// d = a (16x16, row) * b (16x8, col) + d, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 (nearest even) and packed low, high: the
// C layout of two m16n8 fragments repacked as the A layout of one k16 step.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi)))
             << 16;
}

// The two products of the attention block step (B3 flash_attention.cu, and
// B4 / B5 through decode_split.cuh), for one warp's 16 rows against a block
// of 8 kSF keys held in swizzled [key][kD] tiles (smem_tile(p, kD)).
// S += Q K^T: qa holds Q's kD / 16 k16 steps as A fragments; K is read by
// x4 ldmatrix, keys 8 jj .. 8 jj + 15 at d chunks 2 s and 2 s + 1, which is
// already the .col B layout.
template <int kD, int kSF>
__device__ __forceinline__ void mma_qkt(float (&sc)[kSF][4],
                                       const uint32_t (&qa)[kD / 16][4],
                                       const SmemTile& kt) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
#pragma unroll
  for (int s = 0; s < kD / 16; ++s)
#pragma unroll
    for (int jj = 0; jj < kSF; jj += 2) {
      const int key = 8 * jj + 8 * (mi >> 1) + (lane & 7);
      const int chunk = 2 * s + (mi & 1);
      uint32_t b[4];
      ldsm_x4(b, kt.p + key * kD + ((chunk ^ ((key >> kt.sh) & kt.mask)) << 3));
      mma_bf16(sc[jj], qa[s], b[0], b[1]);
      mma_bf16(sc[jj + 1], qa[s], b[2], b[3]);
    }
}

// O += P V over 16 kPV keys: pa holds P's k16 steps as A fragments; V is
// read by x4 ldmatrix.trans, keys 16 s .. 16 s + 15 at d chunks jo, jo + 1.
template <int kD, int kPV>
__device__ __forceinline__ void mma_pv(float (&acc)[kD / 8][4],
                                      const uint32_t (&pa)[kPV][4],
                                      const SmemTile& vt) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < kPV; ++s)
#pragma unroll
    for (int jo = 0; jo < kD / 8; jo += 2) {
      const int key = 16 * s + (lane & 15);
      const int chunk = jo + (lane >> 4);
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(b0, b1, b2, b3,
                vt.p + key * kD + ((chunk ^ ((key >> vt.sh) & vt.mask)) << 3));
      mma_bf16(acc[jo], pa[s], b0, b1);
      mma_bf16(acc[jo + 1], pa[s], b2, b3);
    }
}

// The bits of t's element (r, c), or zero when !ok.
__device__ __forceinline__ uint32_t bits(const SmemTile& t, int r, int c,
                                         bool ok) {
  return ok ? static_cast<uint32_t>(__bfloat16_as_ushort(t.p[t.at(r, c)]))
            : 0u;
}

// The flush map: element e (0..3) of fragment (i, j) of a warp's
// (16 kFM) x (8 kFN) block sits at row frag_row(i, e), column
// frag_col(j, e) of the block.
__device__ __forceinline__ int frag_row(int i, int e) {
  return 16 * i + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int j, int e) {
  return 8 * j + 2 * (threadIdx.x & 3) + (e & 1);
}

// The same step from element loads, masked: A and B entries at k >= k_len,
// A rows >= a_rows and B columns >= b_cols read as zero.  For the partial
// last step of a slab whose tail is not zero-filled, and for tiles whose
// rows are not whole 16-byte chunks.  Register h of an A fragment holds row
// g + 8 (h & 1), columns 2t + 8 (h >> 1) and the next; of a B fragment, k
// rows 2t + 8 h and the next of column g (g = lane / 4, t = lane % 4).
template <int kFM, int kFN>
__device__ __forceinline__ void mma_step_masked(
    float (&acc)[kFM][kFN][4], const SmemTile& A, int a_r0, int a_rows,
    const SmemTile& B, int b_c0, int b_cols, int kk, int k_len) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[kFM][4], b[kFN][2];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int rr = g + 8 * (h & 1), c = kk + 2 * t + 8 * (h >> 1);
      const bool ok = rr < a_rows - 16 * i;
      const int r = a_r0 + 16 * i + rr;
      a[i][h] = bits(A, r, c, ok && c < k_len) |
                bits(A, r, c + 1, ok && c + 1 < k_len) << 16;
    }
#pragma unroll
  for (int j = 0; j < kFN; ++j) {
    const int n = 8 * j + g;
    const bool ok = n < b_cols;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = kk + 2 * t + 8 * h;
      b[j][h] = bits(B, k, b_c0 + n, ok && k < k_len) |
                bits(B, k + 1, b_c0 + n, ok && k + 1 < k_len) << 16;
    }
  }
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j)
      mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
}

// The chain over one staged k-slab of depth k_len, for one warp: for
// kk = 0, 16, ... < k_len in order, each fragment (i, j) of the warp's
// block takes acc[i][j] = mma(A[a_r0 + 16 i .. +16][kk .. +16],
// B[kk .. +16][b_c0 + 8 j .. +8], acc[i][j]).  Whole steps of chunked
// tiles read their operands by ldmatrix, the rest (a partial last step, or
// every step of a tile whose rows are not whole chunks) by
// mma_step_masked; both give a step the same registers.  a_rows: rows of
// A present from a_r0 (at least 1); b_cols: columns of B present from b_c0.
// kEdge: the warp's block may reach past A's rows, which then read as a
// copy of the last row present (rows 8..15 of a block with at most 8 as
// zero).  Fragments past b_cols read what lies beyond the tile's columns
// (ldmatrix) or zeros (masked).  Either way they only feed C elements past
// the tile, which are never stored, and the stages are laid out so such
// reads stay inside the CTA's shared memory.  a_r0 is a multiple of 16, and
// there are no branches around the MMAs, which would cost each its own
// convergence point.
template <int kFM, int kFN, bool kEdge>
__device__ __forceinline__ void mma_slab(float (&acc)[kFM][kFN][4],
                                         const SmemTile& A, int a_r0,
                                         int a_rows, const SmemTile& B,
                                         int b_c0, int b_cols, int k_len) {
  const int lane = threadIdx.x & 31;
  int kk = 0;
  if (A.chunked() && B.chunked()) {
    // Each lane's ldmatrix row is fixed over the slab; kk moves in steps of
    // 16, which leave a row's chunk permutation as it is.
    const __nv_bfloat16* pa[kFM];
    int fa[kFM];
    bool hi[kFM];
#pragma unroll
    for (int i = 0; i < kFM; ++i) {
      const int rows = a_rows - 16 * i;
      const int r = a_r0 + 16 * i +
                    (kEdge ? min(lane & 15, max(rows - 1, 0)) : (lane & 15));
      pa[i] = A.p + r * A.ld;
      fa[i] = ((r >> A.sh) & A.mask) ^ (lane >> 4);
      hi[i] = rows > 8;
    }
    const int lb = lane & 15;
    const __nv_bfloat16* pb = B.p + lb * B.ld;
    const int fb = (lb >> B.sh) & B.mask;
    const int qb = (b_c0 >> 3) + (lane >> 4);  // this lane's chunk, x4
    // kU steps' fragments are loaded before their MMAs run, so a warp with
    // few fragments does not wait out each ldmatrix inside its chain
    constexpr int kU = kFM * kFN >= 8 ? 1 : 8 / (kFM * kFN);
    auto load = [&](uint32_t (&a)[kFM][4], uint32_t (&b)[kFN][2], int k16) {
#pragma unroll
      for (int i = 0; i < kFM; ++i) {
        ldsm_x4(a[i], pa[i] + (((k16 >> 3) ^ fa[i]) << 3));
        if (kEdge) {  // a block of at most 8 rows: its other 8 are zero
          a[i][1] = hi[i] ? a[i][1] : 0u;
          a[i][3] = hi[i] ? a[i][3] : 0u;
        }
      }
      const __nv_bfloat16* pbk = pb + k16 * B.ld;
#pragma unroll
      for (int j = 0; j < kFN; j += 2) {
        if (j + 1 < kFN)
          ldsm_x4_t(b[j][0], b[j][1], b[j + 1][0], b[j + 1][1],
                    pbk + (((qb + j) ^ fb) << 3));
        else
          ldsm_x2_t(b[j][0], b[j][1],
                    pbk + ((((b_c0 >> 3) + j) ^ fb) << 3));
      }
    };
    auto mma = [&](const uint32_t (&a)[kFM][4], const uint32_t (&b)[kFN][2]) {
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j)
          mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    };
    const int whole = k_len & ~15;
#pragma unroll 2
    for (; kk + 16 * kU <= whole; kk += 16 * kU) {
      uint32_t a[kU][kFM][4], b[kU][kFN][2];
#pragma unroll
      for (int u = 0; u < kU; ++u) load(a[u], b[u], kk + 16 * u);
#pragma unroll
      for (int u = 0; u < kU; ++u) mma(a[u], b[u]);
    }
    for (; kk < whole; kk += 16) {
      uint32_t a[kFM][4], b[kFN][2];
      load(a, b, kk);
      mma(a, b);
    }
  }
  for (; kk < k_len; kk += 16)
    mma_step_masked<kFM, kFN>(acc, A, a_r0, a_rows, B, b_c0, b_cols, kk,
                              k_len);
}

}  // namespace repro
