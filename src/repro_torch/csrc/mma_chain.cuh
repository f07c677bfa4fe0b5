// The one tensor-core chain of the bf16 GEMMs (and, at the end of this
// file, the conversion passes and the s8 chain of their int8 paths),
// shared by kernel B1
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

// mma_qkt with Q's k16 steps read from shared memory instead of registers:
// qt is a swizzled [row][kD] tile (smem_tile(p, kD)) and the warp's 16 rows
// start at row0; each step's A fragment is one x4 ldmatrix (rows row0 ..
// row0 + 15 at d chunks 2 s, 2 s + 1).  The products and their order are
// mma_qkt's, so the bits are too.  For kD = 256, where kD / 16 fragments in
// registers beside the O accumulator would pass 255 a thread.
template <int kD, int kSF>
__device__ __forceinline__ void mma_qkt_smem(float (&sc)[kSF][4],
                                            const SmemTile& qt, int row0,
                                            const SmemTile& kt) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  const int qr = row0 + (lane & 15);
#pragma unroll
  for (int s = 0; s < kD / 16; ++s) {
    uint32_t a[4];
    const int qc = 2 * s + (lane >> 4);
    ldsm_x4(a, qt.p + qr * kD + ((qc ^ ((qr >> qt.sh) & qt.mask)) << 3));
#pragma unroll
    for (int jj = 0; jj < kSF; jj += 2) {
      const int key = 8 * jj + 8 * (mi >> 1) + (lane & 7);
      const int chunk = 2 * s + (mi & 1);
      uint32_t b[4];
      ldsm_x4(b, kt.p + key * kD + ((chunk ^ ((key >> kt.sh) & kt.mask)) << 3));
      mma_bf16(sc[jj], a, b[0], b[1]);
      mma_bf16(sc[jj + 1], a, b[2], b[3]);
    }
  }
}

// O += P V over 16 kPV keys: pa holds P's k16 steps as A fragments; V is
// read by x4 ldmatrix.trans, keys 16 s .. 16 s + 15 at d chunks jo, jo + 1.
// acc holds kOF n8 fragments of O's columns from d chunk chunk0 on (all
// kD / 8 of them, or B3's kD = 256 body's half a warp).
template <int kD, int kPV, int kOF>
__device__ __forceinline__ void mma_pv(float (&acc)[kOF][4],
                                      const uint32_t (&pa)[kPV][4],
                                      const SmemTile& vt, int chunk0 = 0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < kPV; ++s)
#pragma unroll
    for (int jo = 0; jo < kOF; jo += 2) {
      const int key = 16 * s + (lane & 15);
      const int chunk = chunk0 + jo + (lane >> 4);
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

// ---------------------------------------------------------------------------
// The int8 operand paths (W8A16, W8A8) of B1, B2, B6 and B7
// ---------------------------------------------------------------------------
//
// An int8 operand is staged into shared memory at one byte an element (the
// point of int8 weights: half the bytes of bf16 from device memory).  Once a
// staged slab has landed, all threads of the CTA convert it in one pass:
//   W8A16: widen_int8 writes the slab as bf16 (exact: |v| <= 128 needs 8
//     significand bits) into the swizzled tile mma_slab reads, so the bf16
//     chain runs unchanged on the widened weights, step for step and bit
//     for bit (B6 and B7 instead widen their swizzled int8 tiles in
//     registers, mma_slab_b8, the same chain);
//   W8A8: transpose_int8 writes the (k, n) slab k-major ([n][k]), the
//     layout whose ldmatrix gives the .col B fragment of mma.sync m16n8k32
//     s8 (four consecutive k of one column a register), for mma_slab_s8.
// Layouts map (row, column) to a byte offset: Rows8 plain row-major, Swz128
// the tensor memory accelerator's 128-byte swizzle over 128-byte rows (B7's
// int8 panels), Swz8 the bytes of a swizzled SmemTile viewed as b16 (an int8
// tile that ldmatrix reads).

struct Rows8 {
  int ld;  // bytes a row
  __device__ __forceinline__ int at(int r, int c) const { return r * ld + c; }
};

struct Swz128 {
  __device__ __forceinline__ int at(int r, int c) const {
    return r * 128 + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15));
  }
};

// An int8 tile of rows of 2 * t.ld bytes, whose 16-byte chunks are placed as
// those of the b16 tile t: ldmatrix on t reads it.
struct Swz8 {
  SmemTile t;
  __device__ __forceinline__ int at(int r, int c) const {
    return 2 * t.at(r, c >> 1) + (c & 1);
  }
};

// Element offsets of a bf16 SmemTile, as a layout.
struct Tile16 {
  SmemTile t;
  __device__ __forceinline__ int at(int r, int c) const { return t.at(r, c); }
};

// The rows x cols int8 values at src (layout sl) widened to bf16 at dst
// (element layout dl), four a thread at a time: cols % 4 == 0, and both
// layouts keep each group of four columns whole (16-byte / 8-element
// chunks).  kThreads threads take part, tid being this one's index.
template <int kThreads, typename SL, typename DL>
__device__ __forceinline__ void widen_int8(const int8_t* src, const SL& sl,
                                           __nv_bfloat16* dst, const DL& dl,
                                           int rows, int cols, int tid) {
  const int units = cols >> 2;
  for (int i = tid; i < rows * units; i += kThreads) {
    const int r = i / units, c = (i - r * units) << 2;
    const uint32_t w = *reinterpret_cast<const uint32_t*>(src + sl.at(r, c));
    const __nv_bfloat162 lo = __floats2bfloat162_rn(
        static_cast<float>(static_cast<int8_t>(w)),
        static_cast<float>(static_cast<int8_t>(w >> 8)));
    const __nv_bfloat162 hi = __floats2bfloat162_rn(
        static_cast<float>(static_cast<int8_t>(w >> 16)),
        static_cast<float>(static_cast<int8_t>(w >> 24)));
    uint2 v;
    v.x = *reinterpret_cast<const uint32_t*>(&lo);
    v.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst + dl.at(r, c)) = v;
  }
}

// The k_rows x n_cols int8 slab at src (layout sl, row k) transposed into
// dst (layout dl, row n, column k), 4 x 4 bytes a thread; rows k >= k_valid
// read as zero.  k_rows % 4 == 0 and n_cols % 4 == 0.
template <int kThreads, typename SL, typename DL>
__device__ __forceinline__ void transpose_int8(const int8_t* src,
                                               const SL& sl, int8_t* dst,
                                               const DL& dl, int k_rows,
                                               int k_valid, int n_cols,
                                               int tid) {
  const int nb = n_cols >> 2;
  for (int i = tid; i < (k_rows >> 2) * nb; i += kThreads) {
    const int k0 = (i / nb) << 2, n0 = (i - (i / nb) * nb) << 2;
    uint32_t w[4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
      w[x] = k0 + x < k_valid
                 ? *reinterpret_cast<const uint32_t*>(src + sl.at(k0 + x, n0))
                 : 0u;
    // byte j of w[x] is (k0 + x, n0 + j); output word j packs (k0 .. +3,
    // n0 + j), k ascending from the low byte
    const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
    const uint32_t t1 = __byte_perm(w[2], w[3], 0x5140);
    const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
    *reinterpret_cast<uint32_t*>(dst + dl.at(n0 + 0, k0)) =
        __byte_perm(t0, t1, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + dl.at(n0 + 1, k0)) =
        __byte_perm(t0, t1, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + dl.at(n0 + 2, k0)) =
        __byte_perm(t2, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + dl.at(n0 + 3, k0)) =
        __byte_perm(t2, t3, 0x7632);
  }
}

// Bytes s and s + 2 of w (int8) widened to bf16 and packed low, high.
__device__ __forceinline__ uint32_t widen_bytes(uint32_t w, int s) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(
      static_cast<float>(static_cast<int8_t>(w >> (8 * s))),
      static_cast<float>(static_cast<int8_t>(w >> (8 * s + 16))));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The W8A16 chain over one staged k-slab for one warp with B an int8 tile
// widened in registers, with no pass through shared memory.  B is the b16
// view of the int8 tile (its chunks swizzled as a SmemTile's: Swz8, or B7's
// 128-byte swizzle, which is smem_tile(p, 64)'s); ldmatrix.trans of it gives
// lane (g, t), for the 16 columns c0 .. c0 + 15, the bytes B[k][c0 + 2g],
// B[k][c0 + 2g + 1] of rows k = kk + 2t, kk + 2t + 1 (and + 8).  The even
// bytes widened are the B fragment of a virtual n8 fragment of the columns
// c0, c0 + 2, .., c0 + 14, the odd bytes of c0 + 1, .., c0 + 15.  So
// fragment 2p of the warp holds the even and 2p + 1 the odd columns of its
// 16-column group p (b8_col gives a C element's column), and each C element
// is mma_slab's chain on B.to(bfloat16), step for step.  A is a chunked
// tile read as mma_slab reads it; k_len a multiple of 16 (both zero-filled
// to it); b_c0 a multiple of 16; kFN even.
template <int kFM, int kFN, bool kEdge>
__device__ __forceinline__ void mma_slab_b8(float (&acc)[kFM][kFN][4],
                                            const SmemTile& A, int a_r0,
                                            int a_rows, const SmemTile& B,
                                            int b_c0, int k_len) {
  static_assert(kFN % 2 == 0, "16-column groups");
  const int lane = threadIdx.x & 31;
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
#pragma unroll 2
  for (int kk = 0; kk < k_len; kk += 16) {
    uint32_t a[kFM][4];
#pragma unroll
    for (int i = 0; i < kFM; ++i) {
      ldsm_x4(a[i], pa[i] + (((kk >> 3) ^ fa[i]) << 3));
      if (kEdge) {  // a block of at most 8 rows: its other 8 are zero
        a[i][1] = hi[i] ? a[i][1] : 0u;
        a[i][3] = hi[i] ? a[i][3] : 0u;
      }
    }
    const int r = kk + (lane & 15);
#pragma unroll
    for (int p = 0; p < kFN / 2; ++p) {
      const int ch = (b_c0 >> 4) + p;
      uint32_t w0, w1;
      ldsm_x2_t(w0, w1, B.p + r * B.ld + ((ch ^ ((r >> B.sh) & B.mask)) << 3));
      const uint32_t e0 = widen_bytes(w0, 0), e1 = widen_bytes(w1, 0);
      const uint32_t o0 = widen_bytes(w0, 1), o1 = widen_bytes(w1, 1);
#pragma unroll
      for (int i = 0; i < kFM; ++i) {
        mma_bf16(acc[i][2 * p], a[i], e0, e1);
        mma_bf16(acc[i][2 * p + 1], a[i], o0, o1);
      }
    }
  }
}

// The column (from the warp's first) of element e of fragment j in
// mma_slab_b8's layout.
__device__ __forceinline__ int b8_col(int j, int e) {
  return 16 * (j >> 1) + 2 * frag_col(0, e) + (j & 1);
}

// d = a (16x32 s8, row) * b (32x8 s8, col) + d, int32 accumulate (exact).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_addr(p)));
}

// The W8A8 chain over one staged k-slab for one warp, on mma.sync m16n8k32
// s8 with int32 accumulators: for kk = 0, 32, ... < k_len (a multiple of 32;
// the slab zero-filled to it), acc[i][j] += A[a_r0 + 16 i .. +16][a_k0 + kk
// .. +32] * B[kk .. +32][b_c0 + 8 j .. +8].  A is an int8 tile (the b16
// view of its Swz8 layout: ld, in b16, a multiple of 8), Bt the slab
// k-major (transpose_int8, the same view); both by ldmatrix, as mma_slab
// reads bf16 A and mma_qkt reads K.  kEdge: as mma_slab's (A rows past
// a_rows read a copy of the last row present; a block of at most 8 rows has
// its other 8 zero).  The sums are exact, so an element's value does not
// depend on the k order or split.
template <int kFM, int kFN, bool kEdge>
__device__ __forceinline__ void mma_slab_s8(int (&acc)[kFM][kFN][4],
                                            const SmemTile& A, int a_r0,
                                            int a_rows, int a_k0,
                                            const SmemTile& Bt, int b_c0,
                                            int k_len) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  for (int kk = 0; kk < k_len; kk += 32) {
    uint32_t a[kFM][4], b[kFN][2];
#pragma unroll
    for (int i = 0; i < kFM; ++i) {
      const int rows = a_rows - 16 * i;
      const int r = a_r0 + 16 * i +
                    (kEdge ? min(lane & 15, max(rows - 1, 0)) : (lane & 15));
      const int chunk = ((a_k0 + kk) >> 4) + (lane >> 4);
      ldsm_x4(a[i], A.p + r * A.ld + ((chunk ^ ((r >> A.sh) & A.mask)) << 3));
      if (kEdge) {
        a[i][1] = rows > 8 ? a[i][1] : 0u;
        a[i][3] = rows > 8 ? a[i][3] : 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < kFN; j += 2) {
      if (j + 1 < kFN) {
        const int n = b_c0 + 8 * j + 8 * (mi >> 1) + (lane & 7);
        const int chunk = (kk >> 4) + (mi & 1);
        uint32_t r[4];
        ldsm_x4(r, Bt.p + n * Bt.ld +
                       ((chunk ^ ((n >> Bt.sh) & Bt.mask)) << 3));
        b[j][0] = r[0], b[j][1] = r[1], b[j + 1][0] = r[2],
        b[j + 1][1] = r[3];
      } else {
        const int n = b_c0 + 8 * j + (lane & 7);
        const int chunk = (kk >> 4) + (mi & 1);
        ldsm_x2(b[j][0], b[j][1],
                Bt.p + n * Bt.ld + ((chunk ^ ((n >> Bt.sh) & Bt.mask)) << 3));
      }
    }
#pragma unroll
    for (int i = 0; i < kFM; ++i)
#pragma unroll
      for (int j = 0; j < kFN; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
  }
}

}  // namespace repro
