// Two probes of an sm_90 card behind the port's GEMM kernels (PERF.md §6):
//
//   1. mma.sync.m16n8k16 bf16 -> f32 throughput of one SM, by warps and by
//      independent accumulator chains a warp (the shape of a warp's work in
//      B1 and B6);
//   2. the rate at which one CTA a SM streams rows from device memory into
//      shared memory with 16-byte cp.async, by row width and by the bytes in
//      flight (the B tiles of the decode GEMMs);
//   3. the cycles a 16-deep step of the port's own chain (mma_chain.cuh
//      mma_slab) takes for one warp owning one m16n8 fragment, the decode
//      GEMMs' case, beside probe 1's bare dependent chain;
//   4. the bits of the chain: C (64 x N) = C0 + A (64 x k) B (k x N) over
//      k = 16 .. 4096, from zero and from a non-zero f32 C0, computed (a) by
//      mma_chain.cuh's mma_slab (mma.sync m16n8k16, k ascending), (b) by
//      wgmma.mma_async m64nNk16 (wgmma.cuh; N = 8, 64, 128, 256) and (c) by
//      wgmma with the operands' roles swapped (C^T = B^T A^T, the rows of C
//      on wgmma's N side: N = 8, 16, 64), both operands of (b) and (c) read
//      from the same 128-byte-swizzled stages that TMA (tma.cuh) filled and
//      (a) reads by ldmatrix; each of (b) and (c) is held to (a) bit for bit
//      and all three to a float64 sum (a layout error shows as a large
//      difference, a rounding one as a small one);
//   5. the rate at which TMA box copies stream rows of 128 bytes from
//      device memory into one SM's shared memory, by box rows and by the
//      stages in flight (one thread a CTA issues them; probe 2's cp.async
//      rate beside it).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o hopper_probe tools/hopper_probe.cu && ./hopper_probe
//
// Prints one line a configuration; cycles come from clock64 in CTA 0.
#include <cuda_bf16.h>

#include <cstdint>
#include <cstdio>

#include <cmath>
#include <cstring>
#include <vector>

#include "../src/repro_torch/csrc/mma_chain.cuh"
#include "../src/repro_torch/csrc/tma.cuh"
#include "../src/repro_torch/csrc/wgmma.cuh"

template <int kChains>
__global__ void mma_rate(float* out, int iters, long long* cycles) {
  const int lane = threadIdx.x & 31;
  float d[kChains][4] = {};
  uint32_t a[4] = {1u + lane, 2, 3, 4}, b[kChains][2];
  for (int j = 0; j < kChains; ++j) b[j][0] = j, b[j][1] = j + 1;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kChains; ++j)
      asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[j][0]),
            "r"(b[j][1]));
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) *cycles = t1 - t0;
  float x = 0.0f;
  for (int j = 0; j < kChains; ++j)
    for (int e = 0; e < 4; ++e) x += d[j][e];
  out[threadIdx.x] = x;
}

template <int kChains>
void probe_mma(float* out, long long* cycles) {
  const int iters = 2048;
  for (int warps : {1, 4, 8, 16}) {
    mma_rate<kChains><<<1, 32 * warps>>>(out, iters, cycles);
    cudaDeviceSynchronize();
    const double c = *cycles / static_cast<double>(iters);
    printf("mma.sync: %d chains a warp, %2d warps: %6.1f cycles an "
           "iteration, %.2f HMMA a cycle\n",
           kChains, warps, c, kChains * warps / c);
  }
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// CTA b streams `rows` rows of `row_bytes` at column b * row_bytes (row
// stride ld bytes) through `stages` groups of `rows_per_stage` rows, keeping
// stages - 1 groups in flight.
__global__ void stream_rate(const char* src, int rows, int row_bytes,
                            long ld, int rows_per_stage, int stages,
                            long long* cycles, float* sink) {
  extern __shared__ __align__(16) char smem[];
  const int units = row_bytes / 16, stage_bytes = rows_per_stage * row_bytes;
  const char* base = src + static_cast<long>(blockIdx.x) * row_bytes;
  const int groups = rows / rows_per_stage;
  auto issue = [&](int g) {
    char* d = smem + (g % stages) * stage_bytes;
    for (int i = threadIdx.x; i < rows_per_stage * units; i += blockDim.x) {
      const int r = i / units, u = i % units;
      cp16(d + r * row_bytes + u * 16,
           base + static_cast<long>(g * rows_per_stage + r) * ld + u * 16);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  const long long t0 = clock64();
  for (int g = 0; g < stages - 1; ++g) issue(g);
  float acc = 0.0f;
  for (int g = 0; g < groups; ++g) {
    if (g + stages - 1 < groups)
      issue(g + stages - 1);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(7) : "memory");
    __syncthreads();
    acc += smem[(g % stages) * stage_bytes + threadIdx.x];
    __syncthreads();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (threadIdx.x == 0 && blockIdx.x == 0) *cycles = clock64() - t0;
  sink[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

void probe_stream(long long* cycles, float* sink) {
  char* src;
  cudaMalloc(&src, 1L << 30);
  cudaMemset(src, 1, 1L << 30);
  cudaFuncSetAttribute(stream_rate,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       200 * 1024);
  struct Case {
    int ctas, row_bytes;
    long ld;
    int rows_per_stage;
  };
  // 64-byte rows at a 1920-byte stride: a 32-column bf16 tile of a
  // 960-wide weight; 512-byte rows: wide tiles
  const Case cases[] = {{30, 64, 1920, 64},  {30, 64, 1920, 128},
                        {30, 64, 1920, 256}, {132, 64, 1920, 128},
                        {30, 512, 1 << 16, 32}, {132, 512, 1 << 16, 32}};
  const int stages = 9, rows = 4096;
  for (const Case& c : cases) {
    const int smem = c.rows_per_stage * c.row_bytes * stages;
    for (int rep = 0; rep < 2; ++rep)
      stream_rate<<<c.ctas, 256, smem>>>(src, rows, c.row_bytes, c.ld,
                                         c.rows_per_stage, stages, cycles,
                                         sink);
    cudaDeviceSynchronize();
    const double per_sm = static_cast<double>(rows) * c.row_bytes / *cycles;
    printf("cp.async: %3d CTAs, rows of %3d B, %6d B in flight a CTA: "
           "%5.1f B a cycle an SM\n",
           c.ctas, c.row_bytes, c.rows_per_stage * c.row_bytes * (stages - 1),
           per_sm);
  }
  cudaFree(src);
}

// One warp runs mma_slab over a staged 16 x 128 slab of A and 128 x 8 of B,
// `reps` times in a row (one chain of 8 reps 16-deep steps).
__global__ void slab_rate(float* out, int reps, long long* cycles) {
  __shared__ __align__(16) __nv_bfloat16 a[16 * 128], b[128 * 8];
  for (int i = threadIdx.x; i < 16 * 128; i += 32)
    a[i] = __float2bfloat16(0.001f * (i % 7));
  for (int i = threadIdx.x; i < 128 * 8; i += 32)
    b[i] = __float2bfloat16(0.001f * (i % 5));
  __syncwarp();
  const repro::SmemTile at = repro::smem_tile(a, 128);
  const repro::SmemTile bt = repro::smem_tile(b, 8);
  float acc[1][1][4] = {};
  const long long t0 = clock64();
  for (int r = 0; r < reps; ++r)
    repro::mma_slab<1, 1, true>(acc, at, 0, 16, bt, 0, 8, 128);
  const long long t1 = clock64();
  if (threadIdx.x == 0) *cycles = t1 - t0;
  out[threadIdx.x] = acc[0][0][0] + acc[0][0][1] + acc[0][0][2] +
                     acc[0][0][3];
}

void probe_slab(float* out, long long* cycles) {
  const int reps = 256;
  slab_rate<<<1, 32>>>(out, reps, cycles);
  cudaDeviceSynchronize();
  printf("mma_slab: 1 warp, one m16n8 fragment, 128-deep slabs: %.1f "
         "cycles a 16-deep step\n",
         *cycles / (8.0 * reps));
}


// ---------------------------------------------------------------------------
// Probe 4: the chain's bits under mma.sync and wgmma
// ---------------------------------------------------------------------------

constexpr int kProbeK = 4096, kProbeN = 256;

// One warpgroup; k in 64-deep slabs, each one TMA stage: A's 64 rows x 64 k
// (8 KB) and four 64-column panels of B (64 k x 64 n, 8 KB each), all in the
// 128-byte swizzle.  kMode 0: (a) mma_slab, each warp its 16 rows and N
// columns; 1: (b) Wgmma<N, 0, 1> (A K-major, B MN-major); 2: (c)
// Wgmma<N, 1, 0> with B's first panel as the 64-row operand (MN-major) and
// A's first N rows as the N side (K-major), the accumulator C^T.  out and c0
// are 64 x kProbeN f32, C[m][n] (c0 null: from zero).
template <int kMode, int N>
__global__ void __launch_bounds__(128)
chain_bits(const __grid_constant__ CUtensorMap map_a,
           const __grid_constant__ CUtensorMap map_b, const float* c0,
           float* out, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (repro::smem_addr(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(sm);
  __nv_bfloat16* bs = as + 64 * 64;
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    repro::mbar_init(&bar);
    repro::fence_barrier_init();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  float acc[N / 8][4];
  // element (j, e): row r, column c of this warpgroup's 64 x N block
  // (of C^T under kMode 2)
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * warp + repro::frag_row(0, e);
      const int c = repro::frag_col(j, e);
      const int at = kMode == 2 ? c * kProbeN + r : r * kProbeN + c;
      acc[j][e] = c0 != nullptr ? c0[at] : 0.0f;
    }
  int phase = 0;
  for (int k0 = 0; k0 < K; k0 += 64) {
    if (threadIdx.x == 0) {
      repro::fence_proxy_async();
      repro::mbar_expect(&bar, 5 * 8192);
      repro::tma_2d(as, &map_a, k0, 0, &bar);
      for (int p = 0; p < 4; ++p)
        repro::tma_2d(bs + p * 64 * 64, &map_b, 64 * p, k0, &bar);
    }
    repro::mbar_wait(&bar, phase);
    phase ^= 1;
    const int klen = (min(64, K - k0) + 15) & ~15;
    if constexpr (kMode == 0) {
      constexpr int kFN = N < 64 ? N / 8 : 8;
#pragma unroll
      for (int p = 0; p < (N + 63) / 64; ++p)
        repro::mma_slab<1, kFN, false>(
            *reinterpret_cast<float(*)[1][kFN][4]>(&acc[8 * p]),
            repro::smem_tile(as, 64), 16 * warp, 16,
            repro::smem_tile(bs + p * 64 * 64, 64), 0, 64, klen);
    } else {
      const uint64_t da = repro::wgmma_desc(as, repro::kWg128, 16, 1024);
      const uint64_t db = repro::wgmma_desc(bs, repro::kWg128, 8192, 1024);
      // one product at a time, waited for: nothing else touches the
      // accumulators while wgmma writes them
      for (int s = 0; s < klen / 16; ++s) {
        repro::wgmma_hold(acc);
        repro::wgmma_fence();
        if constexpr (kMode == 1)
          repro::Wgmma<N, 0, 1>::run(acc, repro::wgmma_desc_add(da, 32 * s),
                                     repro::wgmma_desc_add(db, 2048 * s));
        else
          repro::Wgmma<N, 1, 0>::run(acc, repro::wgmma_desc_add(db, 2048 * s),
                                     repro::wgmma_desc_add(da, 32 * s));
        repro::wgmma_commit();
        repro::wgmma_wait<0>();
        repro::wgmma_hold(acc);
      }
    }
    __syncthreads();  // every warp is done with the stage
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * warp + repro::frag_row(0, e);
      const int c = repro::frag_col(j, e);
      out[kMode == 2 ? c * kProbeN + r : r * kProbeN + c] = acc[j][e];
    }
}

struct Lcg {
  uint64_t s;
  uint32_t next() {
    s = s * 6364136223846793005ull + 1442695040888963407ull;
    return static_cast<uint32_t>(s >> 33);
  }
  // sign * [1, 2) * 2^[lo, hi]
  float value(int lo, int hi) {
    const float m = 1.0f + (next() % 1024) / 1024.0f;
    const int e = lo + static_cast<int>(next() % (hi - lo + 1));
    return (next() & 1 ? -1.0f : 1.0f) * std::ldexp(m, e);
  }
};

template <int kMode, int N>
void run_bits(const CUtensorMap& ma, const CUtensorMap& mb, const float* c0,
              float* out, int K) {
  cudaMemset(out, 0xff, 64 * kProbeN * sizeof(float));  // NaN: not written
  chain_bits<kMode, N><<<1, 128, 1024 + 5 * 8192>>>(ma, mb, c0, out, K);
  cudaDeviceSynchronize();
}

// Compares rows x cols of got against ref (both 64 x kProbeN): elements whose
// bits differ, and the largest difference.
int differ(const std::vector<float>& got, const std::vector<float>& ref,
           int rows, int cols, double* max_diff) {
  int n = 0;
  *max_diff = 0.0;
  for (int r = 0; r < rows; ++r)
    for (int c = 0; c < cols; ++c) {
      const float g = got[r * kProbeN + c], w = ref[r * kProbeN + c];
      uint32_t gb, wb;
      memcpy(&gb, &g, 4), memcpy(&wb, &w, 4);
      n += gb != wb;
      const double d = std::fabs(static_cast<double>(g) - w);
      *max_diff = std::isnan(d) ? INFINITY : std::fmax(*max_diff, d);
    }
  return n;
}

bool probe_bits() {
  const int M = 64;
  std::vector<__nv_bfloat16> ha(M * kProbeK), hb(kProbeK * kProbeN);
  std::vector<float> fa(M * kProbeK), fb(kProbeK * kProbeN), hc(M * kProbeN);
  Lcg g{12345};
  for (int i = 0; i < M * kProbeK; ++i) {
    ha[i] = __float2bfloat16(g.value(-6, 6));
    fa[i] = __bfloat162float(ha[i]);
  }
  // columns 0..63: B[k][c] = +-A[c][k] with alternating signs, so row c of
  // C sums nearly cancelling terms; the rest random
  for (int k = 0; k < kProbeK; ++k)
    for (int c = 0; c < kProbeN; ++c) {
      const float v = c < M ? (k & 1 ? -1.0f : 1.0f) * fa[c * kProbeK + k] *
                                  std::ldexp(1.0f, (k % 5) - 2)
                            : g.value(-6, 6);
      hb[k * kProbeN + c] = __float2bfloat16(v);
      fb[k * kProbeN + c] = __bfloat162float(hb[k * kProbeN + c]);
    }
  for (int i = 0; i < M * kProbeN; ++i) hc[i] = g.value(-20, 12);
  __nv_bfloat16 *da, *db;
  float *dc, *da_out, *db_out;
  cudaMalloc(&da, ha.size() * 2);
  cudaMalloc(&db, hb.size() * 2);
  cudaMalloc(&dc, hc.size() * 4);
  cudaMalloc(&da_out, hc.size() * 4);
  cudaMalloc(&db_out, hc.size() * 4);
  cudaMemcpy(da, ha.data(), ha.size() * 2, cudaMemcpyHostToDevice);
  cudaMemcpy(db, hb.data(), hb.size() * 2, cudaMemcpyHostToDevice);
  cudaMemcpy(dc, hc.data(), hc.size() * 4, cudaMemcpyHostToDevice);
  std::vector<float> ra(hc.size()), rb(hc.size());
  bool same_b = true, same_c = true, sane = true;
  long long n_b = 0, n_c = 0;
  for (int K : {16, 48, 64, 208, 1000, 1024, 4096}) {
    // the k tail past K lands as zeros: the maps end at K
    CUtensorMap ma, mb;
    if (!repro::tensor_map_2d(&ma, da, 2, M, K, kProbeK, 64, 64) ||
        !repro::tensor_map_2d(&mb, db, 2, K, kProbeN, kProbeN, 64, 64)) {
      printf("probe 4: no tensor map\n");
      return false;
    }
    for (int init = 0; init < 2; ++init) {
      const float* c0 = init ? dc : nullptr;
      run_bits<0, 256>(ma, mb, c0, da_out, K);
      cudaMemcpy(ra.data(), da_out, ra.size() * 4, cudaMemcpyDeviceToHost);
      // (a) against a float64 sum
      double worst = 0.0;
      for (int r = 0; r < M; ++r)
        for (int c = 0; c < kProbeN; ++c) {
          double s = init ? hc[r * kProbeN + c] : 0.0, mag = std::fabs(s);
          for (int k = 0; k < K; ++k) {
            const double p = static_cast<double>(fa[r * kProbeK + k]) *
                             fb[k * kProbeN + c];
            s += p, mag += std::fabs(p);
          }
          worst = std::fmax(worst, std::fabs(ra[r * kProbeN + c] - s) /
                                       (mag > 0 ? mag : 1.0));
        }
      sane = sane && worst < 1e-5;
      printf("probe 4: K %4d, C0 %s: (a) mma_slab vs float64: largest "
             "error %.3g of the sum of |terms|\n",
             K, init ? "non-zero" : "zero", worst);
      auto report = [&](const char* what, int n, int rows, int cols,
                        bool swapped) {
        cudaMemcpy(rb.data(), db_out, rb.size() * 4, cudaMemcpyDeviceToHost);
        double md;
        const int d = differ(rb, ra, rows, cols, &md);
        printf("probe 4: K %4d, C0 %s: (%c) %s n%-3d: %d of %d elements "
               "differ in bits from (a), largest difference %.3g\n",
               K, init ? "non-zero" : "zero", swapped ? 'c' : 'b', what, n,
               d, rows * cols, md);
        if (swapped)
          same_c = same_c && d == 0, n_c += d;
        else
          same_b = same_b && d == 0, n_b += d;
      };
      run_bits<1, 8>(ma, mb, c0, db_out, K);
      report("wgmma m64k16", 8, M, 8, false);
      run_bits<1, 64>(ma, mb, c0, db_out, K);
      report("wgmma m64k16", 64, M, 64, false);
      run_bits<1, 128>(ma, mb, c0, db_out, K);
      report("wgmma m64k16", 128, M, 128, false);
      run_bits<1, 256>(ma, mb, c0, db_out, K);
      report("wgmma m64k16", 256, M, 256, false);
      run_bits<2, 8>(ma, mb, c0, db_out, K);
      report("wgmma m64k16 swapped", 8, 8, 64, true);
      run_bits<2, 16>(ma, mb, c0, db_out, K);
      report("wgmma m64k16 swapped", 16, 16, 64, true);
      run_bits<2, 64>(ma, mb, c0, db_out, K);
      report("wgmma m64k16 swapped", 64, 64, 64, true);
    }
  }
  cudaFree(da), cudaFree(db), cudaFree(dc), cudaFree(da_out),
      cudaFree(db_out);
  printf("probe 4 verdict: (a) within 1e-5 of float64: %s; (b) wgmma == "
         "mma.sync chain bit for bit: %s (%lld elements differ); (c) "
         "swapped wgmma == chain: %s (%lld differ)\n",
         sane ? "yes" : "no", same_b ? "yes" : "no", n_b,
         same_c ? "yes" : "no", n_c);
  return sane;
}

// ---------------------------------------------------------------------------
// Probe 5: TMA's streaming rate into one SM
// ---------------------------------------------------------------------------

// CTA b streams `rows` rows of 128 bytes (its own 64-column strip of a bf16
// tensor) as boxes of box_rows rows through `stages` stages, all of them in
// flight; one thread issues and waits.
__global__ void tma_rate(const __grid_constant__ CUtensorMap map, int rows,
                         int box_rows, int stages, long long* cycles,
                         float* sink) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (repro::smem_addr(smem_raw) & 1023)) & 1023);
  __shared__ uint64_t full[16];
  if (threadIdx.x != 0) return;
  for (int s = 0; s < stages; ++s) repro::mbar_init(&full[s]);
  repro::fence_barrier_init();
  const int box = box_rows * 128, n = rows / box_rows, col = 64 * blockIdx.x;
  float acc = 0.0f;
  const long long t0 = clock64();
  for (int i = 0; i < stages && i < n; ++i) {
    repro::mbar_expect(&full[i], box);
    repro::tma_2d(ring + i * box, &map, col, i * box_rows, &full[i]);
  }
  for (int i = 0; i < n; ++i) {
    const int s = i % stages;
    repro::mbar_wait(&full[s], (i / stages) & 1);
    acc += ring[s * box + (i & 127)];
    if (i + stages < n) {
      repro::fence_proxy_async();
      repro::mbar_expect(&full[s], box);
      repro::tma_2d(ring + s * box, &map, col, (i + stages) * box_rows,
                    &full[s]);
    }
  }
  if (blockIdx.x == 0) *cycles = clock64() - t0;
  sink[blockIdx.x] = acc;
}

void probe_tma(long long* cycles, float* sink) {
  const int rows = 8192, cols = 64 * 132;
  __nv_bfloat16* src;
  cudaMalloc(&src, static_cast<size_t>(rows) * cols * 2);
  cudaMemset(src, 1, static_cast<size_t>(rows) * cols * 2);
  cudaFuncSetAttribute(tma_rate, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       200 * 1024);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0), cudaEventCreate(&e1);
  for (int ctas : {30, 132})
    for (int box_rows : {32, 64, 128, 256})
      for (int stages : {2, 4, 8}) {
        const int smem = stages * box_rows * 128 + 1024;
        if (smem > 200 * 1024) continue;
        CUtensorMap map;
        if (!repro::tensor_map_2d(&map, src, 2, rows, cols, cols, 64,
                                  box_rows)) {
          printf("probe 5: no tensor map\n");
          return;
        }
        float ms = 0.0f;
        for (int rep = 0; rep < 2; ++rep) {
          cudaEventRecord(e0);
          tma_rate<<<ctas, 32, smem>>>(map, rows, box_rows, stages, cycles,
                                       sink);
          cudaEventRecord(e1);
          cudaEventSynchronize(e1);
          cudaEventElapsedTime(&ms, e0, e1);
        }
        const double per_sm = static_cast<double>(rows) * 128 / *cycles;
        printf("TMA: %3d CTAs, boxes of %3d rows x 128 B, %d stages (%6d B "
               "in flight a CTA): %5.1f B a cycle an SM, %6.1f GB/s the "
               "card\n",
               ctas, box_rows, stages, stages * box_rows * 128, per_sm,
               static_cast<double>(rows) * 128 * ctas / (ms * 1e6));
      }
  cudaFree(src);
}

int main() {
  float* out;
  long long* cycles;
  cudaMalloc(&out, 1 << 22);
  cudaMallocManaged(&cycles, sizeof(long long));
  probe_mma<1>(out, cycles);
  probe_mma<2>(out, cycles);
  probe_mma<4>(out, cycles);
  probe_stream(cycles, out);
  probe_slab(out, cycles);
  const bool sane = probe_bits();
  probe_tma(cycles, out);
  const cudaError_t err = cudaGetLastError();
  printf("%s\n", cudaGetErrorString(err));
  return err == cudaSuccess && sane ? 0 : 1;
}
