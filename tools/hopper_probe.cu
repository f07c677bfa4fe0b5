// Probes of an sm_90 card behind the port's GEMM kernels (PERF.md §6):
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
//      rate beside it);
//   6. the f32 chain of B1's and B6's f32 bodies (gemm_f32.cuh): (a) the
//      cycles of one dependent fmaf (a chain's step), (b) the fmaf one SM
//      issues a cycle by warps and independent chains a thread, (c) the
//      cycles a k step of the port's own chain_steps takes by the chains a
//      thread keeps (rows x columns) and warps, read from shared memory,
//      (d) the SM clock under a long chain, timed by CUDA events beside
//      clock64, which gives the chain floor k x latency / clock at the
//      routers' k = 4096 and 7168, (e) the rate at which TMA boxes of f32
//      rows 16 to 256 bytes wide fill one SM, and (f) B1's decode ring in
//      miniature, whole, its ring alone and its products alone.
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

#include "../src/repro_torch/csrc/gemm_f32.cuh"
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

// Probe 6 (a) and (d): one dependent chain acc = fmaf(acc, x, y), 64 a
// loop trip (x, y arguments, so nothing folds).
__global__ void ffma_chain(float* out, float x, float y, int iters,
                           long long* cycles) {
  float acc = static_cast<float>(threadIdx.x);
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 64; ++u) acc = fmaf(acc, x, y);
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) *cycles = t1 - t0;
  out[threadIdx.x] = acc;
}

// Probe 6 (b): kChains independent chains a thread, 16 steps a loop trip.
template <int kChains>
__global__ void ffma_rate(float* out, float x, float y, int iters,
                          long long* cycles) {
  float acc[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) acc[j] = threadIdx.x + j;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 16; ++u)
#pragma unroll
      for (int j = 0; j < kChains; ++j) acc[j] = fmaf(acc[j], x, y);
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) *cycles = t1 - t0;
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kChains; ++j) s += acc[j];
  out[threadIdx.x] = s;
}

template <int kChains>
void probe_ffma_rate(float* out, long long* cycles) {
  const int iters = 4096;
  for (int warps : {1, 4, 8, 16, 32}) {
    ffma_rate<kChains><<<1, 32 * warps>>>(out, 0.999f, 1e-3f, iters, cycles);
    cudaDeviceSynchronize();
    const double per = 32.0 * warps * kChains * 16 * iters / *cycles;
    printf("probe 6: fmaf issue: %d chains a thread, %2d warps: %6.1f fmaf "
           "a cycle an SM (%.2f cycles a chain step)\n",
           kChains, warps, per, *cycles / (16.0 * iters));
  }
}

// Probe 6 (c): the port's chain_steps, each thread kR x kC chains laid out
// as in B1's one-warp shapes (thread (ty, tx) of 8 x 4: rows ty + 8 i of
// an A slab of 132-value rows, columns tx kC + j of a B slab of 4 kC
// columns), one 128-deep slab walked ``reps`` times.
template <int kR, int kC>
__global__ void chain_step_rate(float* out, int reps, long long* cycles) {
  constexpr int kLda = 132, kLdb = 4 * kC, kDepth = 128;
  __shared__ __align__(16) float As[8 * kR * kLda];
  __shared__ __align__(16) float Bs[kDepth * kLdb];
  for (int i = threadIdx.x; i < 8 * kR * kLda; i += blockDim.x)
    As[i] = 1e-3f * (i % 7);
  for (int i = threadIdx.x; i < kDepth * kLdb; i += blockDim.x)
    Bs[i] = 1e-3f * (i % 5);
  __syncthreads();
  const int lane = threadIdx.x & 31, ty = lane / 4, tx = lane % 4;
  float acc[kR][kC] = {};
  const long long t0 = clock64();
  for (int r = 0; r < reps; ++r)
    repro::f32::chain_steps<kR, kC>(acc, As + ty * kLda, 8 * kLda,
                                    Bs + tx * kC, kLdb, kDepth);
  const long long t1 = clock64();
  if (threadIdx.x == 0) *cycles = t1 - t0;
  float s = 0.0f;
  for (int i = 0; i < kR; ++i)
    for (int j = 0; j < kC; ++j) s += acc[i][j];
  out[threadIdx.x] = s;
}

template <int kR, int kC>
void probe_chain_steps(float* out, long long* cycles) {
  const int reps = 64;
  for (int warps : {1, 4, 8}) {
    chain_step_rate<kR, kC><<<1, 32 * warps>>>(out, reps, cycles);
    cudaDeviceSynchronize();
    printf("probe 6: chain_steps %d x %d chains a thread, %d warps: %6.2f "
           "cycles a k step\n",
           kR, kC, warps, *cycles / (128.0 * reps));
  }
}

// Probe 6 (e): the rate at which TMA boxes of f32 rows fill one SM, by the
// rows' bytes: each CTA streams its own strip of box_cols columns of a
// 4096 x 4096 f32 matrix, box_rows rows a box, through ``stages`` stages
// (the B strips of B1's decode shapes are 4 to 16 columns wide).
__global__ void f32_box_rate(const __grid_constant__ CUtensorMap map,
                             int rows, int box_rows, int box_cols,
                             int stages, long long* cycles, float* sink) {
  extern __shared__ __align__(16) unsigned char raw[];
  unsigned char* ring = raw + ((128 - (repro::smem_addr(raw) & 127)) & 127);
  __shared__ uint64_t full[16];
  if (threadIdx.x != 0) return;
  for (int s = 0; s < stages; ++s) repro::mbar_init(&full[s]);
  repro::fence_barrier_init();
  const int box = box_rows * box_cols * 4, n = rows / box_rows;
  const int col = box_cols * blockIdx.x;
  float acc = 0.0f;
  const long long t0 = clock64();
  for (int i = 0; i < stages && i < n; ++i) {
    repro::mbar_expect(&full[i], box);
    repro::tma_2d(ring + i * box, &map, col, i * box_rows, &full[i]);
  }
  for (int i = 0; i < n; ++i) {
    const int s = i % stages;
    repro::mbar_wait(&full[s], (i / stages) & 1);
    acc += ring[s * box + (i & 15)];
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

void probe_f32_boxes(long long* cycles, float* sink) {
  const int n = 4096;
  float* src;
  cudaMalloc(&src, static_cast<size_t>(n) * n * 4);
  cudaMemset(src, 0, static_cast<size_t>(n) * n * 4);
  cudaFuncSetAttribute(f32_box_rate,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       200 * 1024);
  for (int box_cols : {4, 8, 16, 32, 64})
    for (int box_rows : {128, 256})
      for (int stages : {4, 8}) {
        const int smem = stages * box_rows * box_cols * 4 + 128;
        if (smem > 200 * 1024) continue;
        CUtensorMap map;
        if (!repro::tensor_map_2d(&map, src, 4, n, n, n, box_cols,
                                  box_rows)) {
          printf("probe 6: no tensor map\n");
          return;
        }
        for (int rep = 0; rep < 2; ++rep) {
          f32_box_rate<<<32, 32, smem>>>(map, n, box_rows, box_cols, stages,
                                         cycles, sink);
          cudaDeviceSynchronize();
        }
        printf("probe 6: TMA f32 boxes %3d rows x %3d B, %d stages, 32 "
               "CTAs: %5.1f B a cycle an SM\n",
               box_rows, box_cols * 4, stages,
               static_cast<double>(n) * box_cols * 4 / *cycles);
      }
  cudaFree(src);
}

// Probe 6 (f): B1's decode shape in miniature: two warps a CTA, 8 rows x 8
// columns (a warp 4 rows x 8 lanes), a ring of 6 stages of 256-deep slabs
// (A's 8 x 256 box and B's 256 x 8 box) filled by thread 0's TMA boxes,
// chain_steps 1 x 1 on each; ``mode`` 0 runs it whole, 1 the ring alone
// (no products), 2 the products alone on the first stage (no ring).  16
// CTAs over a 4096-deep k: qwen3-moe's decode router.
__global__ void decode_ring_rate(const __grid_constant__ CUtensorMap map_a,
                                 const __grid_constant__ CUtensorMap map_b,
                                 int k, int mode, long long* cycles,
                                 float* sink) {
  constexpr int kKS = 256, kStages = 6, kA = 8 * kKS, kB = kKS * 8;
  extern __shared__ __align__(16) unsigned char raw[];
  // a tensor copy lands on a 128-byte-aligned address
  float* st = reinterpret_cast<float*>(
      raw + ((128 - (repro::smem_addr(raw) & 127)) & 127));
  __shared__ uint64_t full[kStages];
  const int lane = threadIdx.x, ty = lane / 8, tx = lane % 8;
  const int col0 = blockIdx.x * 8, slabs = k / kKS;
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) repro::mbar_init(&full[s]);
    repro::fence_barrier_init();
  }
  __syncthreads();
  auto issue = [&](int i) {
    float* d = st + (i % kStages) * (kA + kB);
    repro::mbar_expect(&full[i % kStages], (kA + kB) * 4);
    repro::tma_2d(d, &map_a, i * kKS, 0, &full[i % kStages]);
    repro::tma_2d(d + kA, &map_b, col0, i * kKS, &full[i % kStages]);
  };
  float acc[1][1] = {{0.0f}};
  const long long t0 = clock64();
  if (mode != 2 && lane == 0)
    for (int i = 0; i < kStages - 1 && i < slabs; ++i) issue(i);
  for (int i = 0; i < slabs; ++i) {
    if (mode != 2) repro::mbar_wait(&full[i % kStages], (i / kStages) & 1);
    __syncthreads();
    if (mode != 2 && lane == 0 && i + kStages - 1 < slabs) {
      repro::fence_proxy_async();
      issue(i + kStages - 1);
    }
    if (mode != 1) {
      const float* d = st + (mode == 2 ? 0 : (i % kStages) * (kA + kB));
      repro::f32::chain_steps<1, 1>(acc, d + ty * kKS, 8 * kKS,
                                    d + kA + tx, 8, kKS);
    }
  }
  if (blockIdx.x == 0 && lane == 0) *cycles = clock64() - t0;
  sink[blockIdx.x * 64 + lane] = acc[0][0];
}

void probe_decode_ring(long long* cycles, float* sink) {
  const int k = 4096, n = 128;
  float *a, *b;
  cudaMalloc(&a, 8 * k * 4);
  cudaMalloc(&b, static_cast<size_t>(k) * n * 4);
  cudaMemset(a, 0, 8 * k * 4);
  cudaMemset(b, 0, static_cast<size_t>(k) * n * 4);
  CUtensorMap ma, mb;
  if (!repro::tensor_map_2d(&ma, a, 4, 8, k, k, 256, 8) ||
      !repro::tensor_map_2d(&mb, b, 4, k, n, n, 8, 256)) {
    printf("probe 6: no tensor map\n");
    return;
  }
  const int smem = 6 * (8 * 256 + 256 * 8) * 4 + 128;
  cudaFuncSetAttribute(decode_ring_rate,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const char* what[] = {"whole", "ring alone", "products alone"};
  for (int mode = 0; mode < 3; ++mode) {
    for (int rep = 0; rep < 2; ++rep) {
      decode_ring_rate<<<16, 64, smem>>>(ma, mb, k, mode, cycles, sink);
      cudaDeviceSynchronize();
    }
    printf("probe 6: B1 decode ring (2 warps of 4 x 8, 256-deep slabs, 6 "
           "stages), %s: %.2f cycles a k step\n", what[mode],
           *cycles / static_cast<double>(k));
  }
  cudaFree(a);
  cudaFree(b);
}

// Probe 6: prints the fmaf latency, the issue rates, the chain_steps rates,
// the TMA fill of f32 boxes, the decode ring, and the clock and chain
// floor.
void probe_ffma(float* out, long long* cycles) {
  const int iters = 1 << 14;
  ffma_chain<<<1, 32>>>(out, 0.999f, 1e-3f, 16, cycles);  // warm-up
  cudaDeviceSynchronize();
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  ffma_chain<<<1, 32>>>(out, 0.999f, 1e-3f, iters, cycles);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double lat = *cycles / (64.0 * iters);
  const double mhz = *cycles / (ms * 1e3);
  printf("probe 6: fmaf dependent chain: %.2f cycles an fmaf (one warp, "
         "%d fmaf)\n", lat, 64 * iters);
  probe_ffma_rate<1>(out, cycles);
  probe_ffma_rate<2>(out, cycles);
  probe_ffma_rate<4>(out, cycles);
  probe_ffma_rate<8>(out, cycles);
  probe_chain_steps<1, 1>(out, cycles);
  probe_chain_steps<1, 2>(out, cycles);
  probe_chain_steps<1, 4>(out, cycles);
  probe_chain_steps<2, 1>(out, cycles);
  probe_chain_steps<2, 4>(out, cycles);
  probe_chain_steps<4, 4>(out, cycles);
  probe_chain_steps<8, 4>(out, cycles);
  probe_f32_boxes(cycles, out);
  probe_decode_ring(cycles, out);
  printf("probe 6: SM clock under the chain %.0f MHz (clock64 over CUDA "
         "events, %.3f ms); chain floor k x %.2f cycles / clock: k 4096 "
         "%.2f us, k 7168 %.2f us\n",
         mhz, ms, lat, 4096 * lat / mhz, 7168 * lat / mhz);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
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
  probe_ffma(out, cycles);
  const cudaError_t err = cudaGetLastError();
  printf("%s\n", cudaGetErrorString(err));
  return err == cudaSuccess && sane ? 0 : 1;
}
