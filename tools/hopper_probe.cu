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
//      GEMMs' case, beside probe 1's bare dependent chain.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o hopper_probe tools/hopper_probe.cu && ./hopper_probe
//
// Prints one line a configuration; cycles come from clock64 in CTA 0.
#include <cuda_bf16.h>

#include <cstdint>
#include <cstdio>

#include "../src/repro_torch/csrc/mma_chain.cuh"

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
  const cudaError_t err = cudaGetLastError();
  printf("%s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
