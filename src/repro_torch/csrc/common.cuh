// Shared helpers of the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

// Operand / output type codes passed from Python (kernels/_build.py
// DTYPE_CODES).
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2, kI32 = 3 };

// Activation codes (kernels/epilogue.py ACT_CODES).
enum Act : int { kNone = 0, kSilu = 1, kGelu = 2, kRelu = 3 };

// Large-negative mask value of the JAX reference (kernels/ref.py NEG_INF).
constexpr float kNegInf = -1e30f;

// log2 e: the tensor-core attention bodies take exp2 of scores scaled by it.
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {  // exact
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like torch's cast
}
template <>  // the staging copies' zero fill (an integral x)
__device__ __forceinline__ int8_t from_f32<int8_t>(float x) {
  return static_cast<int8_t>(x);
}
template <>  // the same, for B6's int32 partial sums
__device__ __forceinline__ int from_f32<int>(float x) {
  return static_cast<int>(x);
}

// The epilogue activations in f32; gelu is the tanh approximation.
__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kSilu:
      return x / (1.0f + expf(-x));
    case kGelu: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case kRelu:
      return fmaxf(x, 0.0f);
    default:
      return x;
  }
}

// The fused flush on a finished f32 accumulator: + bias -> activation ->
// + residual.  Kernels B1 (gemm_aie.cu), B6 (gemm_tb.cu) and B7
// (gemm_grouped.cu) all call it, on the accumulators of mma_chain.cuh's
// tensor-core chain (bf16 operands) and of their fmaf chains (f32
// operands); the adds are __fadd_rn (never contracted into an FMA with
// what comes before), so the dataflows round identically.
__device__ __forceinline__ float epilogue(float x, bool has_bias, float bias,
                                          int act, bool has_res, float res) {
  if (has_bias) x = __fadd_rn(x, bias);
  x = activate(x, act);
  if (has_res) x = __fadd_rn(x, res);
  return x;
}

// The epilogue's int8 output quantization (repro/kernels/epilogue.py:126-128,
// after the residual): x / s, divided (not multiplied by a reciprocal),
// rounded half to even, clipped to +-127.
__device__ __forceinline__ int8_t quantize_out(float x, float s) {
  const float q = rintf(__fdiv_rn(x, s));
  return static_cast<int8_t>(fminf(fmaxf(q, -127.0f), 127.0f));
}

// A flushed value stored at C[at] in C's type: f32, bf16 (nearest even),
// or int8 quantized by the output scale *out_scale.
__device__ __forceinline__ void store_out(void* C, size_t at, float x,
                                          int dtype, const float* out_scale) {
  if (dtype == kBF16)
    static_cast<__nv_bfloat16*>(C)[at] = __float2bfloat16(x);
  else if (dtype == kI8)
    static_cast<int8_t*>(C)[at] = quantize_out(x, *out_scale);
  else
    static_cast<float*>(C)[at] = x;
}

// The weight dequantization of a W8A16 / W8A8 flush: the accumulator times
// its column's scale, one rounding (never contracted with the bias add).
__device__ __forceinline__ float dequant(float x, const float* scale,
                                         int col) {
  return scale != nullptr ? __fmul_rn(x, scale[col]) : x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Programmatic dependent launch (sm_90): a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start before the
// kernel ahead of it in the stream ends.  grid_dependency_wait() blocks until
// that kernel has completed and its writes are visible (a no-op in a kernel
// launched without the attribute); grid_launch_dependents() lets the next
// such kernel start once every CTA of this one has called it or exited.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n");
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace repro
