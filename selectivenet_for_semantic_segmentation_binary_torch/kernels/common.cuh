// Device code shared by the port's kernels: the BatchNorm-apply prologue of
// the fused-CBR kernels (8 channels of an NHWC pixel, or 8 samples of one
// channel in the transposed layout) and the fixed-order sum of per-CTA
// partials that makes their statistics, and bn_stats', the same run to run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsReduceThreads = 256;

// relu(x * a + b) of 8 bf16 channels, rounded back to bf16. __fmul_rn and
// __fadd_rn keep the compiler from contracting to an fma, so xn equals the
// plain PyTorch version's bit for bit.
__device__ __forceinline__ uint4 prologue8(uint4 v, const float* a, const float* b) {
  const float4 a0 = __ldg(reinterpret_cast<const float4*>(a));
  const float4 a1 = __ldg(reinterpret_cast<const float4*>(a) + 1);
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(b));
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(b) + 1);
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(p[j]);
    const float lo = fmaxf(__fadd_rn(__fmul_rn(f.x, av[2 * j]), bv[2 * j]), 0.0f);
    const float hi = fmaxf(__fadd_rn(__fmul_rn(f.y, av[2 * j + 1]), bv[2 * j + 1]), 0.0f);
    p[j] = __floats2bfloat162_rn(lo, hi);
  }
  return v;
}

// relu(x * a + b) of one bf16 value, with prologue8's arithmetic.
__device__ __forceinline__ __nv_bfloat16 prologue1(__nv_bfloat16 v, float a, float b) {
  return __float2bfloat16_rn(fmaxf(__fadd_rn(__fmul_rn(__bfloat162float(v), a), b), 0.0f));
}

// prologue8 for 8 bf16 values of ONE channel: in the transposed
// (H, C, W, N) layout 8 contiguous elements are 8 samples of a channel, so
// they share one (a, b).
__device__ __forceinline__ uint4 prologue8_1ch(uint4 v, float a, float b) {
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(p[j]);
    p[j] = __floats2bfloat162_rn(fmaxf(__fadd_rn(__fmul_rn(f.x, a), b), 0.0f),
                                 fmaxf(__fadd_rn(__fmul_rn(f.y, a), b), 0.0f));
  }
  return v;
}

// out[r] = sum of row r of partials (one row of n values per block, launched
// with kRowsReduceThreads threads), each thread over a fixed strided subset,
// then a fixed tree: deterministic.
__global__ void __launch_bounds__(kRowsReduceThreads)
rows_reduce_kernel(const float* __restrict__ partials, int64_t n, float* __restrict__ out) {
  __shared__ float sh[kRowsReduceThreads];
  const float* p = partials + static_cast<int64_t>(blockIdx.x) * n;
  float acc = 0.0f;
  for (int64_t t = threadIdx.x; t < n; t += kRowsReduceThreads) acc += p[t];
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kRowsReduceThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = sh[0];
}

}  // namespace
