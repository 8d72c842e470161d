// Per-channel BatchNorm statistics [sum(x), sum(x * x)] of a bf16 NHWC
// activation with 64 channels, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   scripts/proto_bn_stats.py::pallas_bn_stats (:47-61, pallas_call :52,
//   body _stats_kernel :32-43).
//
// For x (N, H, W, 64) bf16, viewed as M = N*H*W rows of 64 channels:
//   stats[0][c] = sum_m x[m][c],  stats[1][c] = sum_m x[m][c]^2   (float32)
//
// Bound: 2 flops per byte read, far below the H100's ~295 flop/byte ridge,
// so HBM bandwidth (3.35 TB/s) bounds it. The design keeps as many 16-byte
// loads in flight as the card holds: each thread reads 8 channels (one
// uint4) of a row, 8 threads cover a row's 128 bytes, a CTA reads 32 rows a
// step and four steps' loads are in flight before any is summed. Each CTA owns
// one contiguous range of rows; its float32 per-thread sums are folded in a
// fixed order into one row of per-CTA partials, and a second kernel sums the
// rows in a fixed order. No float atomics: the result is the same run to
// run. The TPU kernel's lane packing ((M/2, 128) rows, lanes 64-127 folded
// onto 0-63) serves the TPU's 128-lane vregs and has no counterpart here;
// and where its grid of M/2 // 1024 steps drops the tail rows, every row is
// summed here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kC = 64;                // channels
constexpr int kVec = 8;               // channels per 16-byte load
constexpr int kGroups = kC / kVec;    // threads per row
constexpr int kThreads = 256;
constexpr int kRowsPerStep = kThreads / kGroups;  // 32
constexpr int kUnroll = 4;            // loads in flight per thread
constexpr int kMaxCtas = 1056;        // 8 per SM of the H100's 132
constexpr int64_t kMinRowsPerCta = 1024;

__global__ void __launch_bounds__(kThreads)
bn_stats_kernel(const __nv_bfloat16* __restrict__ x, int64_t M, int64_t rows_per_cta,
                int n_ctas, float* __restrict__ partials) {
  __shared__ float red[2][kRowsPerStep][kC];
  const int tid = threadIdx.x;
  const int group = tid % kGroups;
  const int lane_row = tid / kGroups;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_cta;
  const int64_t r1 = r0 + rows_per_cta < M ? r0 + rows_per_cta : M;

  float s[kVec], q[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) s[j] = q[j] = 0.0f;

  const uint4* base = reinterpret_cast<const uint4*>(x) + group;
  for (int64_t r = r0 + lane_row; r < r1; r += kUnroll * kRowsPerStep) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = r + u * kRowsPerStep;
      v[u] = row < r1 ? __ldcs(base + row * kGroups) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v[u]);
#pragma unroll
      for (int j = 0; j < kVec / 2; ++j) {
        const float2 f = __bfloat1622float2(p[j]);
        s[2 * j] += f.x;
        s[2 * j + 1] += f.y;
        q[2 * j] = fmaf(f.x, f.x, q[2 * j]);
        q[2 * j + 1] = fmaf(f.y, f.y, q[2 * j + 1]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    red[0][lane_row][group * kVec + j] = s[j];
    red[1][lane_row][group * kVec + j] = q[j];
  }
  __syncthreads();
  // one thread per (statistic, channel) sums the 32 row lanes in order
  if (tid < 2 * kC) {
    const int st = tid / kC;
    const int c = tid % kC;
    float t = 0.0f;
    for (int l = 0; l < kRowsPerStep; ++l) t += red[st][l][c];
    partials[static_cast<int64_t>(st * kC + c) * n_ctas + blockIdx.x] = t;
  }
}

int ctas_for(int64_t m) {
  const int64_t want = (m + kMinRowsPerCta - 1) / kMinRowsPerCta;
  return static_cast<int>(want < 1 ? 1 : (want > kMaxCtas ? kMaxCtas : want));
}

}  // namespace

extern "C" {

int bn_stats_channels() { return kC; }

// The number of CTAs (rows of the partials scratch) for m rows.
int bn_stats_ctas(int64_t m) { return ctas_for(m); }

// x: bf16 (m, 64), 16-byte aligned. partials: float32 scratch of
// 2 * 64 * bn_stats_ctas(m) values. stats: float32 (2, 64). Returns the
// cudaError_t of the launches.
int bn_stats_launch(const void* x, int64_t m, void* partials, void* stats, void* stream) {
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n_ctas = ctas_for(m);
  const int64_t rows_per_cta = (m + n_ctas - 1) / n_ctas;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bn_stats_kernel<<<n_ctas, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x), m,
                                              rows_per_cta, n_ctas,
                                              static_cast<float*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rows_reduce_kernel<<<2 * kC, kRowsReduceThreads, 0, s>>>(
      static_cast<const float*>(partials), n_ctas, static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}

const char* bn_stats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
