// Fused binary eval metrics for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   selectivenet_for_semantic_segmentation_binary_tpu/ops/pallas_metrics.py
//   ::fused_eval_metrics (body _metrics_kernel, :44-95).
//
// One read of the output logits, the selection logits and the labels:
//   prob = sigmoid(x) (optional); pred = prob > cut_off
//   g    = sigmoid(s) (optional); sel  = g > s_cut_off
//   valid = 0 <= label < 2
//   counts: cm[label][pred] over valid & sel, reject over valid & !sel,
//           n_pix over valid.
//
// Bound: device-memory bytes (9 bytes read per pixel with uint8 labels, a
// handful of integer ops each), so the design is one coalesced streaming pass
// with integer counters in registers and one row of six int32 partials per
// block; the caller sums the rows in int64. No float accumulators and no
// atomics, so the counts are exact and run-to-run identical.
//
// Exactness against PyTorch: the plain version thresholds torch.sigmoid,
// which on CUDA computes 1 / (1 + expf(-x)) in float32 with the precise expf
// and an IEEE division. This file computes the same expression and must be
// built WITHOUT --use_fast_math, or pixels within an ulp of the cut-off flip.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCounters = 6;  // cm00 cm01 cm10 cm11 reject valid

__device__ __forceinline__ float sigmoid_like_torch(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <bool kSigmoid, bool kSelective, typename Label>
__global__ void __launch_bounds__(kThreads)
eval_metrics_kernel(const float* __restrict__ output,
                    const float* __restrict__ selection,
                    const Label* __restrict__ label,
                    int64_t n, float cut_off, float s_cut_off,
                    int64_t per_block, int32_t* __restrict__ partials) {
  // Each block owns the contiguous range [begin, end), read by consecutive
  // threads at consecutive addresses. The wrapper keeps per_block far below
  // 2^31, so no int32 counter below can overflow.
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t end = (begin + per_block < n) ? begin + per_block : n;

  int32_t c00 = 0, c01 = 0, c10 = 0, c11 = 0, rej = 0, nval = 0;
  for (int64_t i = begin + threadIdx.x; i < end; i += kThreads) {
    const int lab = static_cast<int>(label[i]);
    const bool valid = lab >= 0 && lab < 2;
    float p = output[i];
    if (kSigmoid) p = sigmoid_like_torch(p);
    const bool pred = p > cut_off;
    bool counted = valid;
    if (kSelective) {
      float g = selection[i];
      if (kSigmoid) g = sigmoid_like_torch(g);
      const bool sel = g > s_cut_off;
      counted = valid && sel;
      rej += (valid && !sel) ? 1 : 0;
    }
    const bool pos = lab == 1;
    c00 += (counted && !pos && !pred) ? 1 : 0;
    c01 += (counted && !pos && pred) ? 1 : 0;
    c10 += (counted && pos && !pred) ? 1 : 0;
    c11 += (counted && pos && pred) ? 1 : 0;
    nval += valid ? 1 : 0;
  }

  int32_t v[kCounters] = {c00, c01, c10, c11, rej, nval};
#pragma unroll
  for (int k = 0; k < kCounters; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
    }
  }

  __shared__ int32_t warp_sums[kWarps][kCounters];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kCounters; ++k) warp_sums[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < kCounters) {
    int32_t s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w][threadIdx.x];
    partials[static_cast<int64_t>(blockIdx.x) * kCounters + threadIdx.x] = s;
  }
}

template <typename Label>
void launch_typed(const float* output, const float* selection,
                  const void* label, int64_t n, int apply_sigmoid,
                  int selective, float cut_off, float s_cut_off,
                  int64_t per_block, int blocks, int32_t* partials,
                  cudaStream_t stream) {
  const Label* lab = static_cast<const Label*>(label);
  if (apply_sigmoid && selective) {
    eval_metrics_kernel<true, true, Label><<<blocks, kThreads, 0, stream>>>(
        output, selection, lab, n, cut_off, s_cut_off, per_block, partials);
  } else if (apply_sigmoid) {
    eval_metrics_kernel<true, false, Label><<<blocks, kThreads, 0, stream>>>(
        output, selection, lab, n, cut_off, s_cut_off, per_block, partials);
  } else if (selective) {
    eval_metrics_kernel<false, true, Label><<<blocks, kThreads, 0, stream>>>(
        output, selection, lab, n, cut_off, s_cut_off, per_block, partials);
  } else {
    eval_metrics_kernel<false, false, Label><<<blocks, kThreads, 0, stream>>>(
        output, selection, lab, n, cut_off, s_cut_off, per_block, partials);
  }
}

}  // namespace

extern "C" {

int eval_metrics_counters() { return kCounters; }

// label_bytes: 1 for uint8 labels, 4 for int32 labels.
// partials: int32 buffer of blocks * eval_metrics_counters() entries.
// Returns the cudaError_t of the launch (0 on success).
int eval_metrics_launch(const void* output, const void* selection,
                        const void* label, int label_bytes, int64_t n,
                        int apply_sigmoid, int selective, float cut_off,
                        float s_cut_off, int64_t per_block, int blocks,
                        void* partials, void* stream) {
  if (blocks < 1 || per_block < 1 || n < 0 ||
      static_cast<int64_t>(blocks) * per_block < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* out = static_cast<const float*>(output);
  const float* sel = static_cast<const float*>(selection);
  int32_t* part = static_cast<int32_t*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (label_bytes == 1) {
    launch_typed<uint8_t>(out, sel, label, n, apply_sigmoid, selective,
                          cut_off, s_cut_off, per_block, blocks, part, s);
  } else if (label_bytes == 4) {
    launch_typed<int32_t>(out, sel, label, n, apply_sigmoid, selective,
                          cut_off, s_cut_off, per_block, blocks, part, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* eval_metrics_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
