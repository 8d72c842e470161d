// Fused binary eval metrics for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   selectivenet_for_semantic_segmentation_binary_tpu/ops/pallas_metrics.py
//   ::fused_eval_metrics (:102, pallas_call :140, body _metrics_kernel :44-95).
//
// One read of the output logits, the selection logits and the labels:
//   prob = sigmoid(x) (optional); pred = prob > cut_off
//   g    = sigmoid(s) (optional); sel  = g > s_cut_off
//   valid = 0 <= label < 2
//   counts: cm[label][pred] over valid & sel, reject over valid & !sel,
//           n_pix over valid.
//
// Bound: device-memory bytes (9 bytes read per pixel with uint8 labels, a
// handful of integer ops each): 75.5 MB, 22.5 us at 3.35 TB/s at the eval
// step's (128, 256, 256).
//
// Design: one streaming pass in one launch.
// - A thread step takes 8 pixels: 2 float4 of the output and 2 of the
//   selection, issued before any is used, and their labels (4 bytes, or one
//   16-byte int4 for int32 labels, per float4). A lane's float4 are 128
//   pixels apart, so that each load instruction of a warp reads 512
//   contiguous bytes. The grid is six CTAs an SM, all resident (the launch
//   bounds cap the registers at 42), and strides over the 256-pixel warp
//   steps. (16 pixels a lane step at four CTAs an SM, or 4 at eight, ran
//   1-3 us slower on an H100; a launch of one CTA, at n = 4096, takes 9 us
//   from event to event: most of what stands between this kernel and its
//   bound is that fixed cost, the rest streams at about torch.add's rate.)
// - The vector path needs all three pointers 16-byte aligned. Otherwise the
//   whole range, and always the tail of n past the last whole warp step,
//   goes through the element path of the same kernel
//   (eval_metrics_vector_path).
// - Integer counters in registers, a warp shuffle and a CTA sum into one row
//   of six int64 per CTA; the last CTA to finish (an atomic ticket on a
//   counter, which that CTA resets to 0) sums the rows and writes the six
//   int64 counts. No float accumulators and no float atomics: the counts are
//   exact and the same run to run, and no second launch sums the rows. The
//   counter must be 0 before the first launch (the caller allocates it
//   zeroed once) and launches that share one counter must run in order, on
//   one stream.
//
// Exactness against PyTorch: the plain version thresholds torch.sigmoid,
// which on CUDA computes 1 / (1 + expf(-x)) in float32 with the precise expf
// and an IEEE division. This file computes the same expression and must be
// built WITHOUT --use_fast_math, or pixels within an ulp of the cut-off flip.
// It computes it only for logits in a band of about 1e-4 around
// logit(cut_off) (band_of): outside it the comparison's answer is certain
// from x alone, by the sigmoid's error bound; the expf and the division
// for every pixel cost 2-7 us at the eval step's shape on an H100.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCounters = 6;  // cm00 cm01 cm10 cm11 reject valid
constexpr int kQ = 2;            // float4 of each array a lane takes a step
constexpr int kWarpStep = kQ * 128;  // pixels a warp step on the vector path
constexpr int kCtasPerSm = 6;  // resident at once (the launch bounds cap the registers)

__device__ __forceinline__ float sigmoid_like_torch(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// A threshold on the sigmoid: x above hi or below lo decides it without the
// sigmoid (band_of), the rest computes it exactly as torch does.
struct Cut {
  float cut, lo, hi;
};

template <bool kSigmoid>
__device__ __forceinline__ bool above(float x, const Cut& c) {
  if (!kSigmoid) return x > c.cut;
  if (x > c.hi) return true;
  if (x < c.lo) return false;
  return sigmoid_like_torch(x) > c.cut;  // the band, and NaN
}

struct Counts {
  int32_t v[kCounters];
};

template <bool kSigmoid, bool kSelective>
__device__ __forceinline__ void count(Counts& c, float p, float g, int lab, const Cut& cut,
                                      const Cut& s_cut) {
  const bool valid = lab >= 0 && lab < 2;
  const bool pred = above<kSigmoid>(p, cut);
  bool counted = valid;
  if (kSelective) {
    const bool sel = above<kSigmoid>(g, s_cut);
    counted = valid && sel;
    c.v[4] += (valid && !sel) ? 1 : 0;
  }
  const bool pos = lab == 1;
  c.v[0] += (counted && !pos && !pred) ? 1 : 0;
  c.v[1] += (counted && !pos && pred) ? 1 : 0;
  c.v[2] += (counted && pos && !pred) ? 1 : 0;
  c.v[3] += (counted && pos && pred) ? 1 : 0;
  c.v[5] += valid ? 1 : 0;
}

// The four labels of pixels i .. i + 3, as ints.
__device__ __forceinline__ void load_labels4(const uint8_t* __restrict__ label, int64_t i,
                                             int (&lab)[4]) {
  const uint32_t w = __ldcs(reinterpret_cast<const unsigned int*>(label + i));
#pragma unroll
  for (int k = 0; k < 4; ++k) lab[k] = static_cast<int>((w >> (8 * k)) & 0xFFu);
}
__device__ __forceinline__ void load_labels4(const int32_t* __restrict__ label, int64_t i,
                                             int (&lab)[4]) {
  const int4 v = __ldcs(reinterpret_cast<const int4*>(label + i));
  lab[0] = v.x;
  lab[1] = v.y;
  lab[2] = v.z;
  lab[3] = v.w;
}

template <bool kSigmoid, bool kSelective, typename Label>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
eval_metrics_kernel(const float* __restrict__ output, const float* __restrict__ selection,
                    const Label* __restrict__ label, int64_t n, int vec, Cut cut_off,
                    Cut s_cut_off, long long* __restrict__ partials,
                    unsigned int* __restrict__ ticket, long long* __restrict__ out) {
  Counts c = {{0, 0, 0, 0, 0, 0}};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the vector path: a warp step is kWarpStep pixels, four float4 of each
  // map a lane (pixels q * 128 + 4 lane .. + 3, so that each load instruction
  // of the warp reads 512 contiguous bytes) and their labels
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t n_steps = vec ? n / kWarpStep : 0;
  for (int64_t st = static_cast<int64_t>(blockIdx.x) * kWarps + warp; st < n_steps; st += warps) {
    const int64_t i0 = st * kWarpStep + 4 * lane;
    float4 o[kQ], s[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      o[q] = __ldcs(reinterpret_cast<const float4*>(output + i0 + q * 128));
    if (kSelective) {
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        s[q] = __ldcs(reinterpret_cast<const float4*>(selection + i0 + q * 128));
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      int lab[4];
      load_labels4(label, i0 + q * 128, lab);
      const float op[4] = {o[q].x, o[q].y, o[q].z, o[q].w};
      float sp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (kSelective) {
        sp[0] = s[q].x;
        sp[1] = s[q].y;
        sp[2] = s[q].z;
        sp[3] = s[q].w;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        count<kSigmoid, kSelective>(c, op[k], sp[k], lab[k], cut_off, s_cut_off);
    }
  }
  // the element path: the rest
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = n_steps * kWarpStep + static_cast<int64_t>(blockIdx.x) * kThreads +
                   threadIdx.x;
       i < n; i += stride)
    count<kSigmoid, kSelective>(c, output[i], kSelective ? selection[i] : 0.0f,
                                static_cast<int>(label[i]), cut_off, s_cut_off);

  // this CTA's row: a warp shuffle, then the warps in order
  __shared__ int32_t warp_sums[kWarps][kCounters];
  __shared__ bool last;
#pragma unroll
  for (int k = 0; k < kCounters; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c.v[k] += __shfl_down_sync(0xffffffffu, c.v[k], off);
    if (lane == 0) warp_sums[warp][k] = c.v[k];
  }
  __syncthreads();
  if (threadIdx.x < kCounters) {
    long long t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += warp_sums[w][threadIdx.x];
    partials[static_cast<int64_t>(blockIdx.x) * kCounters + threadIdx.x] = t;
    __threadfence();  // the row before the ticket
  }
  // the last CTA to take a ticket sums every row
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  __shared__ long long sums[kWarps][kCounters];
  long long t[kCounters] = {0, 0, 0, 0, 0, 0};
  for (int r = threadIdx.x; r < static_cast<int>(gridDim.x); r += kThreads)
#pragma unroll
    for (int k = 0; k < kCounters; ++k)
      t[k] += __ldcg(partials + static_cast<int64_t>(r) * kCounters + k);
#pragma unroll
  for (int k = 0; k < kCounters; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t[k] += __shfl_down_sync(0xffffffffu, t[k], off);
    if (lane == 0) sums[warp][k] = t[k];
  }
  __syncthreads();
  if (threadIdx.x < kCounters) {
    long long total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += sums[w][threadIdx.x];
    out[threadIdx.x] = total;
  }
  if (threadIdx.x == 0) *ticket = 0u;  // ready for the next launch
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The logits x > hi whose computed sigmoid is surely above cut, and x < lo
// surely below: 1 / (1 + expf(-x)) in float32 (expf within 2 ulp, the add
// and the division correctly rounded) is within 1e-6 of the true sigmoid,
// relative, and the band [lo, hi] is checked in double to put the true
// sigmoid 1e-5 away from cut, relative, at its ends. Outside (0, 1), or
// where that check fails, the band is everything: every x computes it.
Cut band_of(float cut) {
  Cut c{cut, -INFINITY, INFINITY};
  const double p = cut;
  if (!(p > 0.0 && p < 1.0)) return c;
  const double xc = log(p / (1.0 - p));
  const double d = 4e-5 / (1.0 - p);
  const double s_hi = 1.0 / (1.0 + exp(-(xc + d))), s_lo = 1.0 / (1.0 + exp(-(xc - d)));
  if (!(s_hi >= p * (1.0 + 1e-5) && s_lo <= p * (1.0 - 1e-5))) return c;
  c.hi = nextafterf(static_cast<float>(xc + d), INFINITY);
  c.lo = nextafterf(static_cast<float>(xc - d), -INFINITY);
  return c;
}

// The CTAs of a launch over n pixels: a few an SM, fewer where n is small.
int grid_for(int64_t n) {
  const int64_t cap = static_cast<int64_t>(sm_count()) * kCtasPerSm;
  int64_t want = (n + static_cast<int64_t>(kWarps) * kWarpStep - 1) / (kWarps * kWarpStep);
  if (want < 1) want = 1;
  return static_cast<int>(want < cap ? want : cap);
}

template <typename Label>
int launch_typed(const float* output, const float* selection, const void* label, int64_t n,
                 int vec, int apply_sigmoid, int selective, Cut cut_off, Cut s_cut_off, int grid, long long* partials, unsigned int* ticket, long long* out,
                 cudaStream_t stream) {
  const Label* lab = static_cast<const Label*>(label);
#define SNET_EVAL_METRICS(SIG, SEL)                                                      \
  eval_metrics_kernel<SIG, SEL, Label><<<grid, kThreads, 0, stream>>>(                   \
      output, selection, lab, n, vec, cut_off, s_cut_off, partials, ticket, out)
  if (apply_sigmoid && selective)
    SNET_EVAL_METRICS(true, true);
  else if (apply_sigmoid)
    SNET_EVAL_METRICS(true, false);
  else if (selective)
    SNET_EVAL_METRICS(false, true);
  else
    SNET_EVAL_METRICS(false, false);
#undef SNET_EVAL_METRICS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int eval_metrics_counters() { return kCounters; }

// The CTAs of a launch over n pixels: the rows of its partials scratch.
int eval_metrics_grid(int64_t n) { return grid_for(n); }

// Whether a launch on these pointers takes the 16-byte path (1) for the
// whole groups of 16 pixels, or the element path (0) for every pixel.
// selection may be null (not selective).
int eval_metrics_vector_path(const void* output, const void* selection, const void* label) {
  return aligned16(output) && (selection == nullptr || aligned16(selection)) && aligned16(label);
}

// label_bytes: 1 for uint8 labels, 4 for int32 labels. partials: int64
// scratch of eval_metrics_grid(n) * eval_metrics_counters() values; ticket:
// one uint32, 0 before the first launch and left at 0 by each (launches that
// share it must be ordered, on one stream); out: the six int64 counts (cm00
// cm01 cm10 cm11 reject valid). selection may be null when not selective.
// Returns the cudaError_t of the launch (0 on success).
int eval_metrics_launch(const void* output, const void* selection, const void* label,
                        int label_bytes, int64_t n, int apply_sigmoid, int selective,
                        float cut_off, float s_cut_off, void* partials, void* ticket,
                        void* out, void* stream) {
  if (n < 0 || (selective && selection == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const float* o = static_cast<const float*>(output);
  const float* s = selective ? static_cast<const float*>(selection) : o;
  const int vec = eval_metrics_vector_path(output, selective ? selection : nullptr, label);
  const int grid = grid_for(n);
  auto* part = static_cast<long long*>(partials);
  auto* tk = static_cast<unsigned int*>(ticket);
  auto* res = static_cast<long long*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Cut c = band_of(cut_off), sc = band_of(s_cut_off);
  if (label_bytes == 1)
    return launch_typed<uint8_t>(o, s, label, n, vec, apply_sigmoid, selective, c, sc, grid,
                                 part, tk, res, st);
  if (label_bytes == 4)
    return launch_typed<int32_t>(o, s, label, n, vec, apply_sigmoid, selective, c, sc, grid,
                                 part, tk, res, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* eval_metrics_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
