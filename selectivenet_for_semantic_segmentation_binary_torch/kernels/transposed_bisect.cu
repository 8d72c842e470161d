// The Mosaic-bisection kernels of the transposed (H, C, W, N) CBR, for
// Hopper (sm_90a): crops, shifted sums and stacked dots over the N-minor
// rows, one launcher per script.
//
// Replaces the Pallas TPU kernels
//   scripts/bisect_transposed.py  v1 :29 (pallas_call :36), v2 :50 (:56),
//     v3 :69 (:79), v4 :95 (:105), v5 :117 (:125)        -> bisect_k7_launch
//   scripts/bisect_transposed2.py::make :15 (:22), bodies a-e :45-72
//                                                        -> bisect_k8_launch
//   scripts/bisect_transposed3.py::build :82 (:87), body _kernel :18-79
//                                                        -> bisect_k9_launch
//
// xp is the scripts' padded input as (Hs, C, Ws, N) bf16 (Hs = H + 2; Ws =
// W + 2, or W + 8 for K7 v5); every output is (H, Cout, W, N) bf16:
//   crop        out[h,c,w,n] = xp[h+1, c, w+1, n]                 K7 v1 v2 v5
//   shifted sum out[h,c,w,n] = sum over the (dy, dx) of the variant of
//               xp[h+dy, c, w+dx, n], in float32 (K7 v4: dy 1, dx 0..2;
//               K8 a: dy 0..2, dx 1), or rounded to bf16 after each add
//               (K8 b, whose body adds bf16 values)
//   dot         out[h,co,w,n] = sum over dx of (sum over dy, ci of
//               Wm[co, (dy - dy0) * C + ci] * src[h+dy, ci, w+dx, n]), float32
//               (K7 v3, K8 c e: dy 0..2, dx 1; K8 d: dy 1, dx 1; K9: dy 0..2
//               with merge_dot, else dy 1; dx 0..2 with shift, else dx 0)
// where src is xp, or for K9 with its scratch: bf16(relu(xp * 1.1 + 0.1))
// with the prologue, and row 0 and column 0 of the padded input zeroed with
// zero_ring (the TPU kernel zeroes the block's top row only in the first
// row block and its left column only in the first column block). K9's
// stats are the float32 sum of the rounded y over (h, w, n) per channel:
// per-CTA partials, then rows_reduce_kernel in a fixed order.
//
// Bound: every one of them moves bytes, not operations: a crop or a sum
// reads 1-3 rows per output and the dots do at most 2 * 9 * 64 FLOP per
// output element of 2 bytes. Simple kernels, by design: one thread per
// output element (sums) or per 8 output channels of one element (dots),
// neighbouring threads on neighbouring samples n, so a warp reads 64
// contiguous bytes of a row; the dots' weights are warp-uniform loads, the
// products float32 on the CUDA cores (K <= 192).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCoT = 8;  // output channels per thread of a dot

struct Geo {
  int hs, c, ws, n;  // input (Hs, C, Ws, N)
  int h, w;          // output rows and columns
};

template <bool kBf16Adds>
__global__ void __launch_bounds__(kThreads)
tsum_kernel(const __nv_bfloat16* __restrict__ x, Geo g, int dy0, int ndy, int dx0, int ndx,
            __nv_bfloat16* __restrict__ y) {
  const int64_t total = static_cast<int64_t>(g.h) * g.c * g.w * g.n;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int n = static_cast<int>(i % g.n);
    const int w = static_cast<int>((i / g.n) % g.w);
    const int c = static_cast<int>((i / (static_cast<int64_t>(g.n) * g.w)) % g.c);
    const int h = static_cast<int>(i / (static_cast<int64_t>(g.n) * g.w * g.c));
    float acc = 0.0f;
    bool first = true;
    for (int dy = dy0; dy < dy0 + ndy; ++dy) {
      for (int dx = dx0; dx < dx0 + ndx; ++dx) {
        const int64_t src = ((static_cast<int64_t>(h + dy) * g.c + c) * g.ws + w + dx) * g.n + n;
        const float v = __bfloat162float(x[src]);
        if (first) {
          acc = v;
          first = false;
        } else {
          acc = acc + v;
          if (kBf16Adds) acc = __bfloat162float(__float2bfloat16_rn(acc));
        }
      }
    }
    y[i] = __float2bfloat16_rn(acc);
  }
}

// One block: 256 consecutive (w, n) positions of one output row h, 8
// output channels (blockIdx.y). Stats: the block's sums of the rounded y per
// channel, summed over its threads in a fixed tree.
template <bool kPrologue, bool kZeroRing, bool kStats>
__global__ void __launch_bounds__(kThreads)
tdot_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wm,
            int wld, Geo g, int cout, int dy0, int ndy, int dx0, int ndx, int n_pblocks,
            __nv_bfloat16* __restrict__ y, float* __restrict__ partials) {
  __shared__ float red[kStats ? kCoT : 1][kThreads];
  const int h = blockIdx.x / n_pblocks;
  const int64_t p = static_cast<int64_t>(blockIdx.x % n_pblocks) * kThreads + threadIdx.x;
  const int co0 = blockIdx.y * kCoT;
  const bool valid = p < static_cast<int64_t>(g.w) * g.n;
  const int w = valid ? static_cast<int>(p / g.n) : 0;
  const int n = valid ? static_cast<int>(p % g.n) : 0;

  float acc[kCoT];
#pragma unroll
  for (int j = 0; j < kCoT; ++j) acc[j] = 0.0f;
  if (valid) {
    for (int dx = dx0; dx < dx0 + ndx; ++dx) {
      float t[kCoT];
#pragma unroll
      for (int j = 0; j < kCoT; ++j) t[j] = 0.0f;
      for (int dy = dy0; dy < dy0 + ndy; ++dy) {
        const int hs = h + dy;
        const int ws = w + dx;
        const bool zero = kZeroRing && (hs == 0 || ws == 0);
        const __nv_bfloat16* xr = x + (static_cast<int64_t>(hs) * g.c * g.ws + ws) * g.n + n;
        const __nv_bfloat16* wr = wm + static_cast<int64_t>(co0) * wld + (dy - dy0) * g.c;
        for (int ci = 0; ci < g.c; ++ci) {
          __nv_bfloat16 xv = xr[static_cast<int64_t>(ci) * g.ws * g.n];
          if (kPrologue) xv = prologue1(xv, 1.1f, 0.1f);
          const float v = zero ? 0.0f : __bfloat162float(xv);
#pragma unroll
          for (int j = 0; j < kCoT; ++j)
            t[j] += __bfloat162float(__ldg(wr + static_cast<int64_t>(j) * wld + ci)) * v;
        }
      }
#pragma unroll
      for (int j = 0; j < kCoT; ++j) acc[j] += t[j];
    }
  }
#pragma unroll
  for (int j = 0; j < kCoT; ++j) {
    const __nv_bfloat16 o = __float2bfloat16_rn(acc[j]);
    if (valid)
      y[((static_cast<int64_t>(h) * cout + co0 + j) * g.w + w) * g.n + n] = o;
    if (kStats) red[j][threadIdx.x] = valid ? __bfloat162float(o) : 0.0f;
  }
  if (kStats) {
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (threadIdx.x < s)
#pragma unroll
        for (int j = 0; j < kCoT; ++j) red[j][threadIdx.x] += red[j][threadIdx.x + s];
      __syncthreads();
    }
    if (threadIdx.x < kCoT)
      partials[static_cast<int64_t>(co0 + threadIdx.x) * gridDim.x + blockIdx.x] =
          red[threadIdx.x][0];
  }
}

int blocks_for(int64_t total) {
  const int64_t b = (total + kThreads - 1) / kThreads;
  return static_cast<int>(b < 65536 ? b : 65536);
}

int launch_sum(bool bf16_adds, const void* x, Geo g, int dy0, int ndy, int dx0, int ndx,
               void* y, cudaStream_t s) {
  const int blocks = blocks_for(static_cast<int64_t>(g.h) * g.c * g.w * g.n);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  if (bf16_adds)
    tsum_kernel<true><<<blocks, kThreads, 0, s>>>(xp, g, dy0, ndy, dx0, ndx, yp);
  else
    tsum_kernel<false><<<blocks, kThreads, 0, s>>>(xp, g, dy0, ndy, dx0, ndx, yp);
  return static_cast<int>(cudaGetLastError());
}

int pblocks(const Geo& g) {
  return static_cast<int>((static_cast<int64_t>(g.w) * g.n + kThreads - 1) / kThreads);
}

template <bool kPrologue, bool kZeroRing, bool kStats>
int launch_dot_t(const void* x, const void* w, int wld, Geo g, int dy0, int ndy, int dx0,
                 int ndx, void* y, void* partials, cudaStream_t s) {
  const dim3 grid(g.h * pblocks(g), g.c / kCoT);
  tdot_kernel<kPrologue, kZeroRing, kStats><<<grid, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), wld, g, g.c,
      dy0, ndy, dx0, ndx, pblocks(g), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(partials));
  return static_cast<int>(cudaGetLastError());
}

int launch_dot(bool prologue, bool zero_ring, bool stats, const void* x, const void* w, int wld,
               Geo g, int dy0, int ndy, int dx0, int ndx, void* y, void* partials,
               cudaStream_t s) {
#define SNET_DOT(P, Z, S) \
  if (prologue == P && zero_ring == Z && stats == S) \
    return launch_dot_t<P, Z, S>(x, w, wld, g, dy0, ndy, dx0, ndx, y, partials, s);
  SNET_DOT(false, false, false) SNET_DOT(false, false, true) SNET_DOT(false, true, false)
  SNET_DOT(false, true, true) SNET_DOT(true, false, false) SNET_DOT(true, false, true)
  SNET_DOT(true, true, false) SNET_DOT(true, true, true)
#undef SNET_DOT
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bad_geo(int hs, int c, int ws, int n, int margin) {
  return hs < 3 || ws <= margin || n < 1 || c < kCoT || c % kCoT != 0 ||
         static_cast<int64_t>(hs - 2) * pblocks(Geo{hs, c, ws, n, hs - 2, ws - margin}) >
             2147483647LL;
}

}  // namespace

extern "C" {

// K7. variant 1..5 (v1..v5); x (hs, c, ws, n) bf16 with ws = w + 2 (v5: w +
// 8); w (c, 3c) bf16, read by v3 only; y (hs - 2, c, w, n) bf16.
int bisect_k7_launch(int variant, const void* x, const void* w, int hs, int c, int ws, int n,
                     void* y, void* stream) {
  const int margin = variant == 5 ? 8 : 2;
  if (variant < 1 || variant > 5 || bad_geo(hs, c, ws, n, margin))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo g{hs, c, ws, n, hs - 2, ws - margin};
  switch (variant) {
    case 3:
      return launch_dot(false, false, false, x, w, 3 * c, g, 0, 3, 1, 1, y, nullptr, s);
    case 4:
      return launch_sum(false, x, g, 1, 1, 0, 3, y, s);
    default:  // v1, v2, v5: the crop
      return launch_sum(false, x, g, 1, 1, 1, 1, y, s);
  }
}

// K8. body 0..4 (a..e); x (hs, c, ws, n) bf16 with ws = w + 2; w (c, 3c)
// bf16, read by c, d and e; y (hs - 2, c, w, n) bf16.
int bisect_k8_launch(int body, const void* x, const void* w, int hs, int c, int ws, int n,
                     void* y, void* stream) {
  if (body < 0 || body > 4 || bad_geo(hs, c, ws, n, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo g{hs, c, ws, n, hs - 2, ws - 2};
  switch (body) {
    case 0:
      return launch_sum(false, x, g, 0, 3, 1, 1, y, s);
    case 1:
      return launch_sum(true, x, g, 0, 3, 1, 1, y, s);
    case 3:
      return launch_dot(false, false, false, x, w, 3 * c, g, 1, 1, 1, 1, y, nullptr, s);
    default:  // c, e: the stacked dot
      return launch_dot(false, false, false, x, w, 3 * c, g, 0, 3, 1, 1, y, nullptr, s);
  }
}

// The number of K9 partial sums per channel (blocks along the positions).
int64_t bisect_k9_partials(int hs, int c, int ws, int n) {
  return static_cast<int64_t>(hs - 2) * pblocks(Geo{hs, c, ws, n, hs - 2, ws - 2});
}

// K9. x (hs, c, ws, n) bf16 with ws = w + 2; w (3, c, 3c) bf16, of which
// w[0] is read; y (hs - 2, c, w, n) bf16. With stats: partials, float32
// scratch of c * bisect_k9_partials(...) values, and sums, float32 (c,): the
// sum of y per channel. The flags are bisect_transposed3.py's (prologue and
// zero_ring act only with scratch, as there). Returns the cudaError_t of the
// launches.
int bisect_k9_launch(int prologue, int zero_ring, int merge_dot, int shift, int stats,
                     int scratch, const void* x, const void* w, int hs, int c, int ws, int n,
                     void* y, void* partials, void* sums, void* stream) {
  if (bad_geo(hs, c, ws, n, 2)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo g{hs, c, ws, n, hs - 2, ws - 2};
  const int rc = launch_dot(scratch && prologue, scratch && zero_ring, stats != 0, x, w, 3 * c,
                            g, merge_dot ? 0 : 1, merge_dot ? 3 : 1, 0, shift ? 3 : 1, y,
                            partials, s);
  if (rc != 0 || !stats) return rc;
  rows_reduce_kernel<<<c, kRowsReduceThreads, 0, s>>>(
      static_cast<const float*>(partials), bisect_k9_partials(hs, c, ws, n),
      static_cast<float*>(sums));
  return static_cast<int>(cudaGetLastError());
}

const char* bisect_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
