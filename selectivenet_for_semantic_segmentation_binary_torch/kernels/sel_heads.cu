// The 1x1 conv heads of a U-Net on their shared input, forward and
// backward, for Hopper (sm_90a): K11.
//
// K11 has no Pallas original: it stands where the JAX package leaves the
// heads' 1x1 convs to XLA (models/unet.py: Head :421-439, UNetB._heads and
// UNet._heads), as K10 stands where it runs an XLA int8 conv. It replaces,
// for the K output channels of all of a model's heads together (UNet_B
// selective: conv1x1, conv_select, conv_aux, K = 3), K separate fprops,
// dgrads with their autograd sum, filter gradients and bias reductions.
//
// For x (M pixels, Cin) NHWC in T (bf16 or float32), the weights W (K, Cin)
// and biases b (K) rounded to T, as autocast hands them to a conv:
//   forward:  y[p][k]  = T(sum_c x[p][c] W[k][c] + b[k])          (float32 sums)
//   backward: dx[p][c] = T(sum_k g[p][k] W[k][c])                 (float32 sums)
//             dW[k][c] = sum_p x[p][c] g[p][k],  db[k] = sum_p g[p][k]   (float32)
// from the float32 gradients g of the logits. y is written as float32 (the
// value rounded to T), each output channel k into its own array at
// out[k][p * stride[k]]: a head of k_j channels is one (M, k_j) array.
//
// Bound: device-memory bytes. 64 x K multiply-adds a 128-byte bf16 pixel
// row is far below the card's ~295 flop/byte ridge. At (128, 256, 256, 64)
// bf16 and K = 3: the forward reads x (1.07 GB) and writes 3 float32 planes
// (0.10 GB), 0.35 ms at 3.35 TB/s; the backward reads x and the 3 planes of
// g and writes dx (2.25 GB), 0.67 ms.
//
// Design: one streaming pass over x each way.
// - A pixel row is `lanes` 16-byte pieces (lanes = Cin * sizeof(T) / 16, a
//   power of two from 1 to 32); lane l of a warp takes piece l % lanes of
//   pixel l / lanes, so each load instruction of a warp reads 512
//   contiguous bytes, and a warp's kUnroll loads, issued before any is used,
//   cover 2 KB of consecutive pixels. The thread's channels of W (rounded to
//   T) and b sit in registers.
// - Forward: a lane's partial sums over its channels, summed over the
//   pixel's lanes by xor shuffles, the bias, one rounding to T; the pixel's
//   first lane stores the K logits.
// - Backward: each lane writes its 16 bytes of dx and accumulates x * g for
//   its channels (and g, for db) in float32 registers over its pixels. At
//   the end the lanes of one channel piece are summed by xor shuffles, the
//   warps in turn in shared memory, and the CTA's row of K x (Cin + 1)
//   partials is written; rows_reduce_kernel (common.cuh) sums the rows in a
//   fixed order. No atomics: two runs give the same bits.
// - A fixed grid (sel_heads_ctas: up to 1056 CTAs, 8 an SM, of at least
//   1024 pixels each), each CTA one contiguous range of pixels; the number
//   of CTAs depends on M alone, so the partial sums' order does too.
// - Templated on T and K (1..8): one algorithm, its parameters by shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxK = 8;
constexpr int kMaxCin = 256;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;             // 16-byte loads in flight a thread
constexpr int kMaxCtas = 1056;         // 8 per SM of the H100's 132
constexpr int64_t kMinPixelsPerCta = 1024;

// Per output channel k: its Cin weights and its bias (float32), and its
// array of logits (forward) or of their gradients (backward; null: zero).
struct Heads {
  const float* w[kMaxK];
  const float* b[kMaxK];
  float* t[kMaxK];
  int stride[kMaxK];
};

template <typename T>
struct Piece;

// 8 bf16 channels in 16 bytes
template <>
struct Piece<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static __forceinline__ void unpack(const uint4& v, float (&f)[kVec]) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 t = __bfloat1622float2(p[j]);
      f[2 * j] = t.x;
      f[2 * j + 1] = t.y;
    }
  }
  __device__ static __forceinline__ uint4 pack(const float (&f)[kVec]) {
    uint4 v;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    return v;
  }
  __device__ static __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// 4 float32 channels in 16 bytes
template <>
struct Piece<float> {
  static constexpr int kVec = 4;
  __device__ static __forceinline__ void unpack(const uint4& v, float (&f)[kVec]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static __forceinline__ uint4 pack(const float (&f)[kVec]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
  __device__ static __forceinline__ float round(float x) { return x; }
};

// Where a thread's loads lie: warp w of a CTA step takes the kUnroll * ppw
// consecutive pixels from step + w * kUnroll * ppw, load u the ppw pixels
// from there + u * ppw (ppw = 32 / lanes pixels a load instruction).
struct Layout {
  int lanes, piece, ppw, sub;
  int64_t per_step;
  __device__ Layout(int lanes_) : lanes(lanes_) {
    const int lane = threadIdx.x % 32;
    piece = lane & (lanes - 1);
    ppw = 32 / lanes;
    sub = (threadIdx.x / 32) * kUnroll * ppw + lane / lanes;
    per_step = static_cast<int64_t>(kWarps) * kUnroll * ppw;
  }
};

template <typename T, int K>
__device__ __forceinline__ void load_weights(const Heads& h, int c0,
                                             float (&w)[Piece<T>::kVec][K]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < Piece<T>::kVec; ++j) w[j][k] = Piece<T>::round(__ldg(h.w[k] + c0 + j));
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
sel_heads_fwd_kernel(const T* __restrict__ x, int64_t m, int lanes, int64_t per_cta, Heads h) {
  constexpr int V = Piece<T>::kVec;
  const Layout L(lanes);
  float w[V][K], bias[K];
  load_weights<T, K>(h, L.piece * V, w);
#pragma unroll
  for (int k = 0; k < K; ++k) bias[k] = Piece<T>::round(__ldg(h.b[k]));

  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * per_cta;
  const int64_t r1 = r0 + per_cta < m ? r0 + per_cta : m;
  const uint4* xs = reinterpret_cast<const uint4*>(x) + L.piece;
  // the bounds are the CTA's, so every lane of a warp runs every step's
  // shuffles; rows past r1 load zeros and store nothing
  for (int64_t step = r0; step < r1; step += L.per_step) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = step + L.sub + u * L.ppw;
      v[u] = row < r1 ? __ldcs(xs + row * lanes) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float f[V], s[K];
      Piece<T>::unpack(v[u], f);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        s[k] = f[0] * w[0][k];
#pragma unroll
        for (int j = 1; j < V; ++j) s[k] = fmaf(f[j], w[j][k], s[k]);
      }
      for (int off = lanes / 2; off > 0; off >>= 1)
#pragma unroll
        for (int k = 0; k < K; ++k) s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
      const int64_t row = step + L.sub + u * L.ppw;
      if (L.piece == 0 && row < r1) {
#pragma unroll
        for (int k = 0; k < K; ++k) h.t[k][row * h.stride[k]] = Piece<T>::round(s[k] + bias[k]);
      }
    }
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
sel_heads_bwd_kernel(const T* __restrict__ x, T* __restrict__ dx, int64_t m, int lanes,
                     int64_t per_cta, Heads h, float* __restrict__ partials, int n_ctas) {
  constexpr int V = Piece<T>::kVec;
  __shared__ float red[kMaxCin * kMaxK + kMaxK];
  const Layout L(lanes);
  const int cin = lanes * V;
  float w[V][K];
  load_weights<T, K>(h, L.piece * V, w);
  float acc[V][K], accb[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    accb[k] = 0.0f;
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j][k] = 0.0f;
  }

  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * per_cta;
  const int64_t r1 = r0 + per_cta < m ? r0 + per_cta : m;
  const uint4* xs = reinterpret_cast<const uint4*>(x) + L.piece;
  uint4* dxs = reinterpret_cast<uint4*>(dx) + L.piece;
  for (int64_t step = r0; step < r1; step += L.per_step) {
    uint4 v[kUnroll];
    float g[kUnroll][K];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = step + L.sub + u * L.ppw;
      const bool in = row < r1;
      v[u] = in ? __ldcs(xs + row * lanes) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int k = 0; k < K; ++k)
        g[u][k] = (in && h.t[k] != nullptr) ? __ldg(h.t[k] + row * h.stride[k]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = step + L.sub + u * L.ppw;
      float f[V], d[V];
      Piece<T>::unpack(v[u], f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        d[j] = g[u][0] * w[j][0];
#pragma unroll
        for (int k = 1; k < K; ++k) d[j] = fmaf(g[u][k], w[j][k], d[j]);
#pragma unroll
        for (int k = 0; k < K; ++k) acc[j][k] = fmaf(f[j], g[u][k], acc[j][k]);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) accb[k] += g[u][k];
      if (row < r1) dxs[row * lanes] = Piece<T>::pack(d);
    }
  }

  // the CTA's sums: over the lanes of one piece (xor shuffles), then over
  // the warps in turn, in this order every run
  for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      accb[k] += __shfl_xor_sync(0xffffffffu, accb[k], off);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j][k] += __shfl_xor_sync(0xffffffffu, acc[j][k], off);
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_vals = K * cin + K;
  for (int wp = 0; wp < kWarps; ++wp) {
    if (warp == wp && lane < lanes) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float& r = red[k * cin + lane * V + j];
          r = wp == 0 ? acc[j][k] : r + acc[j][k];
        }
        if (lane == 0) {
          float& r = red[K * cin + k];
          r = wp == 0 ? accb[k] : r + accb[k];
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n_vals; i += kThreads)
    partials[static_cast<int64_t>(i) * n_ctas + blockIdx.x] = red[i];
}

int ctas_for(int64_t m) {
  const int64_t want = (m + kMinPixelsPerCta - 1) / kMinPixelsPerCta;
  return static_cast<int>(want < 1 ? 1 : (want > kMaxCtas ? kMaxCtas : want));
}

// lanes a pixel for Cin channels of `bytes` bytes (2: bf16, 4: float32)
// and K outputs, or 0 where the kernels do not take them (K outside
// 1..kMaxK, Cin not a multiple of 8, a row that is not a power of two of
// 16-byte pieces or more than 32 of them): ops/sel_heads.py::kernel_takes
int lanes_for(int cin, int bytes, int k) {
  if (k < 1 || k > kMaxK || cin < 1 || cin > kMaxCin || cin % 8 || (cin * bytes) % 16) return 0;
  const int lanes = cin * bytes / 16;
  return (lanes & (lanes - 1)) == 0 && lanes <= 32 ? lanes : 0;
}

Heads heads_of(int k, const void* const* w, const void* const* b, void* const* t,
               const int* stride) {
  Heads h{};
  for (int i = 0; i < k; ++i) {
    h.w[i] = static_cast<const float*>(w[i]);
    h.b[i] = b ? static_cast<const float*>(b[i]) : nullptr;
    h.t[i] = static_cast<float*>(t[i]);
    h.stride[i] = stride[i];
  }
  return h;
}

template <typename T, int K>
void launch_fwd(const void* x, int64_t m, int lanes, int n_ctas, int64_t per_cta,
                const Heads& h, cudaStream_t s) {
  sel_heads_fwd_kernel<T, K><<<n_ctas, kThreads, 0, s>>>(static_cast<const T*>(x), m, lanes,
                                                         per_cta, h);
}

template <typename T, int K>
void launch_bwd(const void* x, void* dx, int64_t m, int lanes, int n_ctas, int64_t per_cta,
                const Heads& h, float* partials, cudaStream_t s) {
  sel_heads_bwd_kernel<T, K><<<n_ctas, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(dx), m, lanes, per_cta, h, partials, n_ctas);
}

// F<T, K>(args...) for the runtime K in 1..kMaxK
#define SEL_HEADS_DISPATCH(F, T, k, ...)   \
  switch (k) {                             \
    case 1: F<T, 1>(__VA_ARGS__); break;   \
    case 2: F<T, 2>(__VA_ARGS__); break;   \
    case 3: F<T, 3>(__VA_ARGS__); break;   \
    case 4: F<T, 4>(__VA_ARGS__); break;   \
    case 5: F<T, 5>(__VA_ARGS__); break;   \
    case 6: F<T, 6>(__VA_ARGS__); break;   \
    case 7: F<T, 7>(__VA_ARGS__); break;   \
    default: F<T, 8>(__VA_ARGS__); break;  \
  }

}  // namespace

extern "C" {

int sel_heads_max_k() { return kMaxK; }

// The CTAs of a backward over m pixels: the row length of its partials.
int sel_heads_ctas(int64_t m) { return ctas_for(m); }

// x: (m, cin) NHWC, bf16 (is_bf16 = 1) or float32, 16-byte aligned. w[k],
// b[k]: float32 pointers to output channel k's cin weights and its bias.
// out[k]: float32, logit k of pixel p at out[k][p * stride[k]]. Returns the
// cudaError_t of the launch.
int sel_heads_forward(const void* x, int is_bf16, int64_t m, int cin, int k,
                      const void* const* w, const void* const* b, void* const* out,
                      const int* stride, void* stream) {
  const int bytes = is_bf16 ? 2 : 4;
  const int lanes = lanes_for(cin, bytes, k);
  if (m < 1 || lanes == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_ctas = ctas_for(m);
  const int64_t per_cta = (m + n_ctas - 1) / n_ctas;
  const Heads h = heads_of(k, w, b, out, stride);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    SEL_HEADS_DISPATCH(launch_fwd, __nv_bfloat16, k, x, m, lanes, n_ctas, per_cta, h, s)
  } else {
    SEL_HEADS_DISPATCH(launch_fwd, float, k, x, m, lanes, n_ctas, per_cta, h, s)
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward: g[k] the float32 gradient of logit k (at g[k][p *
// stride[k]]; null: zero); dx: (m, cin) in x's dtype; partials: float32
// scratch of (k * cin + k) * sel_heads_ctas(m) values; dwb: float32 (k *
// cin + k): dW (k, cin), then db (k). Returns the cudaError_t of the
// launches.
int sel_heads_backward(const void* x, void* dx, int is_bf16, int64_t m, int cin, int k,
                       const void* const* w, void* const* g, const int* stride,
                       void* partials, void* dwb, void* stream) {
  const int bytes = is_bf16 ? 2 : 4;
  const int lanes = lanes_for(cin, bytes, k);
  if (m < 1 || lanes == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_ctas = ctas_for(m);
  const int64_t per_cta = (m + n_ctas - 1) / n_ctas;
  const Heads h = heads_of(k, w, nullptr, g, stride);
  float* part = static_cast<float*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    SEL_HEADS_DISPATCH(launch_bwd, __nv_bfloat16, k, x, dx, m, lanes, n_ctas, per_cta, h, part, s)
  } else {
    SEL_HEADS_DISPATCH(launch_bwd, float, k, x, dx, m, lanes, n_ctas, per_cta, h, part, s)
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rows_reduce_kernel<<<k * cin + k, kRowsReduceThreads, 0, s>>>(part, n_ctas,
                                                                static_cast<float*>(dwb));
  return static_cast<int>(cudaGetLastError());
}

const char* sel_heads_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
