// conv3x3 SAME filter gradient (dW) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   scripts/proto_pallas_dw.py::dw_pallas (:137-166, pallas_call :148,
//   body _dw_kernel :54-133, both its "taps9" and "x3g3" variants).
//
// For x [H, W, N, Ci] and g [H, W, N, Co] (the batch inside, as in the TPU
// kernel), both bf16 or both float32:
//   dW[ky, kx, ci, co] = sum_{h, w, n} x[h + ky - 1, w + kx - 1, n, ci] * g[h, w, n, co]
// with x zero outside [0, H) x [0, W) (SAME padding), out float32
// [3, 3, Ci, Co]. The edge is masked in the kernel: a pixel whose shifted x
// falls outside the image loads zeros, so no padded copy is made.
//
// Formulation: nine GEMMs that share their operands, one per tap (ky, kx):
// dW_tap[ci, co] = sum_p x_tap[p, ci] * g[p, co] over the K = H*W*N pixels
// p = (h, w, n), where x_tap is x shifted by the tap: row p of x_tap is row
// p + ((ky - 1) * W + kx - 1) * N of x, or zero at the edge. Both operands
// are read K-major, straight from their [H, W, N, C] layout.
//
// Bound: K is huge (8.4 M pixels at 256x256, batch 128) and the output small
// (at most 9 x 512 x 512), 2 * 9 * Ci * Co flops per 2 * (Ci + Co) bytes of x
// and g: compute-bound at every shape of the model. The design tiles both
// the output and K across CTAs: a CTA owns one 64(ci) x 64(co) tile of one
// tap and one contiguous range ("split") of K, and writes its float32 tile
// into a per-split slice of a partials buffer; a second kernel sums the
// splits in a fixed order. No float atomics: dW is the same run to run. The
// number of splits is chosen from the shape so that there are about
// kTargetCtas CTAs and the partials stay under kMaxPartialFloats. Block
// indices put the tiles of one split next to each other, so the nine taps
// and the channel tiles that read the same pixels run together and share
// them through L2.
//
// bf16: 4 warps, each a 32 x 32 quarter of the tile on the tensor cores
// (nvcuda::wmma bf16 16x16x16, float32 accumulators), 64 pixels a K step,
// the next step's 16-byte loads in registers while the current one is
// multiplied, a double-buffered shared-memory tile. float32 operands stay
// float32: a CUDA-core kernel (4 x 4 outputs a thread, fmaf), since the
// tensor cores would round them to TF32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kTile = 64;             // ci and co of a CTA's output tile
constexpr int kTargetCtas = 1056;     // 8 per SM of the H100's 132
constexpr int64_t kMaxPartialFloats = int64_t{16} << 20;  // 64 MiB of partials
constexpr int kReduceThreads = 256;

// bf16 kernel
constexpr int kThreads16 = 128;       // 4 warps: 2 along ci x 2 along co
constexpr int kBP = 64;               // pixels per K step
constexpr int kLd = kTile + 8;        // shared-memory pitch (bf16)
constexpr int kStage = kBP * kLd;
constexpr int kLoads16 = kBP * (kTile / 8) / kThreads16;  // uint4 per operand a thread

// float32 kernel
constexpr int kThreads32 = 256;       // 16 x 16 threads, 4 x 4 outputs each
constexpr int kFP = 16;               // pixels per K step

struct Split {
  int64_t pix_per_split;
  int splits;
};

Split split_for(int64_t k, int ci, int co, int pix_step) {
  const int n_tiles = 9 * (ci / kTile) * (co / kTile);
  const int64_t steps = (k + pix_step - 1) / pix_step;
  int64_t want = (kTargetCtas + n_tiles - 1) / n_tiles;
  const int64_t cap = kMaxPartialFloats / (int64_t{9} * ci * co);
  if (want > cap) want = cap;
  if (want > steps) want = steps;
  if (want < 1) want = 1;
  const int64_t steps_per_split = (steps + want - 1) / want;
  Split s;
  s.pix_per_split = steps_per_split * pix_step;
  s.splits = static_cast<int>((steps + steps_per_split - 1) / steps_per_split);
  return s;
}

// The CTA's tile and K range, from blockIdx.x (tiles of one split adjacent).
struct Work {
  int tap, ci0, co0, split;
  int64_t p_begin, p_end, shift;
  int dy, dx;
};

__device__ __forceinline__ Work work_for(int W, int N, int Ci, int Co, int64_t K,
                                         int64_t pix_per_split) {
  const int n_ci = Ci / kTile;
  const int n_co = Co / kTile;
  const int n_tiles = 9 * n_ci * n_co;
  const int tile = static_cast<int>(blockIdx.x % n_tiles);
  Work wk;
  wk.split = static_cast<int>(blockIdx.x / n_tiles);
  wk.co0 = (tile % n_co) * kTile;
  wk.ci0 = ((tile / n_co) % n_ci) * kTile;
  wk.tap = tile / (n_co * n_ci);
  wk.dy = wk.tap / 3 - 1;
  wk.dx = wk.tap % 3 - 1;
  wk.p_begin = wk.split * pix_per_split;
  wk.p_end = wk.p_begin + pix_per_split < K ? wk.p_begin + pix_per_split : K;
  wk.shift = (static_cast<int64_t>(wk.dy) * W + wk.dx) * N;
  return wk;
}

// Whether pixel p = (h, w, n) of g has its tap-shifted x inside the image.
__device__ __forceinline__ bool x_inside(int64_t p, int H, int W, int N, int dy, int dx) {
  const int64_t hw = p / N;
  const int h = static_cast<int>(hw / W);
  const int w = static_cast<int>(hw - static_cast<int64_t>(h) * W);
  return h + dy >= 0 && h + dy < H && w + dx >= 0 && w + dx < W;
}

__global__ void __launch_bounds__(kThreads16)
conv_dw_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                    int H, int W, int N, int Ci, int Co, int64_t K, int64_t pix_per_split,
                    float* __restrict__ partials) {
  __shared__ __align__(128) __nv_bfloat16 As[2][kStage];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][kStage];
  const int tid = threadIdx.x;
  const Work wk = work_for(W, N, Ci, Co, K, pix_per_split);

  // this thread loads 8 channels (l_cv) of pixel rows l_row + 16 i, of both
  // operands, at every K step
  const int l_row = tid >> 3;
  const int l_cv = tid & 7;
  uint4 a_reg[kLoads16], b_reg[kLoads16];

  auto load = [&](int64_t p0) {
#pragma unroll
    for (int i = 0; i < kLoads16; ++i) {
      const int64_t p = p0 + l_row + i * (kThreads16 / 8);
      uint4 av = make_uint4(0u, 0u, 0u, 0u);
      uint4 bv = make_uint4(0u, 0u, 0u, 0u);
      if (p < wk.p_end) {
        bv = __ldg(reinterpret_cast<const uint4*>(g + p * Co + wk.co0 + l_cv * 8));
        if (x_inside(p, H, W, N, wk.dy, wk.dx)) {
          av = __ldg(reinterpret_cast<const uint4*>(x + (p + wk.shift) * Ci + wk.ci0 + l_cv * 8));
        }
      }
      a_reg[i] = av;
      b_reg[i] = bv;
    }
  };
  auto store = [&](int stage) {
#pragma unroll
    for (int i = 0; i < kLoads16; ++i) {
      const int row = l_row + i * (kThreads16 / 8);
      *reinterpret_cast<uint4*>(&As[stage][row * kLd + l_cv * 8]) = a_reg[i];
      *reinterpret_cast<uint4*>(&Bs[stage][row * kLd + l_cv * 8]) = b_reg[i];
    }
  };

  const int warp = tid >> 5;
  const int wm = warp & 1;   // ci rows wm * 32 .. + 32
  const int wn = warp >> 1;  // co columns wn * 32 .. + 32
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int64_t n_steps = (wk.p_end - wk.p_begin + kBP - 1) / kBP;
  if (n_steps > 0) {
    load(wk.p_begin);
    store(0);
  }
  __syncthreads();
  for (int64_t s = 0; s < n_steps; ++s) {
    const int stage = static_cast<int>(s & 1);
    if (s + 1 < n_steps) load(wk.p_begin + (s + 1) * kBP);
#pragma unroll
    for (int kk = 0; kk < kBP; kk += 16) {
      // A = x_tap^T: the [pixel][ci] tile read column-major is [ci][pixel]
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[stage][kk * kLd + wm * 32 + i * 16], kLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[stage][kk * kLd + wn * 32 + j * 16], kLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    // the other stage was last read in step s - 1, which every warp has
    // left (the barrier below ends each step)
    if (s + 1 < n_steps) store(stage ^ 1);
    __syncthreads();
  }

  float* out = partials + ((static_cast<int64_t>(wk.split) * 9 + wk.tap) * Ci + wk.ci0) * Co + wk.co0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(out + static_cast<int64_t>(wm * 32 + i * 16) * Co + wn * 32 + j * 16,
                              acc[i][j], Co, wmma::mem_row_major);
}

__global__ void __launch_bounds__(kThreads32)
conv_dw_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                   int H, int W, int N, int Ci, int Co, int64_t K, int64_t pix_per_split,
                   float* __restrict__ partials) {
  __shared__ __align__(16) float As[kFP][kTile];
  __shared__ __align__(16) float Bs[kFP][kTile];
  const int tid = threadIdx.x;
  const Work wk = work_for(W, N, Ci, Co, K, pix_per_split);
  const int l_row = tid / (kTile / 4);  // pixel of the step this thread loads
  const int l_c4 = tid % (kTile / 4);   // its 4 channels
  const int ty = tid / 16;              // outputs: ci ty*4 .. + 4
  const int tx = tid % 16;              //          co tx*4 .. + 4
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int64_t p0 = wk.p_begin; p0 < wk.p_end; p0 += kFP) {
    const int64_t p = p0 + l_row;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < wk.p_end) {
      bv = __ldg(reinterpret_cast<const float4*>(g + p * Co + wk.co0 + l_c4 * 4));
      if (x_inside(p, H, W, N, wk.dy, wk.dx)) {
        av = __ldg(reinterpret_cast<const float4*>(x + (p + wk.shift) * Ci + wk.ci0 + l_c4 * 4));
      }
    }
    *reinterpret_cast<float4*>(&As[l_row][l_c4 * 4]) = av;
    *reinterpret_cast<float4*>(&Bs[l_row][l_c4 * 4]) = bv;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFP; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float ar[4] = {a4.x, a4.y, a4.z, a4.w};
      const float br[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = partials + ((static_cast<int64_t>(wk.split) * 9 + wk.tap) * Ci + wk.ci0 + ty * 4) * Co
               + wk.co0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(out + static_cast<int64_t>(i) * Co) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// dw[e] = sum over the splits of partials[s][e], in split order.
__global__ void __launch_bounds__(kReduceThreads)
splits_reduce_kernel(const float* __restrict__ partials, int splits, int64_t n,
                     float* __restrict__ dw) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (e >= n) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += partials[static_cast<int64_t>(s) * n + e];
  dw[e] = acc;
}

int pix_step(int is_bf16) { return is_bf16 ? kBP : kFP; }

}  // namespace

extern "C" {

int conv_dw_tile() { return kTile; }

// The number of K splits (slices of the partials scratch, each 9 * ci * co
// floats) the kernel uses for this shape.
int conv_dw_splits(int h, int w, int n, int ci, int co, int is_bf16) {
  return split_for(static_cast<int64_t>(h) * w * n, ci, co, pix_step(is_bf16)).splits;
}

// x [h, w, n, ci], g [h, w, n, co], both bf16 (is_bf16) or both float32,
// contiguous and 16-byte aligned; ci, co multiples of conv_dw_tile().
// partials: float32 scratch of conv_dw_splits(...) * 9 * ci * co values.
// dw: float32 [3, 3, ci, co]. Returns the cudaError_t of the launches.
int conv_dw_launch(const void* x, const void* g, int is_bf16, int h, int w, int n, int ci,
                   int co, void* partials, void* dw, void* stream) {
  if (h < 1 || w < 1 || n < 1 || ci < kTile || ci % kTile != 0 || co < kTile ||
      co % kTile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t K = static_cast<int64_t>(h) * w * n;
  const Split sp = split_for(K, ci, co, pix_step(is_bf16));
  const int64_t n_tiles = int64_t{9} * (ci / kTile) * (co / kTile);
  const int64_t blocks = n_tiles * sp.splits;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* pp = static_cast<float*>(partials);
  if (is_bf16) {
    conv_dw_bf16_kernel<<<static_cast<unsigned>(blocks), kThreads16, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g), h, w, n,
        ci, co, K, sp.pix_per_split, pp);
  } else {
    conv_dw_f32_kernel<<<static_cast<unsigned>(blocks), kThreads32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), h, w, n, ci, co, K,
        sp.pix_per_split, pp);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_out = int64_t{9} * ci * co;
  splits_reduce_kernel<<<static_cast<unsigned>((n_out + kReduceThreads - 1) / kReduceThreads),
                         kReduceThreads, 0, s>>>(pp, sp.splits, n_out, static_cast<float*>(dw));
  return static_cast<int>(cudaGetLastError());
}

const char* conv_dw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
