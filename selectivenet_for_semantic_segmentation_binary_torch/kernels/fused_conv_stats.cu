// Fused conv3x3 with a BatchNorm-apply prologue and a BatchNorm-statistics
// epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   selectivenet_for_semantic_segmentation_binary_tpu/ops/fused_cbr.py
//   ::fused_conv_stats (_pallas_fwd :148-194, pallas_call :170, body
//   _fwd_kernel :98-145).
//
// For x (N, H, W, Cin) bf16 NHWC, w (3, 3, Cin, Cout) bf16 HWIO, a, b (Cin,)
// and bias (Cout,) float32:
//   xn    = bf16(relu(x * a + b))      (the prologue; xn = x when it is off)
//   y     = bf16(conv3x3_same(xn, w) + bias), float32 accumulation
//   stats = [sum(y), sum(y * y)] per output channel over N, H, W, taken on
//           the rounded y, in float32
// Positions outside the image are zero AFTER the affine: SAME padding pads
// the normalised input, so relu(b) must not leak into the halo (the Pallas
// kernel zeroes its pad ring for the same reason, fused_cbr.py:113-128).
//
// Bound: at the model's shapes an implicit GEMM of M = N*H*W pixels by Cout
// with depth 9*Cin does 2*9*Cin*Cout flops per (2*Cin + 2*Cout) bytes of x
// and y, 288 at Cin = Cout = 64 and more at every wider layer: at or above
// the H100's ~295 flop/byte bf16 ridge, so the tensor cores bound it. The
// design is the simple right one: a 128-pixel x 64-channel block tile, the K
// loop walking the 9 taps times Cin in chunks of 32; each chunk's shifted
// input window is loaded to registers one step ahead (the prologue applied
// on the way, in float32 with separate multiply and add, as PyTorch does
// it), stored to a double-buffered shared-memory tile, and multiplied on the
// tensor cores through nvcuda::wmma (bf16 16x16x16, float32 accumulators).
// The epilogue adds the bias, rounds, stores y and writes one row of
// per-block channel sums; a second small kernel sums those rows in a fixed
// order. No float atomics: y and stats are identical from run to run.
// wgmma, TMA and warp specialisation are later work.
//
// Only the forward is a kernel. The backward stays where the JAX package
// has it, outside any kernel: the port's torch.autograd.Function runs
// cuDNN's conv backward plus elementwise PyTorch (ops/fused_cbr.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kBM = 128;       // output pixels per block
constexpr int kBN = 64;        // output channels per block
constexpr int kBK = 32;        // input channels per K step (one tap)
constexpr int kThreads = 256;  // 8 warps: 4 along M x 2 along N, 32x32 each
constexpr int kALd = kBK + 8;  // shared-memory row pitch of the A tile (bf16)
constexpr int kBLd = kBN + 8;  // of the B tile (bf16)
constexpr int kCLd = kBN + 4;  // of the float32 epilogue tile
constexpr int kAStage = kBM * kALd;  // bf16 elements per pipeline stage
constexpr int kBStage = kBK * kBLd;
constexpr int kPipeBytes = 2 * (kAStage + kBStage) * 2;
constexpr int kEpiBytes = kBM * kCLd * 4;
constexpr int kSmemBytes = kPipeBytes > kEpiBytes ? kPipeBytes : kEpiBytes;

template <bool kPrologue>
__global__ void __launch_bounds__(kThreads, 2)
fused_conv_stats_kernel(const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ a,
                        const float* __restrict__ b,
                        const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ bias,
                        int H, int W, int Cin, int Cout, int64_t M,
                        int64_t n_tiles_m, int n_tiles_n,
                        __nv_bfloat16* __restrict__ y,
                        float* __restrict__ partials) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __shared__ float red[2][4][kBN];

  const int tid = threadIdx.x;
  const int64_t tile_m = blockIdx.x / n_tiles_n;
  const int tile_n = static_cast<int>(blockIdx.x % n_tiles_n);
  const int64_t m0 = tile_m * kBM;
  const int n0 = tile_n * kBN;

  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + 2 * kAStage;

  // This thread loads 8 channels (a_cv) of A rows a_row0 and a_row0 + 64,
  // and 8 channels (b_cv) of B row b_row, at every K step.
  const int a_row0 = tid >> 2;
  const int a_cv = tid & 3;
  const int b_row = tid >> 3;
  const int b_cv = tid & 7;
  const int64_t hw = static_cast<int64_t>(H) * W;
  int64_t a_img[2];
  int a_h[2], a_w[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t m = m0 + a_row0 + i * 64;
    a_ok[i] = m < M;
    const int64_t mm = a_ok[i] ? m : 0;
    const int64_t n = mm / hw;
    const int64_t rem = mm - n * hw;
    a_img[i] = n * hw;
    a_h[i] = static_cast<int>(rem / W);
    a_w[i] = static_cast<int>(rem - static_cast<int64_t>(a_h[i]) * W);
  }

  const int k_chunks = Cin / kBK;
  const int k_steps = 9 * k_chunks;
  uint4 a_reg[2];
  uint4 b_reg;

  auto load = [&](int ks) {
    const int tap = ks / k_chunks;
    const int c0 = (ks - tap * k_chunks) * kBK;
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int hh = a_h[i] + dy;
      const int ww = a_w[i] + dx;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);  // the halo: zero after the affine
      if (a_ok[i] && hh >= 0 && hh < H && ww >= 0 && ww < W) {
        const int64_t pix = a_img[i] + static_cast<int64_t>(hh) * W + ww;
        const int c = c0 + a_cv * 8;
        v = __ldg(reinterpret_cast<const uint4*>(x + pix * Cin + c));
        if (kPrologue) v = prologue8(v, a + c, b + c);
      }
      a_reg[i] = v;
    }
    const int64_t wrow = static_cast<int64_t>(tap) * Cin + c0 + b_row;
    b_reg = __ldg(reinterpret_cast<const uint4*>(w + wrow * Cout + n0 + b_cv * 8));
  };

  auto store = [&](int stage) {
    __nv_bfloat16* as = As + stage * kAStage;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<uint4*>(as + (a_row0 + i * 64) * kALd + a_cv * 8) = a_reg[i];
    }
    *reinterpret_cast<uint4*>(Bs + stage * kBStage + b_row * kBLd + b_cv * 8) = b_reg;
  };

  const int warp = tid >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load(0);
  store(0);
  __syncthreads();
  for (int ks = 0; ks < k_steps; ++ks) {
    const int stage = ks & 1;
    // the next step's global loads are in flight during this step's products
    if (ks + 1 < k_steps) load(ks + 1);
    const __nv_bfloat16* as = As + stage * kAStage;
    const __nv_bfloat16* bs = Bs + stage * kBStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * kALd + kk, kALd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * kBLd + wn * 32 + j * 16, kBLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    // the other stage was last read in step ks - 1, which every warp has
    // left (the barrier below ends each step)
    if (ks + 1 < k_steps) store(stage ^ 1);
    __syncthreads();
  }

  // epilogue: the accumulators go to shared memory (reusing the tiles)
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kCLd + wn * 32 + j * 16,
                              acc[i][j], kCLd, wmma::mem_row_major);
  __syncthreads();

  // bias, one rounding to bf16, the store of y; the rounded values stay in
  // shared memory for the sums (rows past M count as zero)
  for (int v = tid; v < kBM * kBN / 8; v += kThreads) {
    const int row = v >> 3;
    const int cv = v & 7;
    const int64_t m = m0 + row;
    float* c = Cs + row * kCLd + cv * 8;
    if (m < M) {
      const float4 q0 = __ldg(reinterpret_cast<const float4*>(bias + n0 + cv * 8));
      const float4 q1 = __ldg(reinterpret_cast<const float4*>(bias + n0 + cv * 8) + 1);
      const float bv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
      uint4 out;
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j] = __floats2bfloat162_rn(c[2 * j] + bv[2 * j], c[2 * j + 1] + bv[2 * j + 1]);
        const float2 r = __bfloat1622float2(o[j]);
        c[2 * j] = r.x;
        c[2 * j + 1] = r.y;
      }
      *reinterpret_cast<uint4*>(y + m * Cout + n0 + cv * 8) = out;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) c[j] = 0.0f;
    }
  }
  __syncthreads();

  // per-channel sums of this tile in a fixed order: 4 threads a channel,
  // 32 rows each, then the 4 parts in order
  {
    const int col = tid & (kBN - 1);
    const int part = tid / kBN;
    float s = 0.0f, q = 0.0f;
    for (int r = part * (kBM / 4); r < (part + 1) * (kBM / 4); ++r) {
      const float v = Cs[r * kCLd + col];
      s += v;
      q += v * v;
    }
    red[0][part][col] = s;
    red[1][part][col] = q;
  }
  __syncthreads();
  if (tid < 2 * kBN) {
    const int s = tid / kBN;
    const int col = tid & (kBN - 1);
    const float t = ((red[s][0][col] + red[s][1][col]) + red[s][2][col]) + red[s][3][col];
    partials[(static_cast<int64_t>(s) * Cout + n0 + col) * n_tiles_m + tile_m] = t;
  }
}

}  // namespace

extern "C" {

int fused_conv_stats_tile_m() { return kBM; }
int fused_conv_stats_tile_n() { return kBN; }
int fused_conv_stats_tile_k() { return kBK; }

// partials: float32 scratch of 2 * cout * ceil(n*h*w / tile_m) values.
// stats: float32 (2, cout). Returns the cudaError_t of the launches.
int fused_conv_stats_launch(const void* x, const void* a, const void* b,
                            const void* w, const void* bias, int apply_prologue,
                            int n, int h, int wd, int cin, int cout, void* y,
                            void* partials, void* stats, void* stream) {
  if (n < 1 || h < 1 || wd < 1 || cin < kBK || cin % kBK != 0 ||
      cout < kBN || cout % kBN != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t M = static_cast<int64_t>(n) * h * wd;
  const int64_t n_tiles_m = (M + kBM - 1) / kBM;
  const int n_tiles_n = cout / kBN;
  const int64_t blocks = n_tiles_m * n_tiles_n;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(b);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  const auto* biasp = static_cast<const float*>(bias);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  auto* pp = static_cast<float*>(partials);
  if (apply_prologue) {
    fused_conv_stats_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        xp, ap, bp, wp, biasp, h, wd, cin, cout, M, n_tiles_m, n_tiles_n, yp, pp);
  } else {
    fused_conv_stats_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        xp, ap, bp, wp, biasp, h, wd, cin, cout, M, n_tiles_m, n_tiles_n, yp, pp);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rows_reduce_kernel<<<2 * cout, kRowsReduceThreads, 0, s>>>(pp, n_tiles_m,
                                                            static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}

const char* fused_conv_stats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
