// Fused CBR with a staged, normalised halo tile, for Hopper (sm_90a):
// conv3x3 with a BatchNorm-apply prologue and a BatchNorm-statistics
// epilogue, forward only.
//
// Replaces the Pallas TPU kernel
//   scripts/proto_fused_cbr.py::fused_cbr (:107-160, pallas_call :137,
//   body _fused_cbr_kernel :42-103).
//
// For x (N, H, W, Cin) bf16 NHWC, w (3, 3, Cin, Cout) bf16 HWIO, a, b (Cin,)
// and bias (Cout,) float32:
//   xn    = bf16(relu(x * a + b))      (the prologue; xn = x when it is off)
//   y     = bf16(conv3x3_same(xn, w) + bias), float32 accumulation
//   stats = [sum(y), sum(y * y)] per output channel over N, H, W, taken on
//           the rounded y, in float32
// Positions outside the image are zero AFTER the affine (SAME padding pads
// the normalised input); rows and columns of the staged tile that lie inside
// the image but outside the CTA's own outputs are real neighbours, with the
// prologue applied.
//
// The prototype's design, as the TPU ran it: stage the normalised input of
// a band of rows, halo included, once, and run the nine taps from the
// staged copy, so the prologue is applied about once per input element per
// output-channel tile, where kernels/fused_conv_stats.cu applies it on each
// of the nine taps' loads. The TPU's whole (rows + 2) x (W + 2) x Cin band
// does not fit in a CTA's shared memory at 256x256, so the band is tiled:
// a CTA owns TR x TC = 128 output pixels (2 rows x 64 columns, or 4 x 32
// where W <= 32) and 64 output channels, and walks Cin in chunks of 32.
// Each chunk's (TR + 2) x (TC + 2) x 32 input tile (4 x 66 x 32: about 2.06
// staged elements per output pixel) and its 9 x 32 x 64 weights are copied
// to shared memory with cp.async (16 bytes a copy, the halo zero-filled by
// the copy itself), double-buffered so the next chunk's copies overlap this
// chunk's products; the prologue then runs in place on the staged tile, once
// per element, and the nine taps are nine shifted views of it multiplied on
// the tensor cores through nvcuda::wmma (bf16 16x16x16, float32
// accumulators). A staged pixel's row is 48 bf16 (96 bytes) so that every
// tap's view starts 32-byte aligned, as wmma requires.
//
// Bound: as for fused_conv_stats.cu, at or above the ~295 flop/byte bf16
// ridge at every layer of the model: the tensor cores bound it.
//
// Epilogue as in fused_conv_stats.cu: the bias, one rounding to bf16, the
// store of y, one row of per-CTA channel sums of the rounded y (summed in a
// fixed order), and a second kernel that sums the rows in a fixed order. No
// float atomics: y and stats are identical run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kBM = 128;       // output pixels per CTA (TR rows x TC columns)
constexpr int kBN = 64;        // output channels per CTA
constexpr int kBK = 32;        // input channels per chunk
constexpr int kThreads = 256;  // 8 warps: 4 along the pixels x 2 along Cout, 32x32 each
constexpr int kXP = 48;        // staged pixel pitch (bf16): 96 bytes, a multiple of 32
constexpr int kWP = kBN + 8;   // staged weight row pitch (bf16)
constexpr int kCLd = kBN + 4;  // float32 epilogue tile pitch
constexpr int kWStage = 9 * kBK * kWP;
constexpr int kWCopies = 9 * kBK * (kBN / 8);  // 16-byte copies of a chunk's weights
static_assert(kWCopies % kThreads == 0, "weight copies split evenly over the threads");

template <int TC>
struct Geo {
  static constexpr int TR = kBM / TC;
  static constexpr int SW = TC + 2;               // staged columns
  static constexpr int SP = (TR + 2) * SW;        // staged pixels
  static constexpr int XStage = SP * kXP;         // bf16 elements
  static constexpr int Stage = XStage + kWStage;  // bf16 elements of one buffer
  static constexpr int XCopies = SP * (kBK / 8);  // 16-byte copies of a chunk's x
  static constexpr int XIters = (XCopies + kThreads - 1) / kThreads;
  static constexpr int PipeBytes = 2 * Stage * 2;
  static constexpr int EpiBytes = kBM * kCLd * 4;
  static constexpr int SmemBytes = PipeBytes > EpiBytes ? PipeBytes : EpiBytes;
  static_assert(XStage * 2 % 128 == 0 && Stage * 2 % 128 == 0, "128-byte aligned buffers");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool fill) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = fill ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int TC, bool kPrologue>
__global__ void __launch_bounds__(kThreads, 1)
fused_cbr_rows_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ a,
                      const float* __restrict__ b,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bias,
                      int H, int W, int Cin, int Cout, int n_tr, int n_tc,
                      int64_t n_tiles_m, int n_tiles_n,
                      __nv_bfloat16* __restrict__ y,
                      float* __restrict__ partials) {
  using G = Geo<TC>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[2][4][kBN];

  const int tid = threadIdx.x;
  const int64_t tile_m = blockIdx.x / n_tiles_n;
  const int tile_n = static_cast<int>(blockIdx.x % n_tiles_n);
  const int tc_i = static_cast<int>(tile_m % n_tc);
  const int tr_i = static_cast<int>((tile_m / n_tc) % n_tr);
  const int64_t img = tile_m / (static_cast<int64_t>(n_tc) * n_tr);
  const int h0 = tr_i * G::TR;
  const int w0 = tc_i * TC;
  const int n0 = tile_n * kBN;
  const __nv_bfloat16* x_img = x + img * H * W * Cin;
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);

  // staged pixel -> (inside the image?, its offset in x_img)
  auto staged = [&](int pix, int64_t* off) {
    const int sr = pix / G::SW;
    const int sc = pix - sr * G::SW;
    const int hh = h0 + sr - 1;
    const int ww = w0 + sc - 1;
    *off = (static_cast<int64_t>(hh) * W + ww) * Cin;
    return hh >= 0 && hh < H && ww >= 0 && ww < W;
  };

  // copies of chunk `chunk` (input channels chunk * 32 ..) into buffer st
  auto copy_chunk = [&](int chunk, int st) {
    const int c0 = chunk * kBK;
    __nv_bfloat16* xs = stages + st * G::Stage;
    __nv_bfloat16* ws = xs + G::XStage;
#pragma unroll
    for (int i = 0; i < G::XIters; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < G::XCopies) {
        const int pix = idx >> 2;
        const int cv = idx & 3;
        int64_t off;
        const bool in = staged(pix, &off);
        cp_async16(xs + pix * kXP + cv * 8, in ? x_img + off + c0 + cv * 8 : x, in);
      }
    }
#pragma unroll
    for (int i = 0; i < kWCopies / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx >> 3;  // tap * 32 + input channel of the chunk
      const int cv = idx & 7;
      const int tap = row / kBK;
      const int k = row - tap * kBK;
      const int64_t src = (static_cast<int64_t>(tap) * Cin + c0 + k) * Cout + n0 + cv * 8;
      cp_async16(ws + row * kWP + cv * 8, w + src, true);
    }
    cp_async_commit();
  };

  // the prologue, in place, on the staged elements this thread copied; the
  // halo (zero-filled) stays zero
  auto normalise = [&](int chunk, int st) {
    const int c0 = chunk * kBK;
    __nv_bfloat16* xs = stages + st * G::Stage;
#pragma unroll
    for (int i = 0; i < G::XIters; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < G::XCopies) {
        const int pix = idx >> 2;
        const int cv = idx & 3;
        int64_t off;
        if (staged(pix, &off)) {
          uint4* p = reinterpret_cast<uint4*>(xs + pix * kXP + cv * 8);
          *p = prologue8(*p, a + c0 + cv * 8, b + c0 + cv * 8);
        }
      }
    }
  };

  const int warp = tid >> 5;
  const int wm = warp & 3;   // output pixels wm * 32 .. + 32: one row of the tile
  const int wn = warp >> 2;  // output channels wn * 32 .. + 32
  const int r_w = (wm * 32) / TC;
  const int c_w = (wm * 32) % TC;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int n_chunks = Cin / kBK;
  copy_chunk(0, 0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int st = ch & 1;
    // buffer st ^ 1 was last read in chunk ch - 1, which every warp has left
    // (the barrier that ends each chunk)
    if (ch + 1 < n_chunks) {
      copy_chunk(ch + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (kPrologue) normalise(ch, st);
    __syncthreads();
    const __nv_bfloat16* xs = stages + st * G::Stage;
    const __nv_bfloat16* ws = xs + G::XStage;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], xs + ((r_w + dy) * G::SW + c_w + i * 16 + dx) * kXP + kk,
                                 kXP);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], ws + (tap * kBK + kk) * kWP + wn * 32 + j * 16, kWP);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // epilogue: the accumulators go to shared memory (reusing the buffers; all
  // copies have landed and every warp has left the last chunk)
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kCLd + wn * 32 + j * 16, acc[i][j], kCLd,
                              wmma::mem_row_major);
  __syncthreads();

  // bias, one rounding to bf16, the store of y; the rounded values stay in
  // shared memory for the sums (pixels outside the image count as zero)
  for (int v = tid; v < kBM * kBN / 8; v += kThreads) {
    const int row = v >> 3;
    const int cv = v & 7;
    const int hh = h0 + row / TC;
    const int ww = w0 + row % TC;
    float* c = Cs + row * kCLd + cv * 8;
    if (hh < H && ww < W) {
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
      const int64_t pix = (img * H + hh) * static_cast<int64_t>(W) + ww;
      *reinterpret_cast<uint4*>(y + pix * Cout + n0 + cv * 8) = out;
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

// The tile's columns: 32 where the image is at most 32 wide, else 64.
int tile_cols(int wd) { return wd <= 32 ? 32 : 64; }

int64_t tiles_m(int n, int h, int wd) {
  const int tc = tile_cols(wd);
  const int tr = kBM / tc;
  return static_cast<int64_t>(n) * ((h + tr - 1) / tr) * ((wd + tc - 1) / tc);
}

template <int TC, bool kPrologue>
int launch(const __nv_bfloat16* x, const float* a, const float* b, const __nv_bfloat16* w,
           const float* bias, int n, int h, int wd, int cin, int cout, __nv_bfloat16* y,
           float* partials, cudaStream_t s) {
  using G = Geo<TC>;
  cudaError_t err = cudaFuncSetAttribute(fused_cbr_rows_kernel<TC, kPrologue>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         G::SmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tr = (h + G::TR - 1) / G::TR;
  const int n_tc = (wd + TC - 1) / TC;
  const int64_t n_tiles_m = tiles_m(n, h, wd);
  const int n_tiles_n = cout / kBN;
  const int64_t blocks = n_tiles_m * n_tiles_n;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  fused_cbr_rows_kernel<TC, kPrologue><<<static_cast<unsigned>(blocks), kThreads, G::SmemBytes, s>>>(
      x, a, b, w, bias, h, wd, cin, cout, n_tr, n_tc, n_tiles_m, n_tiles_n, y, partials);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fused_cbr_rows_tile_n() { return kBN; }
int fused_cbr_rows_tile_k() { return kBK; }

// The number of CTA pixel tiles (columns of the partials scratch) for this shape.
int64_t fused_cbr_rows_tiles_m(int n, int h, int wd) { return tiles_m(n, h, wd); }

// partials: float32 scratch of 2 * cout * fused_cbr_rows_tiles_m(n, h, wd)
// values. stats: float32 (2, cout). Returns the cudaError_t of the launches.
int fused_cbr_rows_launch(const void* x, const void* a, const void* b, const void* w,
                          const void* bias, int apply_prologue, int n, int h, int wd, int cin,
                          int cout, void* y, void* partials, void* stats, void* stream) {
  if (n < 1 || h < 1 || wd < 1 || cin < kBK || cin % kBK != 0 || cout < kBN ||
      cout % kBN != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(b);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  const auto* biasp = static_cast<const float*>(bias);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  auto* pp = static_cast<float*>(partials);
  int rc;
  if (tile_cols(wd) == 32) {
    rc = apply_prologue ? launch<32, true>(xp, ap, bp, wp, biasp, n, h, wd, cin, cout, yp, pp, s)
                        : launch<32, false>(xp, ap, bp, wp, biasp, n, h, wd, cin, cout, yp, pp, s);
  } else {
    rc = apply_prologue ? launch<64, true>(xp, ap, bp, wp, biasp, n, h, wd, cin, cout, yp, pp, s)
                        : launch<64, false>(xp, ap, bp, wp, biasp, n, h, wd, cin, cout, yp, pp, s);
  }
  if (rc != 0) return rc;
  rows_reduce_kernel<<<2 * cout, kRowsReduceThreads, 0, s>>>(pp, tiles_m(n, h, wd),
                                                            static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}

const char* fused_cbr_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
