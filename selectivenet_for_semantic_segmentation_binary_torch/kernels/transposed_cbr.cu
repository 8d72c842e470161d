// Fused CBR in the transposed (H, C, W, N) layout, for Hopper (sm_90a):
// conv3x3 with a BatchNorm-apply prologue and a BatchNorm-statistics
// epilogue, forward only, in two designs of one template.
//
// Replaces the Pallas TPU kernels
//   scripts/proto_transposed_cbr.py::transposed_fused_cbr (:123-171,
//     pallas_call :140, body _kernel :49-118)             -> kStackedM = false
//   scripts/proto_transposed_cbr.py::transposed_fused_cbr_v2 (:219-285,
//     pallas_call :254, body _kernel2 :181-214)           -> kStackedM = true
//
// For x (H, Cin, W, N) bf16, w (3, 3, Cin, Cout) bf16 HWIO, a, b (Cin,) and
// bias (Cout,) float32:
//   xn    = bf16(relu(x * a + b))      (the prologue; xn = x when it is off)
//   y     = bf16(conv3x3_same(xn, w) + bias) as (H, Cout, W, N), float32
//           accumulation
//   stats = [sum(y), sum(y * y)] per output channel over H, W, N, taken on
//           the rounded y, in float32
// K2's function (kernels/fused_conv_stats.cu), with the sample index N the
// minor dimension. Positions outside the image are zero AFTER the affine,
// for every a: the copy zero-fills the halo and the prologue runs only on
// in-image elements. (The TPU v2 pre-fills the halo with (-1 - b) / a so that
// the prologue maps it to 0; where |a| <= 1e-12 it fills 0, and relu(b)
// leaks into the border. The port does not reproduce that.)
//
// The layout: a row (h, ci, w) of x is N contiguous samples, and the conv
// does not mix samples. So a CTA owns TR x TW output positions (4 x 8) of
// one block of 16 samples (one wmma column block) and 64 output channels,
// and walks Cin in chunks of 32. Each chunk's (TR + 2) x (TW + 2) positions
// x 32 channels x 16 samples (1.875 staged elements per output element) and
// its 9 x 32 x 64 weights are copied to shared memory with cp.async (16
// bytes a copy; the halo, and samples past N, zero-filled by the copy
// itself), double-buffered; the prologue then runs in place, once per
// staged element. A staged (position, channel) row is 16 samples, 32 bytes,
// so every dx tap's view of the tile is 32-byte aligned for wmma whatever N
// is, the alignment problem of the NHWC tile in fused_cbr_rows.cu gone.
// Where N % 8 != 0 a row of x is not 16-byte aligned: the copy then goes
// element by element (kVec = false).
//
// The GEMM of an output row: M = Cout, K = (dy, dx, ci), columns = (w, n).
// A warp owns 32 output channels x one output row x TW columns x 16 samples
// (16 accumulator fragments), and for each (dy, 16 channels) holds the A
// fragments of the three dx taps. The two designs differ in how the dx
// shift meets the staged columns:
//   v1 (input-side shift): for each output column w and each dx, the B
//      fragment of staged column w + dx is loaded and multiplied: 3 TW
//      B loads per (dy, 16 channels);
//   v2 (stacked-M, output-side shift): the B fragment of each staged column
//      s is loaded once and multiplied with the three dx slices of the
//      (3 Cout x 3 Cin) stacked weights, each product added to the
//      accumulator of output column s - dx: TW + 2 B loads.
// Both add the products into an accumulator in the same order (dy, channel
// block, dx), so v1 and v2 give the same y bit for bit.
//
// Registers: the 16 accumulator fragments hold 128 of a thread's 255; 201 KB
// of shared memory, one CTA an SM. The loops over a chunk's x copies stay
// rolled: unrolled, their addresses spilled the accumulators (312-416 bytes
// of spills, 5.8 instead of 4.3 ms at the level-1 shape on an H100).
//
// Bound: 2 * 9 * Cin * Cout FLOP per output element against 2 (Cin + Cout)
// bytes of x and y: at the level-1 shape (N 128, 256 x 256, 64 -> 64) 618.5
// GFLOP and 2.15 GB, 0.625 ms of tensor cores and 0.641 ms of HBM; wider
// layers are bound by the tensor cores.
//
// Epilogue as in fused_cbr_rows.cu: the bias, one rounding to bf16, the
// store of y, one row of per-CTA channel sums of the rounded y (summed in a
// fixed order), and rows_reduce_kernel. No float atomics: y and stats are
// identical run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kTR = 4;         // output rows per CTA (one per warp row)
constexpr int kTW = 8;         // output columns per CTA
constexpr int kNB = 16;        // samples per CTA: one wmma column block
constexpr int kBM = 64;        // output channels per CTA
constexpr int kBK = 32;        // input channels per chunk
constexpr int kThreads = 256;  // 8 warps: 2 along Cout (32 each) x 4 output rows
constexpr int kSR = kTR + 2;   // staged rows
constexpr int kSW = kTW + 2;   // staged columns
constexpr int kSP = kSR * kSW;                // staged positions
constexpr int kXStage = kSP * kBK * kNB;      // bf16 elements: [position][channel][sample]
constexpr int kWP = kBM + 8;                  // staged weight row pitch (bf16)
constexpr int kWStage = 9 * kBK * kWP;        // [tap][channel][output channel]
constexpr int kStage = kXStage + kWStage;     // bf16 elements of one buffer
constexpr int kPix = kTR * kTW * kNB;         // output elements per channel per CTA
constexpr int kCLd = kPix + 4;                // float32 epilogue pitch: [channel][pixel]
constexpr int kPipeBytes = 2 * kStage * 2;
constexpr int kEpiBytes = kBM * kCLd * 4;
constexpr int kSmemBytes = kPipeBytes > kEpiBytes ? kPipeBytes : kEpiBytes;
constexpr int kXCopies = kSP * kBK * (kNB / 8);  // 16-byte copies of a chunk's x
constexpr int kXElems = kSP * kBK * kNB;         // elements of a chunk's x
constexpr int kWCopies = 9 * kBK * (kBM / 8);    // 16-byte copies of a chunk's weights
static_assert(kXCopies % kThreads == 0 && kXElems % kThreads == 0 && kWCopies % kThreads == 0,
              "copies split evenly over the threads");
static_assert(kXStage * 2 % 128 == 0 && kStage * 2 % 128 == 0, "128-byte aligned buffers");
static_assert(kSmemBytes <= 227 * 1024, "fits a CTA's shared memory");

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

template <bool kStackedM, bool kPrologue, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
transposed_cbr_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ a,
                      const float* __restrict__ b,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bias,
                      int H, int Cin, int W, int N, int Cout, int n_tc, int n_nb,
                      int64_t n_tiles_m, int n_tiles_n,
                      __nv_bfloat16* __restrict__ y,
                      float* __restrict__ partials) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[2][4][kBM];

  const int tid = threadIdx.x;
  const int64_t tile_m = blockIdx.x / n_tiles_n;
  const int tile_n = static_cast<int>(blockIdx.x % n_tiles_n);
  const int nb_i = static_cast<int>(tile_m % n_nb);
  const int tc_i = static_cast<int>((tile_m / n_nb) % n_tc);
  const int tr_i = static_cast<int>(tile_m / (static_cast<int64_t>(n_nb) * n_tc));
  const int h0 = tr_i * kTR;
  const int w0 = tc_i * kTW;
  const int s0 = nb_i * kNB;  // first sample
  const int co0 = tile_n * kBM;
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);

  // staged (row, column) -> inside the image?; *off: offset of (hh, ci, ww, s0)
  auto staged = [&](int sr, int sc, int ci, int64_t* off) {
    const int hh = h0 + sr - 1;
    const int ww = w0 + sc - 1;
    *off = ((static_cast<int64_t>(hh) * Cin + ci) * W + ww) * N + s0;
    return hh >= 0 && hh < H && ww >= 0 && ww < W;
  };

  // copies of chunk `chunk` (input channels chunk * 32 ..) into buffer st;
  // without kVec the x tile is loaded element by element, the prologue
  // applied on the way
  auto copy_chunk = [&](int chunk, int st) {
    const int c0 = chunk * kBK;
    __nv_bfloat16* xs = stages + st * kStage;
    __nv_bfloat16* ws = xs + kXStage;
    if (kVec) {
#pragma unroll 1  // unrolled, the copies' addresses spill the accumulators
      for (int i = 0; i < kXCopies / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int half = idx & 1;
        const int sc = (idx >> 1) % kSW;
        const int k = ((idx >> 1) / kSW) % kBK;
        const int sr = (idx >> 1) / (kSW * kBK);
        int64_t off;
        const bool in = staged(sr, sc, c0 + k, &off) && s0 + half * 8 < N;
        cp_async16(xs + ((sr * kSW + sc) * kBK + k) * kNB + half * 8,
                   in ? x + off + half * 8 : x, in);
      }
    } else {
      for (int i = 0; i < kXElems / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int n = idx % kNB;
        const int sc = (idx / kNB) % kSW;
        const int k = (idx / (kNB * kSW)) % kBK;
        const int sr = idx / (kNB * kSW * kBK);
        int64_t off;
        __nv_bfloat16 v = __float2bfloat16_rn(0.0f);
        if (staged(sr, sc, c0 + k, &off) && s0 + n < N) {
          v = x[off + n];
          if (kPrologue) v = prologue1(v, __ldg(a + c0 + k), __ldg(b + c0 + k));
        }
        xs[((sr * kSW + sc) * kBK + k) * kNB + n] = v;
      }
    }
#pragma unroll
    for (int i = 0; i < kWCopies / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx >> 3;  // tap * 32 + input channel of the chunk
      const int cv = idx & 7;
      const int tap = row / kBK;
      const int k = row - tap * kBK;
      const int64_t src = (static_cast<int64_t>(tap) * Cin + c0 + k) * Cout + co0 + cv * 8;
      cp_async16(ws + row * kWP + cv * 8, w + src, true);
    }
    cp_async_commit();
  };

  // the prologue, in place, on the 16-byte pieces this thread copied; the
  // halo and the samples past N (zero-filled) stay zero
  auto normalise = [&](int chunk, int st) {
    const int c0 = chunk * kBK;
    __nv_bfloat16* xs = stages + st * kStage;
#pragma unroll 1  // unrolled, the copies' addresses spill the accumulators
    for (int i = 0; i < kXCopies / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int half = idx & 1;
      const int sc = (idx >> 1) % kSW;
      const int k = ((idx >> 1) / kSW) % kBK;
      const int sr = (idx >> 1) / (kSW * kBK);
      int64_t off;
      if (staged(sr, sc, c0 + k, &off) && s0 + half * 8 < N) {
        uint4* p = reinterpret_cast<uint4*>(xs + ((sr * kSW + sc) * kBK + k) * kNB + half * 8);
        *p = prologue8_1ch(*p, __ldg(a + c0 + k), __ldg(b + c0 + k));
      }
    }
  };

  const int warp = tid >> 5;
  const int wn = warp & 1;   // output channels wn * 32 .. + 32
  const int wr = warp >> 1;  // output row h0 + wr
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kTW][2];
#pragma unroll
  for (int c = 0; c < kTW; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i) wmma::fill_fragment(acc[c][i], 0.0f);

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
    if (kPrologue && kVec) normalise(ch, st);
    __syncthreads();
    const __nv_bfloat16* xs = stages + st * kStage;
    const __nv_bfloat16* ws = xs + kXStage;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const __nv_bfloat16* xrow = xs + (wr + dy) * kSW * kBK * kNB;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[3][2];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(fa[dx][i],
                                   ws + ((dy * 3 + dx) * kBK + kk) * kWP + wn * 32 + i * 16, kWP);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        if (kStackedM) {
#pragma unroll
          for (int s = 0; s < kSW; ++s) {
            wmma::load_matrix_sync(fb, xrow + (s * kBK + kk) * kNB, kNB);
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const int c = s - dx;
              if (c >= 0 && c < kTW) {
#pragma unroll
                for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[c][i], fa[dx][i], fb, acc[c][i]);
              }
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < kTW; ++c)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              wmma::load_matrix_sync(fb, xrow + ((c + dx) * kBK + kk) * kNB, kNB);
#pragma unroll
              for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[c][i], fa[dx][i], fb, acc[c][i]);
            }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: the accumulators go to shared memory as [channel][pixel],
  // pixel = (row, column, sample) (reusing the buffers: all copies have
  // landed and every warp has left the last chunk)
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int c = 0; c < kTW; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::store_matrix_sync(Cs + (wn * 32 + i * 16) * kCLd + (wr * kTW + c) * kNB, acc[c][i],
                              kCLd, wmma::mem_row_major);
  __syncthreads();

  // bias, one rounding to bf16, the store of y; the rounded values stay in
  // shared memory for the sums (elements outside the output count as zero)
  const int64_t row_stride = static_cast<int64_t>(W) * N;  // y[h][co] rows
  for (int v = tid; v < kBM * kPix / 8; v += kThreads) {
    const int co = v / (kPix / 8);
    const int p0 = (v % (kPix / 8)) * 8;
    const int r = p0 / (kTW * kNB);
    const int c = (p0 / kNB) % kTW;
    const int n = s0 + p0 % kNB;
    const int hh = h0 + r;
    const int ww = w0 + c;
    float* cs = Cs + co * kCLd + p0;
    const float bv = __ldg(bias + co0 + co);
    const bool in = hh < H && ww < W;
    __nv_bfloat16* out = y + (static_cast<int64_t>(hh) * Cout + co0 + co) * row_stride +
                         static_cast<int64_t>(ww) * N + n;
    if (kVec && in && n < N) {
      uint4 o;
      __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        op[j] = __floats2bfloat162_rn(cs[2 * j] + bv, cs[2 * j + 1] + bv);
        const float2 f = __bfloat1622float2(op[j]);
        cs[2 * j] = f.x;
        cs[2 * j + 1] = f.y;
      }
      *reinterpret_cast<uint4*>(out) = o;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (!kVec && in && n + j < N) {
          const __nv_bfloat16 o = __float2bfloat16_rn(cs[j] + bv);
          out[j] = o;
          cs[j] = __bfloat162float(o);
        } else {
          cs[j] = 0.0f;
        }
      }
    }
  }
  __syncthreads();

  // per-channel sums of this tile in a fixed order: 4 threads a channel,
  // kPix / 4 pixels each, then the 4 parts in order
  {
    const int col = tid & (kBM - 1);
    const int part = tid / kBM;
    float s = 0.0f, q = 0.0f;
    const float* cs = Cs + col * kCLd;
    for (int p = part * (kPix / 4); p < (part + 1) * (kPix / 4); ++p) {
      const float v = cs[p];
      s += v;
      q += v * v;
    }
    red[0][part][col] = s;
    red[1][part][col] = q;
  }
  __syncthreads();
  if (tid < 2 * kBM) {
    const int s = tid / kBM;
    const int col = tid & (kBM - 1);
    const float t = ((red[s][0][col] + red[s][1][col]) + red[s][2][col]) + red[s][3][col];
    partials[(static_cast<int64_t>(s) * Cout + co0 + col) * n_tiles_m + tile_m] = t;
  }
}

struct Tiles {
  int n_tr, n_tc, n_nb;
  int64_t m;
};

Tiles tiles(int h, int wd, int n) {
  Tiles t;
  t.n_tr = (h + kTR - 1) / kTR;
  t.n_tc = (wd + kTW - 1) / kTW;
  t.n_nb = (n + kNB - 1) / kNB;
  t.m = static_cast<int64_t>(t.n_tr) * t.n_tc * t.n_nb;
  return t;
}

template <bool kStackedM, bool kPrologue, bool kVec>
int launch(const __nv_bfloat16* x, const float* a, const float* b, const __nv_bfloat16* w,
           const float* bias, int h, int cin, int wd, int n, int cout, __nv_bfloat16* y,
           float* partials, cudaStream_t s) {
  auto kernel = transposed_cbr_kernel<kStackedM, kPrologue, kVec>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Tiles t = tiles(h, wd, n);
  const int n_tiles_n = cout / kBM;
  const int64_t blocks = t.m * n_tiles_n;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes, s>>>(
      x, a, b, w, bias, h, cin, wd, n, cout, t.n_tc, t.n_nb, t.m, n_tiles_n, y, partials);
  return static_cast<int>(cudaGetLastError());
}

template <bool kStackedM>
int launch_v(const __nv_bfloat16* x, const float* a, const float* b, const __nv_bfloat16* w,
             const float* bias, bool prologue, bool vec, int h, int cin, int wd, int n, int cout,
             __nv_bfloat16* y, float* partials, cudaStream_t s) {
  if (prologue) {
    return vec ? launch<kStackedM, true, true>(x, a, b, w, bias, h, cin, wd, n, cout, y, partials, s)
               : launch<kStackedM, true, false>(x, a, b, w, bias, h, cin, wd, n, cout, y, partials, s);
  }
  return vec ? launch<kStackedM, false, true>(x, a, b, w, bias, h, cin, wd, n, cout, y, partials, s)
             : launch<kStackedM, false, false>(x, a, b, w, bias, h, cin, wd, n, cout, y, partials, s);
}

}  // namespace

extern "C" {

int transposed_cbr_tile_n() { return kBM; }
int transposed_cbr_tile_k() { return kBK; }

// The number of CTA pixel tiles (columns of the partials scratch) for this shape.
int64_t transposed_cbr_tiles_m(int h, int wd, int n) { return tiles(h, wd, n).m; }

// x (h, cin, wd, n) bf16; w (3, 3, cin, cout) bf16; a, b (cin,), bias (cout,)
// float32; y (h, cout, wd, n) bf16. stacked_m: 0 for v1, 1 for v2. partials:
// float32 scratch of 2 * cout * transposed_cbr_tiles_m(h, wd, n) values;
// stats: float32 (2, cout). x, w and y 16-byte aligned; n % 8 == 0 takes the
// 16-byte copies. Returns the cudaError_t of the launches.
int transposed_cbr_launch(const void* x, const void* a, const void* b, const void* w,
                          const void* bias, int stacked_m, int apply_prologue, int h, int cin,
                          int wd, int n, int cout, void* y, void* partials, void* stats,
                          void* stream) {
  if (h < 1 || wd < 1 || n < 1 || cin < kBK || cin % kBK != 0 || cout < kBM || cout % kBM != 0) {
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
  const bool vec = n % 8 == 0;
  const int rc = stacked_m
      ? launch_v<true>(xp, ap, bp, wp, biasp, apply_prologue, vec, h, cin, wd, n, cout, yp, pp, s)
      : launch_v<false>(xp, ap, bp, wp, biasp, apply_prologue, vec, h, cin, wd, n, cout, yp, pp, s);
  if (rc != 0) return rc;
  rows_reduce_kernel<<<2 * cout, kRowsReduceThreads, 0, s>>>(pp, tiles(h, wd, n).m,
                                                            static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}

const char* transposed_cbr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
