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
// [3, 3, Ci, Co]. No padded copy is made.
//
// Formulation: nine GEMMs that share their B operand, one per tap (ky, kx):
// dW_tap[ci, co] = sum_p x_tap[p, ci] * g[p, co] over the K = H*W*N pixels
// p = (h, w, n), x_tap being x shifted by the tap. Stacked over the taps
// this is one GEMM with M = 9 * Ci rows (tap, ci), N = Co and K = H*W*N.
//
// Bound: K is huge (8.4 M pixels at 256x256, batch 128) and the output
// small (at most 9 x 512 x 512): 2 * 9 * Ci * Co flops per 2 * (Ci + Co)
// bytes of x and g, compute-bound at every shape of the model. Over the 8
// shapes of the script (batch 128) the tensor cores bound it at 6.895 ms.
//
// bf16 design (conv_dw_wgmma_kernel): a CTA owns one 64-channel block of ci,
// one of co, all nine taps, and one contiguous range ("split") of K. K
// comes in stages of 128 pixels, 8 samples x 8 columns x 2 rows. A stage
// holds g over those pixels and x over their halo (8 x 10 x 4 pixel rows),
// each one TMA box over the 4D tensor map (C, N, W, H) of its tensor:
// coordinates outside the tensor are zero-filled, which is the SAME padding
// and the ragged tail of N, W and H. One producer warp keeps a ring of
// kDwStages stages full. Three consumer warpgroups, one per dy, run wgmma
// m64n64k16 for their three taps (dx) with float32 accumulators in
// registers: both operands come from shared memory as they lie in memory,
// with the channels contiguous (A = x_tap M-major, B = g N-major, 128-byte
// swizzle). As the samples are the fastest 8 of a row index, a tap's shift
// moves x's rows by a multiple of 8 rows, a 1024-byte swizzle boundary: the
// nine taps read the one staged halo, 2.5 times g's pixels, where a stage a
// tap would copy x nine times. That keeps the bytes copied into shared
// memory at 56 KB per 9.4 MFLOP, 168 flop a byte. The CTAs write per-split
// float32 partials; splits_reduce_kernel sums them in split order, so dW is
// the same run to run, with no float atomics. The split count minimises
// waves x (stages a split + a fill cost) over the card's SMs, within
// kMaxPartialFloats of partials.
//
// float32 operands stay float32: a CUDA-core kernel (4 x 4 outputs a thread,
// fmaf), since the tensor cores would round them to TF32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTile = 64;             // Ci and Co come in multiples of it
constexpr int64_t kMaxPartialFloats = int64_t{16} << 20;  // 64 MiB of partials
constexpr int kReduceThreads = 256;

// float32 kernel: a CTA owns one 64 x 64 (ci, co) tile of one tap
constexpr int kTargetCtas = 1056;     // 8 per SM of the H100's 132
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

// --- bf16: wgmma fed by TMA, the nine taps from one staged halo -------------------------

constexpr int kDwConsumers = 384;               // three warpgroups: dy = -1, 0, 1
constexpr int kDwThreads = kDwConsumers + 32;   // and one producer warp
constexpr int kDwStages = 4;
constexpr int kPn = 8, kPw = 8, kPh = 2;        // a stage's pixels: 8 samples x 8 columns x 2 rows
constexpr int kPx = kPn * kPw * kPh;            // 128 (K a stage)
constexpr int kHaloW = kPw + 2, kHaloH = kPh + 2;
constexpr int kHaloBytes = kPn * kHaloW * kHaloH * 128;  // x's halo, 64 channels: 40 KB
constexpr int kGBytes = kPx * 128;                       // g, 64 channels: 16 KB
constexpr int kDwStage = kHaloBytes + kGBytes;
constexpr int kDwSmem = kDwStages * kDwStage + 2 * kDwStages * 8 + 1024;
constexpr int kFillChunks = 4;  // a CTA's fixed cost in stages (fill, epilogue)

// The bf16 tile plan of one shape: a CTA owns one 64-channel block of ci,
// one of co and one range of stages ("split").
struct DwGeo {
  int ci, co;
  int ci_blocks, co_blocks;
  int cn, cw;          // stages along N and W (and ch along H)
  int64_t chunks;      // stages over the whole K
  int64_t per_split;   // stages a split
  int splits;
};

DwGeo dw_geo(int h, int w, int n, int ci, int co) {
  DwGeo g;
  g.ci = ci;
  g.co = co;
  g.ci_blocks = ci / 64;
  g.co_blocks = co / 64;
  g.cn = (n + kPn - 1) / kPn;
  g.cw = (w + kPw - 1) / kPw;
  const int ch = (h + kPh - 1) / kPh;
  g.chunks = static_cast<int64_t>(g.cn) * g.cw * ch;
  const int64_t tiles = static_cast<int64_t>(g.ci_blocks) * g.co_blocks;
  const int64_t sms = sm_count();
  int64_t cap = kMaxPartialFloats / (int64_t{9} * ci * co);
  if (cap > g.chunks) cap = g.chunks;
  if (cap > 4096) cap = 4096;
  if (cap < 1) cap = 1;
  int64_t best = -1, best_s = 1;
  for (int64_t s = 1; s <= cap; ++s) {
    const int64_t per = (g.chunks + s - 1) / s;
    const int64_t waves = (tiles * s + sms - 1) / sms;
    const int64_t cost = waves * (per + kFillChunks);
    if (best < 0 || cost < best) {
      best = cost;
      best_s = s;
    }
  }
  g.per_split = (g.chunks + best_s - 1) / best_s;
  g.splits = static_cast<int>((g.chunks + g.per_split - 1) / g.per_split);
  return g;
}

__global__ void __launch_bounds__(kDwThreads, 1)
conv_dw_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap gmap, DwGeo g,
                     float* __restrict__ partials) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  unsigned char* stages = smem_raw + (((base + 1023) & ~1023u) - base);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kDwStages * kDwStage);
  uint64_t* empty = full + kDwStages;

  const int tiles = g.ci_blocks * g.co_blocks;
  const int tile = static_cast<int>(blockIdx.x % tiles);
  const int split = static_cast<int>(blockIdx.x / tiles);
  const int ci0 = (tile / g.co_blocks) * 64;
  const int co0 = (tile % g.co_blocks) * 64;
  const int64_t k_begin = static_cast<int64_t>(split) * g.per_split;
  const int64_t k_end = k_begin + g.per_split < g.chunks ? k_begin + g.per_split : g.chunks;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 3);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kDwConsumers) {
    // producer: one thread keeps the ring full, a stage being x's halo and
    // g over the same 8 x 8 x 2 pixels
    if (threadIdx.x == kDwConsumers) {
      int s = 0;
      uint32_t ph = 0;
      for (int64_t k = k_begin; k < k_end; ++k) {
        mbar_wait(&empty[s], ph ^ 1);
        unsigned char* st = stages + s * kDwStage;
        mbar_expect_tx(&full[s], kDwStage);
        const int n0 = static_cast<int>(k % g.cn) * kPn;
        const int64_t kw = k / g.cn;
        const int w0 = static_cast<int>(kw % g.cw) * kPw;
        const int h0 = static_cast<int>(kw / g.cw) * kPh;
        tma_load_4d(st, &xmap, &full[s], ci0, n0, w0 - 1, h0 - 1);
        tma_load_4d(st + kHaloBytes, &gmap, &full[s], co0, n0, w0, h0);
        if (++s == kDwStages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // warpgroup wg: the taps (dy = wg - 1, dx = -1, 0, 1)
  float acc[3][32];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[t][e] = 0.0f;
  int s = 0, prev = -1;
  uint32_t ph = 0;
  for (int64_t k = k_begin; k < k_end; ++k) {
    mbar_wait(&full[s], ph);
    const unsigned char* halo = stages + s * kDwStage;
    const unsigned char* gt = halo + kHaloBytes;
    wg_fence();
#pragma unroll
    for (int j = 0; j < kPx / 16; ++j) {
      // g's rows 16j.. are the 8 samples of columns 2j % 8 and + 1 of row
      // j / 4; x's rows for them at a tap start 8 rows a column further
      const int wl = (2 * j) % kPw, hl = j / (kPw / 2);
      const uint64_t db = wg_desc(gt + j * 2048, 8192, 1024);
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const int row = kPn * ((wl + t) + kHaloW * (hl + wg));
        wgmma_step<64, 1>(acc[t], wg_desc(halo + row * 128, 8192, 1024), db);
      }
    }
    wg_commit();
    wg_wait<1>();  // the previous stage's products are done: release it
    if (prev >= 0 && (threadIdx.x & 127) == 0) mbar_arrive(&empty[prev]);
    prev = s;
    if (++s == kDwStages) {
      s = 0;
      ph ^= 1;
    }
  }
  wg_wait<0>();

  // the accumulators straight to this split's slice: tap (wg, t), row ci0 + r,
  // column co0 + c
  const int lt = threadIdx.x & 127, warp = lt >> 5, lane = lt & 31;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    float* out =
        partials + ((static_cast<int64_t>(split) * 9 + wg * 3 + t) * g.ci + ci0) * g.co + co0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * 16 + (lane >> 2) + half * 8;
        const int c = j * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(out + static_cast<int64_t>(r) * g.co + c) =
            make_float2(acc[t][j * 4 + half * 2], acc[t][j * 4 + half * 2 + 1]);
      }
  }
}

// x [h, w, n, ci] or g [h, w, n, co] as the 4D tensor map (C, N, W, H) with
// a box of 64 channels by the given pixels.
int dw_map(CUtensorMap* map, const void* t, int h, int w, int n, int c, uint32_t bw,
           uint32_t bh) {
  const uint64_t dims[4] = {static_cast<uint64_t>(c), static_cast<uint64_t>(n),
                            static_cast<uint64_t>(w), static_cast<uint64_t>(h)};
  const uint64_t strides[3] = {static_cast<uint64_t>(c) * 2, static_cast<uint64_t>(c) * n * 2,
                               static_cast<uint64_t>(c) * n * w * 2};
  const uint32_t box[4] = {64, kPn, bw, bh};
  return encode_bf16_map(map, t, 4, dims, strides, box);
}

int launch_dw_bf16(const void* x, const void* gy, int h, int w, int n, const DwGeo& g,
                   float* partials, cudaStream_t s) {
  CUtensorMap xmap, gmap;
  int rc = dw_map(&xmap, x, h, w, n, g.ci, kHaloW, kHaloH);
  if (rc == 0) rc = dw_map(&gmap, gy, h, w, n, g.co, kPw, kPh);
  if (rc != 0) return rc;
  const cudaError_t err = cudaFuncSetAttribute(
      conv_dw_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDwSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = static_cast<int64_t>(g.ci_blocks) * g.co_blocks * g.splits;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  conv_dw_wgmma_kernel<<<static_cast<unsigned>(blocks), kDwThreads, kDwSmem, s>>>(
      xmap, gmap, g, partials);
  return static_cast<int>(cudaGetLastError());
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

}  // namespace

extern "C" {

int conv_dw_tile() { return kTile; }

// The number of K splits (slices of the partials scratch, each 9 * ci * co
// floats) the kernel uses for this shape.
int conv_dw_splits(int h, int w, int n, int ci, int co, int is_bf16) {
  if (is_bf16) return dw_geo(h, w, n, ci, co).splits;
  return split_for(static_cast<int64_t>(h) * w * n, ci, co, kFP).splits;
}

// x [h, w, n, ci], g [h, w, n, co], both bf16 (is_bf16) or both float32,
// contiguous and 16-byte aligned; ci, co multiples of conv_dw_tile().
// partials: float32 scratch of conv_dw_splits(...) * 9 * ci * co values.
// dw: float32 [3, 3, ci, co]. Returns the cudaError_t of the launches (or a
// tensor-map code, conv_dw_error_string).
int conv_dw_launch(const void* x, const void* g, int is_bf16, int h, int w, int n, int ci,
                   int co, void* partials, void* dw, void* stream) {
  if (h < 1 || w < 1 || n < 1 || ci < kTile || ci % kTile != 0 || co < kTile ||
      co % kTile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* pp = static_cast<float*>(partials);
  int splits;
  if (is_bf16) {
    const DwGeo geo = dw_geo(h, w, n, ci, co);
    splits = geo.splits;
    const int rc = launch_dw_bf16(x, g, h, w, n, geo, pp, s);
    if (rc != 0) return rc;
  } else {
    const int64_t K = static_cast<int64_t>(h) * w * n;
    const Split sp = split_for(K, ci, co, kFP);
    splits = sp.splits;
    const int64_t blocks = int64_t{9} * (ci / kTile) * (co / kTile) * sp.splits;
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    conv_dw_f32_kernel<<<static_cast<unsigned>(blocks), kThreads32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), h, w, n, ci, co, K,
        sp.pix_per_split, pp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t n_out = int64_t{9} * ci * co;
  splits_reduce_kernel<<<static_cast<unsigned>((n_out + kReduceThreads - 1) / kReduceThreads),
                         kReduceThreads, 0, s>>>(pp, splits, n_out, static_cast<float*>(dw));
  return static_cast<int>(cudaGetLastError());
}

const char* conv_dw_error_string(int code) { return launch_error_string(code); }

}  // extern "C"
